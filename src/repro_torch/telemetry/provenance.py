"""Provenance stamps for telemetry artifacts (the port's counterpart of
``repro/telemetry/provenance.py``).

The telemetry JSONL meta line and the Perfetto trace metadata carry one
small stamp,

    {"git_sha": ..., "torch": ..., "cuda": ..., "device": ...?,
     "config_hash": ...?}

so a trace is tied to the tree, the torch build and the card that made
it. ``config_hash`` is a stable content hash over the dataclass configs
that shaped the run; the port's configs have the reference's fields, so
the same values hash to the reference's digest.

``git_sha`` degrades to ``$GITHUB_SHA`` and then ``"unknown"`` outside a
checkout: provenance is never the reason an artifact fails to write.
``provenance`` names the device only when the caller passes a CUDA
device, so a CPU run never initialises CUDA.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import subprocess


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """HEAD commit of the repo containing this file (cached per process).
    A hung git (``TimeoutExpired``) degrades like every other failure."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=here, capture_output=True,
            text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired, subprocess.SubprocessError):
        pass
    return os.environ.get("GITHUB_SHA", "unknown")


def config_hash(*cfgs) -> str:
    """Stable 12-hex content hash over any number of dataclass configs
    (non-dataclasses hash their repr). Field order never matters."""
    blobs = []
    for cfg in cfgs:
        if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
            payload = dataclasses.asdict(cfg)
        else:
            payload = repr(cfg)
        blobs.append(json.dumps(payload, sort_keys=True, default=str))
    digest = hashlib.sha256("\x00".join(blobs).encode())
    return digest.hexdigest()[:12]


def provenance(*cfgs, device=None) -> dict:
    """The standard stamp: git SHA, torch and its CUDA version, the card's
    name when ``device`` is a CUDA device, and the joint ``config_hash``
    of ``cfgs`` when any are given."""
    import torch

    out = {"git_sha": git_sha(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if device is not None and torch.device(device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(torch.device(device))
    if cfgs:
        out["config_hash"] = config_hash(*cfgs)
    return out
