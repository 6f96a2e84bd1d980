"""How far float64 rounding carries through Whisper under a sequence shard.

    PYTHONPATH=src python tools/whisper_witness_depths.py      # on the card

``chip_smoke.py``'s ``sp_whisper`` step-0 witness (Whisper-base at full
width in float64, decoder seq 4096 over "model" of a 2 x 2 group of gloo
ranks, batch 4, 1500 stub frames) at 1, 2, 3 and 6 layers each side: every
position's CE on each rank against one process's (``chip_smoke.token_ce``).
The shard sums cross attention's query landmarks in another order than
one process does, so the two differ by float64 rounding, which the
random-weight decoder then grows layer by layer; the printed figures are
what fixed the witness's depth (``chip_smoke.SP_WHISPER_STEP0_LAYERS``).
Needs the card; imports ``chip_smoke.py`` from the checkout's root.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DEPTHS = (1, 2, 3, 6)


def witness(depth: int):
    return dataclasses.replace(cs.family_config("sp_whisper", step0=True), num_layers=depth,
                               encoder_layers=depth)


def token_ces(depth: int, mesh=None, device=None):
    """Each position's CE of step 0 at ``depth`` layers: the rank's under
    ``mesh`` (the sequence over "model"), else one process's on
    ``device``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer

    kw = dict(rule_overrides={"seq": "model"}) if mesh is not None else dict(device=device)
    with tempfile.TemporaryDirectory(prefix="witness_depths_") as tmp:
        tr = Trainer(witness(depth), TrainConfig(checkpoint_dir=tmp),
                     cs.family_shape("sp_whisper"), mesh, data=cs.family_data("sp_whisper"),
                     **kw)
        out = cs.token_ce(torch, tr)
        del tr
    return out


def rank(mesh) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"coords": dict(mesh.coords), **{d: token_ces(d, mesh=mesh) for d in DEPTHS}}


def main() -> int:
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_local

    if not torch.cuda.is_available():
        raise SystemExit("[witness_depths] no CUDA device: this script runs on the card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"card: {cs.card_line()}")
    build.build()
    single = {d: token_ces(d, device=dev) for d in DEPTHS}
    torch.cuda.empty_cache()
    ranks = spawn_local(rank, cs.SP_MESH, ("data", "model"), backend="gloo", device="cuda",
                        timeout_s=cs.SP_TIMEOUT_S, threads=2)
    for d in DEPTHS:
        err = 0.0
        for r in ranks:
            b, s = r[d].shape
            i, j = r["coords"]["data"], r["coords"]["model"]
            want = single[d][i * b:(i + 1) * b, j * s:(j + 1) * s]
            err = max(err, float(np.abs(r[d] - want).max()))
        cs.log(f"sp_whisper float64 witness at {d} + {d} layers: per-position CE max abs err "
               f"{err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
