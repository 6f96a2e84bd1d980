"""Deterministic token data (``repro/data/pipeline.py``), numpy only.

* ``SyntheticLM``: a seeded synthetic token stream (Zipf-like marginal plus
  a copy task). Batch ``i`` is a pure function of (seed, i), the same
  numpy batch the reference builds, so a restart resumes by step counter.
* ``TextFileLM``: byte-level windows of a local text file.
* ``StubFrontendLM``: ``SyntheticLM`` tokens beside seeded features of a
  stub frontend, at ``configs/registry.py:batch_specs``' shapes: Whisper's
  ``frames``, LLaVA's ``patches`` (the launcher's data for those
  families; the reference's trainer takes such batches through ``data=``).

``to_device`` places a host batch on one device. ``make_global_batch``
(``pipeline.py:66``) is a rank's share under a mesh: every rank builds the
same global batch from the seed and takes its rows (the axes the "batch"
rule spans) and its slice of the sequence (the "seq" rule's), plus the
``targets`` its positions predict; a stub frontend's ``frames`` by the
same rows, whole along their own axis, and ``patches`` by the same rows
and the rank's slice of the joint sequence [patches, text].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # Zipf-ish marginal so CE has learnable structure + a copy task so
        # a few hundred steps show a clearly decreasing loss.
        ranks = rng.zipf(1.3, size=(self.global_batch, self.seq_len))
        tokens = np.clip(ranks, 1, self.vocab_size - 1).astype(np.int32)
        # Inject periodic structure: token[t] == token[t-8] for half the seq.
        tokens[:, 8::2] = tokens[:, : tokens.shape[1] - 8 : 2][:, : tokens[:, 8::2].shape[1]]
        return {"tokens": tokens}


@dataclasses.dataclass
class TextFileLM:
    path: str
    seq_len: int
    global_batch: int
    seed: int = 0
    vocab_size: int = 256  # byte-level

    def __post_init__(self):
        with open(self.path, "rb") as f:
            self._data = np.frombuffer(f.read(), dtype=np.uint8)
        if len(self._data) < self.seq_len + 1:
            raise ValueError("text file smaller than one sequence")

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        starts = rng.integers(
            0, len(self._data) - self.seq_len - 1, size=self.global_batch
        )
        toks = np.stack(
            [self._data[s : s + self.seq_len].astype(np.int32) for s in starts]
        )
        return {"tokens": toks}


@dataclasses.dataclass
class StubFrontendLM:
    """Batch ``i`` (a pure function of (seed, i)): for ``family`` "audio",
    ``frames`` (b, enc_len, d_model) standard normal fp32 beside ``seq_len``
    tokens; for "vlm", ``patches`` (b, p, 1024) standard normal fp32,
    p = min(num_patches, seq_len // 2), beside seq_len - p tokens; else
    tokens only. Tokens are ``SyntheticLM``'s."""
    family: str
    vocab_size: int
    seq_len: int
    global_batch: int
    d_model: int = 0
    num_patches: int = 0
    enc_len: int = 1500
    seed: int = 0

    def batch(self, step: int) -> dict:
        b, s = self.global_batch, self.seq_len
        out = {}
        rng = np.random.default_rng(((self.seed << 20) ^ step) + 1)
        if self.family == "audio":
            out["frames"] = rng.standard_normal((b, self.enc_len, self.d_model),
                                                dtype=np.float32)
        elif self.family == "vlm":
            p = min(self.num_patches, s // 2)
            out["patches"] = rng.standard_normal((b, p, 1024), dtype=np.float32)
            s -= p
        out["tokens"] = SyntheticLM(self.vocab_size, s, b, self.seed).batch(step)["tokens"]
        return out


# a stub frontend's features (``StubFrontendLM``): frames split by rows
# only, patches by rows and the joint sequence's slices
FRONTEND_KEYS = ("frames", "patches")


def to_device(host_batch: dict, device) -> dict:
    """A host numpy batch as tensors on ``device`` (integer arrays as int64,
    the index type torch's gathers take)."""
    out = {}
    for k, arr in host_batch.items():
        t = torch.from_numpy(np.asarray(arr))
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def joint_slices(p: int, n_text: int, shards: int, index: int) -> tuple:
    """(patch rows, text rows) of slice ``index`` of a joint sequence of
    ``p`` patches then ``n_text`` text tokens split into ``shards`` equal
    slices [a, b): the patches [a, min(b, p)) and the text [max(a, p) - p,
    max(b, p) - p), either of which may be empty. Host ints from shapes
    alone."""
    n_loc = (p + n_text) // shards
    a, b = index * n_loc, (index + 1) * n_loc
    return slice(min(a, p), min(b, p)), slice(max(a, p) - p, max(b, p) - p)


def make_global_batch(host_batch: dict, mesh, overrides=None) -> dict:
    """This rank's share of a global host batch under ``mesh`` and the
    logical-axis rules (``distributed/sharding.py``, with ``overrides``):
    ``tokens`` (B, S) -> the rank's rows (B / ranks over the batch axes)
    and its sequence slice (S / ranks over the sequence axes), beside
    ``targets``: the token each of its positions predicts, the next global
    position's (0 at the last one, as the unsplit loss drops it). Both
    must divide evenly. A frontend's features split by the same rows:
    Whisper's ``frames`` (B, S_enc, D) stay whole along their own axis
    (the reference's ("batch", None, None)), only the decoder's tokens
    split over the sequence. LLaVA's ``patches`` (B, P, 1024) come ahead
    of the text in one joint sequence of P + S positions, and that is what
    splits (``joint_slices``; P + S must divide): the rank gets its rows'
    patches of its slice (perhaps none), its text tokens (perhaps none)
    and the joint ``targets`` of its slice, 0 at every patch position and
    at the last one, the next token at a text position
    (``repro/models/model.py:463-465`` with ``next_token_loss``'s mask)."""
    from repro_torch.distributed.sharding import batch_axes, seq_axes

    extra = sorted(set(host_batch) - {"tokens", *FRONTEND_KEYS})
    if extra:
        raise NotImplementedError(f"make_global_batch splits tokens, frames and patches, "
                                  f"not {extra}")
    tokens = np.asarray(host_batch["tokens"])
    b, s = tokens.shape
    rows, seq = batch_axes(mesh, overrides), seq_axes(mesh, overrides)
    nb, ns = mesh.axis_size(rows), mesh.axis_size(seq)
    patches = host_batch.get("patches")
    p = 0 if patches is None else np.asarray(patches).shape[1]
    n = p + s
    if b % nb or n % ns:
        what = f"{p} patches + {s} tokens" if p else f"{s} tokens"
        raise ValueError(f"a batch of {b} x {what} does not split into {nb} x {ns} "
                         f"equal shares")
    zeros = np.zeros((b, 1), tokens.dtype)
    targets = np.concatenate([np.zeros((b, p), tokens.dtype), tokens[:, 1:], zeros], axis=1)
    r0, j = mesh.index(rows) * (b // nb), mesh.index(seq)
    take = slice(r0, r0 + b // nb)
    patch_rows, text = joint_slices(p, s, ns, j)
    out = {"tokens": tokens[take, text],
           "targets": targets[take, j * (n // ns):(j + 1) * (n // ns)]}
    if "frames" in host_batch:
        out["frames"] = np.asarray(host_batch["frames"])[take]
    if patches is not None:
        out["patches"] = np.asarray(patches)[take, patch_rows]
    return out
