"""Does a row's result depend on the batch it rides in? Op by op, in fp32.

    PYTHONPATH=src python tools/batch_spread.py            # on the card
    PYTHONPATH=src python tools/batch_spread.py --device cpu --seq 128 --seq-xlstm 64

Runs one Hymba-1.5B layer (under ``chunked`` and under
``spectral_shift_fused`` attention), one xLSTM-350M mLSTM block and one
sLSTM block, at full width from seeded random weights, in fp32 with TF32
off, twice: on its row 0 alone, then on a batch of 2 rows. Every computing
aten op of both runs is taken in order (a ``TorchDispatchMode``; ops that
only move or alias data are left out), each under the innermost named
function it runs in (the norms, the projections, the attention route, the
mamba scan's ``_linear_scan`` and causal conv, ``mlstm_chunked``,
``slstm_scan``, the MLP; "(block)" outside them). For each op of the
batch-2 run, row 0's part of its output is held to:

* own: the same op run again on row 0's part of its own inputs. This is
  the op's batch dependence alone. Past ``--tol`` (1e-6 of the output's
  max abs) the op is run once more in float64 on the same inputs: the
  batch-2 result's distance from it against the row-alone rerun's. Both
  are fp32 rounding of one exact value when the batch-2 result is no
  further off than ``ROUNDING`` times the rerun (a reordered sum of K
  fp32 terms may land anywhere within K ulps); further off, the op is a
  fault.

Row 0's part of an op's tensor is its row-alone shape cut from the first
dimension that is twice as long, as its leading half or interleaved (a
merged (batch, seq) dimension holds the rows either way), whichever cut
the rerun agrees with best. Each named function's outputs (batch first)
are held too, propagated: row 0 of the batch-2 call against the row-alone
call, which adds what the earlier ops passed on (outputs up to ``KEEP``
elements: the host holds them). Prints the card's name and power limit,
then per block the output's propagated difference, the first op whose own
figure passes the tolerance, and per function the worst own figure of its
ops and the worst propagated figure of its outputs; writes every figure
to ``--out`` (``results/batch_spread.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs.registry import get_config
from repro_torch.models import attention, layers, model, ssm
from repro_torch.models.params import init_params

# the functions whose ops are labelled with their name (innermost wins)
NAMED = {
    layers: ("rms_norm", "apply_rotary", "mlp_forward"),
    attention: ("project_heads", "output_projection", "_core_attention", "gqa_forward"),
    ssm: ("_causal_conv", "_linear_scan", "mamba_forward", "mlstm_chunked", "slstm_scan"),
}
# ops that move or alias data and compute nothing: which of them runs can
# depend on the batch (a view of one row is contiguous where two rows'
# need a copy), so they are left out of the sequence
MOVES = {"view", "_unsafe_view", "clone", "expand", "as_strided", "t", "transpose",
         "permute", "unsqueeze", "squeeze", "slice", "select", "alias", "detach",
         "reshape", "contiguous", "copy_", "copy", "_to_copy", "split", "split_with_sizes",
         "unbind", "narrow", "lift_fresh", "empty", "empty_like", "new_empty", "zeros",
         "zeros_like", "new_zeros", "full", "fill_", "zero_", "index_select", "cat",
         "stack", "repeat", "flip", "_reshape_alias"}
# the largest function output kept on the host for the propagated figure
# (elements): the mamba scan's (S, di, N) passes would not fit the host
KEEP = 1 << 24
# how much further from the float64 result the batch-2 output may be than
# the row-alone rerun and still be the same rounding
ROUNDING = 4.0
_stack: list[str] = []
# while a run records: each named function call's (name, output shape,
# host copy of its output or None past KEEP)
_calls: list | None = None


def _labelled(name, fn):
    def run(*args, **kwargs):
        _stack.append(name)
        try:
            out = fn(*args, **kwargs)
        finally:
            _stack.pop()
        if _calls is not None:
            first = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(first, torch.Tensor) and first.is_floating_point():
                _calls.append((name, tuple(first.shape), first.detach().float().cpu()
                               if first.numel() <= KEEP else None))
        return out
    return run


def install_labels() -> None:
    """Wrap every NAMED function wherever the port binds it (its own module
    and every module that imported it by name)."""
    originals = {getattr(mod, n): n for mod, names in NAMED.items() for n in names}
    wrapped = {fn: _labelled(n, fn) for fn, n in originals.items()}
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("repro_torch"):
            continue
        for attr, value in list(vars(mod).items()):
            if callable(value) and value in wrapped:
                setattr(mod, attr, wrapped[value])


def _computing(func, out):
    """The op's first output when it computes a floating tensor, else None."""
    first = out[0] if isinstance(out, (tuple, list)) and out else out
    if (isinstance(first, torch.Tensor) and first.is_floating_point()
            and func.overloadpacket.__name__ not in MOVES):
        return first
    return None


def _label() -> str:
    return _stack[-1] if _stack else "(block)"


class Alone(TorchDispatchMode):
    """The row-alone run: every computing op with its label, its tensor
    arguments' shapes and its first output's shape."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        first = _computing(func, out)
        if first is not None:
            shapes = [tuple(t.shape) for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
            self.ops.append((_label(), func.overloadpacket.__name__, shapes,
                             tuple(first.shape)))
        return out


def cut(t: torch.Tensor, shape: tuple, how: str):
    """Row 0's part of the batch-2 tensor ``t`` at the row-alone ``shape``:
    the first dimension that differs is twice as long and holds the rows as
    its leading half ("lead") or interleaved ("inter"); None otherwise."""
    if tuple(t.shape) == tuple(shape):
        return t
    if t.dim() != len(shape):
        return None
    for d, (a, b) in enumerate(zip(t.shape, shape)):
        if a != b:
            if a != 2 * b:
                return None
            return (t.narrow(d, 0, b) if how == "lead"
                    else t.unflatten(d, (b, 2)).select(d + 1, 0))
    return None


def _rel(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max abs difference, the same over b's max abs)."""
    b = b.float()
    if not b.numel():
        return 0.0, 0.0
    diff = float((a.float().to(b.device) - b).abs().max())
    scale = float(b.abs().max())
    return diff, diff / scale if scale else 0.0


class Pair(TorchDispatchMode):
    """The batch-2 run beside the row-alone one (``Alone``'s ops): each
    computing op's row-0 output against the same op rerun on row 0's part
    of its inputs (own). An op that no cut of its inputs reruns is counted
    in ``skipped``."""

    def __init__(self, alone: list, tol: float):
        super().__init__()
        self.alone, self.tol, self.ops, self.skipped, self.n = alone, tol, [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        first = _computing(func, out)
        if first is None:
            return out
        i, self.n = self.n, self.n + 1
        name = func.overloadpacket.__name__
        lab1, op1, shapes, shape1 = self.alone[i]
        if (_label(), name) != (lab1, op1):
            raise RuntimeError(f"op {i}: {_label()}/{name} in the batch of 2, {lab1}/{op1} "
                               f"alone")
        best = None
        for how in ("lead", "inter"):
            it = iter(shapes)
            try:
                part = tree_map(lambda t: cut(t, next(it), how)
                                if isinstance(t, torch.Tensor) else t, (args, kwargs))
                if any(t is None for t in tree_leaves(part)):
                    continue
                again = _computing(func, func(*part[0], **part[1]))
            except (RuntimeError, ValueError, IndexError, StopIteration):
                continue
            mine = cut(first, shape1, how)
            if again is None or mine is None or again.shape != mine.shape:
                continue
            own = _rel(mine, again)
            if best is None or own[1] < best[1]:
                best = (own, own[1], mine, part, again)
        if best is None:
            self.skipped += 1
            return out
        rec = dict(i=i, label=lab1, op=name, shape=list(shape1), own=best[1],
                   own_abs=best[0][0])
        if best[1] > self.tol:
            mine, part = best[2], best[3]
            wide = tree_map(lambda t: t.double() if isinstance(t, torch.Tensor)
                            and t.is_floating_point() else t, part)
            exact = _computing(func, func(*wide[0], **wide[1]))
            again = best[4]
            rec.update(err_batch=_rel(mine.double(), exact)[1],
                       err_alone=_rel(again.double(), exact)[1])
            rec["rounding"] = rec["err_batch"] <= ROUNDING * max(rec["err_alone"], 1e-12)
        self.ops.append(rec)
        return out


def record(fn, x, mode):
    """fn(x) under ``mode`` with the named functions' outputs recorded:
    (y, calls)."""
    global _calls
    _calls = []
    try:
        with torch.no_grad(), mode:
            y = fn(x)
        return y, _calls
    finally:
        _calls = None


def blocks(seq: int, seq_xlstm: int, dev):
    """(name, fn(x) -> y, x (2, S, D)) of every block held."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for impl in ("chunked", "spectral_shift_fused"):
        cfg = dataclasses.replace(get_config("hymba-1.5b"), num_layers=1, attention_impl=impl,
                                  compute_dtype="float32")
        p = init_params(model.hymba_layer_specs(cfg), gen, device=dev)
        pos = torch.arange(seq, device=dev)

        def hymba(x, p=p, cfg=cfg, impl=impl):
            return model.hymba_layer_forward(p, cfg, x, pos.expand(x.shape[0], seq), impl,
                                             "causal")[0]

        out.append((f"hymba_{impl}", hymba,
                    torch.randn((2, seq, cfg.d_model), generator=gen, device=dev)))
    cfg = dataclasses.replace(get_config("xlstm-350m"), num_layers=1, compute_dtype="float32")
    for kind, specs, fwd in (("mlstm", model.mlstm_block_specs, model.mlstm_block_forward),
                             ("slstm", model.slstm_block_specs, model.slstm_block_forward)):
        p = init_params(specs(cfg), gen, device=dev)
        out.append((f"xlstm_{kind}", lambda x, p=p, fwd=fwd: fwd(p, cfg, x),
                    torch.randn((2, seq_xlstm, cfg.d_model), generator=gen, device=dev)))
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq", type=int, default=4096, help="Hymba's sequence")
    ap.add_argument("--seq-xlstm", type=int, default=2048, help="the xLSTM blocks' sequence")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--out", default="results/batch_spread.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[batch_spread] no CUDA device: pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    install_labels()
    card = card_line()
    print(f"[batch_spread] card: {card}; torch {torch.__version__}", flush=True)
    report = {}
    for name, fn, x in blocks(args.seq, args.seq_xlstm, dev):
        t0 = time.perf_counter()
        alone = Alone()
        y1, calls1 = record(fn, x[:1].clone(), alone)
        pair = Pair(alone.ops, args.tol)
        y2, calls2 = record(fn, x, pair)
        block = _rel(y2[:1], y1)[1]
        ops = pair.ops
        worst: dict = {}
        for o in ops:
            w = worst.setdefault(o["label"], {"own": o, "prop": None})
            if o["own"] > w["own"]["own"]:
                w["own"] = o
        props = []
        for j, ((n2, _, a), (n1, _, b)) in enumerate(zip(calls2, calls1)):
            if n2 != n1:
                raise RuntimeError(f"call {j}: {n2} in the batch of 2, {n1} alone")
            if a is not None and b is not None and a.shape[0] == 2 * b.shape[0]:
                rel = _rel(a[:b.shape[0]], b)[1]
                props.append(dict(call=j, label=n1, prop=rel))
                w = worst.setdefault(n1, {"own": None, "prop": None})
                if w["prop"] is None or rel > w["prop"]["prop"]:
                    w["prop"] = props[-1]
        past = [o for o in ops if o["own"] > args.tol]
        faults = [o for o in past if not o["rounding"]]
        worst_past = max(past, key=lambda o: o["err_batch"] / max(o["err_alone"], 1e-12),
                         default=None)
        print(f"[batch_spread] {name} ({time.perf_counter() - t0:.1f}s, {len(ops)} ops held, "
              f"{pair.skipped} not cut): block output propagated rel {block:.3e}; {len(past)} "
              f"ops' own rel past {args.tol:g}, of which {len(faults)} beyond rounding"
              + (f" (first: #{faults[0]['i']} {faults[0]['label']}/{faults[0]['op']})"
                 if faults else "")
              + (f"; worst against float64: #{worst_past['i']} {worst_past['label']}/"
                 f"{worst_past['op']} {worst_past['shape']} batch-2 {worst_past['err_batch']:.3e},"
                 f" row alone {worst_past['err_alone']:.3e}" if worst_past else ""), flush=True)
        for lab, w in sorted(worst.items(),
                             key=lambda kv: -(kv[1]["own"] or {"own": 0.0})["own"]):
            o, p = w["own"], w["prop"]
            own = (f"{o['own']:.3e} (abs {o['own_abs']:.3e}, #{o['i']} {o['op']} "
                   f"{o['shape']})" if o is not None else "no op of its own")
            prop = (f"{p['prop']:.3e} (call {p['call']})" if p is not None
                    else f"none held (none, or past {KEEP} elements)")
            print(f"[batch_spread]   {lab}: own worst {own}; its outputs propagated worst "
                  f"{prop}", flush=True)
        report[name] = dict(block_prop=block, skipped=pair.skipped, ops=ops, calls=props)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, tol=args.tol, blocks=report), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
