"""Logical-axis rules, sequence-parallel part (``repro/distributed/
sharding.py``).

The reference maps logical tensor axes to mesh axes (MaxText-style rules)
and lets GSPMD place parameters and activations. Here every rank runs its
own slice eagerly: its rows of the batch (the axes the ``"batch"`` rule
spans) and its slice of the sequence (the ``"seq"`` rule's axes), with
parameters replicated on every rank. Attention's cross-shard work goes
through the context-parallel attention (``kernels/sharded.py``), the loss
divides by the global token count, and the trainer all-reduces gradients
over every axis the batch or the sequence spans.

Ported: ``DEFAULT_RULES``, ``seq_axis_sharded``,
``apply_seq_sharding_config``, ``sharding_rules`` and
``active_seq_sharding``. The parameter rules for tensor parallelism, FSDP
and expert parallelism (``spec_for``, ``logical_constraint``,
``shardings_for``, ``param_shardings``) wait: the default rules' parameter
entries describe the reference's layout and are not applied here, and an
override that asks to shard a parameter axis over an axis of size > 1 is
refused by the trainer (``param_rule_conflicts``).

The active rules are process-wide, not thread-local as the reference's:
autograd runs a checkpointed layer's recomputation on its own thread, and
that forward must see the same sequence shard as the first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

# logical axis -> mesh axes (tuple => sharded over multiple mesh axes).
DEFAULT_RULES: dict[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "data",          # sequence-parallel sites (long-context decode)
    "embed_act": None,
    "heads_act": "model",
    "ff_act": "model",
    "vocab_act": "model",
    "experts_act": "data",
    # parameters
    "vocab": "model",
    "embed": "data",           # FSDP shard of weight matrices
    "embed_unsharded": None,   # MoE expert weights keep d unsharded (E->data)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "moe_ff": "model",
    "experts": ("pod", "data"),
    "kv_lora": None,
    "layers": None,
    "cache_seq": None,         # KV-cache sequence dim ("data" under SP)
    "cache_batch": ("pod", "data"),
}

# The parameter entries of DEFAULT_RULES (TP, FSDP, EP): not applied here.
PARAM_RULES = ("vocab", "embed", "embed_unsharded", "heads", "kv_heads", "head_dim",
               "ff", "moe_ff", "experts", "kv_lora", "layers")


def _axes_of(v) -> tuple:
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def _rule_axes(mesh, rules: dict, name: str) -> tuple:
    """The mesh axes rule ``name`` maps onto, in mesh order, dropping axes
    the mesh lacks (a single-pod mesh has no "pod")."""
    want = _axes_of(rules.get(name))
    return tuple(a for a in mesh.axis_names if a in want)


def _merged(overrides: Optional[dict]) -> dict:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def seq_axis_sharded(mesh, overrides: Optional[dict] = None) -> bool:
    """True when the activation sequence axis ("seq" rule, after
    overrides) maps onto mesh axes of total size > 1 (``sharding.py:49``)."""
    return mesh.axis_size(_rule_axes(mesh, _merged(overrides), "seq")) > 1


def apply_seq_sharding_config(cfg, mesh, overrides: Optional[dict] = None, log=None):
    """Context-parallel implications for a ModelConfig (``sharding.py:69``):

    * ``landmark_via_matmul=True`` (the one-hot segment-sum GEMM the
      sharded attention's landmark sums use);
    * fused attention stays fused: ``attention_backend`` and ``remat`` are
      left as they are, since the sharded B-side is a custom op that
      ``remat="ss_stats"`` keeps (``models/model.py:_ss_stats_policy``).
      The reference widens ``"ss_stats"`` to ``"full"`` under backend
      "auto" on its CPU, where its heuristic picks the jnp route; the
      port's CPU heuristic picks the sharded attention's plain versions,
      which save the op, so ss_stats stays (a named difference, ROADMAP);
    * ``seq_shard_fused=False`` restores the reference's legacy downgrade
      to ``attention_backend="jnp"`` (with ``"ss_stats"`` widened to
      ``"full"``), which the port's trainer then refuses: a rank holds only
      its own rows, and no GSPMD gathers the rest for the plain route.

    Returns ``cfg`` unchanged when the sequence axis is not sharded."""
    if not seq_axis_sharded(mesh, overrides):
        return cfg
    if not cfg.landmark_via_matmul:
        if log:
            log.info("sequence axis is sharded: enabling landmark_via_matmul")
        cfg = dataclasses.replace(cfg, landmark_via_matmul=True)
    if (cfg.attention_impl == "spectral_shift_fused"
            and cfg.attention_backend in ("auto", "fused")):
        from repro_torch.configs.base import resolve_remat

        if getattr(cfg, "seq_shard_fused", True):
            if log:
                log.info("sequence axis is sharded: fused attention routes through "
                         "the context-parallel attention")
            return cfg
        if log:
            log.info("sequence axis is sharded and seq_shard_fused=False: forcing "
                     "attention_backend=jnp")
        cfg = dataclasses.replace(cfg, attention_backend="jnp")
        if resolve_remat(cfg.remat) == "ss_stats":
            if log:
                log.warning("remat='ss_stats' has no saved op on the jnp route; "
                            "using remat='full'")
            cfg = dataclasses.replace(cfg, remat="full")
    return cfg


def param_rule_conflicts(mesh, overrides: Optional[dict] = None) -> list[str]:
    """The parameter rules among ``overrides`` that would shard a parameter
    axis over mesh axes of size > 1 (tensor parallelism, FSDP, expert
    parallelism: not ported; parameters stay replicated)."""
    bad = []
    for name in PARAM_RULES:
        if overrides and name in overrides:
            axes = _rule_axes(mesh, {name: overrides[name]}, name)
            if mesh.axis_size(axes) > 1:
                bad.append(f"{name} -> {overrides[name]}")
    return bad


@dataclasses.dataclass(frozen=True)
class _Active:
    mesh: object
    rules: dict


_lock = threading.Lock()
_active: Optional[_Active] = None


@contextlib.contextmanager
def sharding_rules(mesh, overrides: Optional[dict] = None):
    """Activate the logical-axis rules for model code within this context
    (``sharding.py:156``), process-wide; contexts do not nest."""
    global _active
    rules = {k: _rule_axes(mesh, _merged(overrides), k) for k in _merged(overrides)}
    with _lock:
        if _active is not None:
            raise RuntimeError("sharding_rules: a context is already active")
        _active = _Active(mesh, rules)
    try:
        yield
    finally:
        with _lock:
            _active = None


def active_seq_sharding():
    """(mesh, seq_axes, lead_axes) for the context-parallel attention
    (``sharding.py:180``). ``seq_axes`` are the mesh axes the "seq" rule
    maps onto, empty without an active context or when they span <= 1
    ranks; ``lead_axes`` the "batch" + "heads_act" axes minus any the
    sequence claims (a mesh axis may appear once). Outside a context:
    (None, (), ())."""
    act = _active
    if act is None:
        return None, (), ()
    mesh, rules = act.mesh, act.rules
    seq_axes = rules.get("seq", ())
    if mesh.axis_size(seq_axes) <= 1:
        return mesh, (), ()
    used = set(seq_axes)
    lead = []
    for rule in ("batch", "heads_act"):
        for a in rules.get(rule, ()):
            if a not in used:
                used.add(a)
                lead.append(a)
    return mesh, seq_axes, tuple(lead)


def batch_axes(mesh, overrides: Optional[dict] = None) -> tuple:
    """The mesh axes a batch's rows split over: the "batch" rule's, minus
    the sequence's."""
    rules = _merged(overrides)
    seq = _rule_axes(mesh, rules, "seq")
    return tuple(a for a in _rule_axes(mesh, rules, "batch") if a not in seq)


def seq_axes(mesh, overrides: Optional[dict] = None) -> tuple:
    """The mesh axes the sequence splits over (the "seq" rule's)."""
    return _rule_axes(mesh, _merged(overrides), "seq")


def active_reduce_axes():
    """(mesh, axes) of the active context: the axes a batch's rows or its
    sequence split over, over which the loss's token count and the
    gradients are summed. (None, ()) outside a context."""
    act = _active
    if act is None:
        return None, ()
    mesh, rules = act.mesh, act.rules
    seq = rules.get("seq", ())
    spanned = set(seq) | {a for a in rules.get("batch", ()) if a not in seq}
    return mesh, tuple(a for a in mesh.axis_names if a in spanned)


def seq_offset(n_local: int) -> int:
    """The global position of this rank's first token when each rank holds
    ``n_local`` positions of the sequence (0 without a sequence shard)."""
    mesh, axes, _ = active_seq_sharding()
    return mesh.index(axes) * n_local if axes else 0
