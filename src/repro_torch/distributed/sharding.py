"""Logical-axis rules (``repro/distributed/sharding.py``): the batch,
the sequence and the parameters over the ranks of a mesh.

The reference maps logical tensor axes to mesh axes (MaxText-style rules)
and lets GSPMD place parameters and activations. Here every rank runs its
own slice eagerly: its rows of the batch (the axes the ``"batch"`` rule
spans), its slice of the sequence (the ``"seq"`` rule's axes) and its
slice of every parameter (``shardings_for``: the reference's
``divisible_spec`` per leaf, a *placement*: for each dimension the mesh
axes it is split over). Attention's cross-shard work goes through the
context-parallel attention (``kernels/sharded.py``), the loss divides by
the global token count, and the trainer sums gradients over every axis the
batch or the sequence spans.

Ported: ``DEFAULT_RULES``, ``seq_axis_sharded``,
``apply_seq_sharding_config``, ``sharding_rules``, ``active_seq_sharding``,
``spec_for``, ``divisible_spec``, ``shardings_for``, ``named_sharding``
(the one definition of a leaf's placement) and ``logical_constraint``. The parameter rules apply
to the dense family (GQA, SwiGLU or gelu MLP, no MoE, no MLA):
``param_layout`` places every parameter and both AdamW moments as the
reference's default rules do (FSDP: ``"embed"`` over "data"; tensor
parallelism: ``"heads"``, ``"kv_heads"``, ``"ff"``, ``"vocab"`` over
"model"), and the model runs a layer's tensor-parallel dims on the rank's
slice with the region ops of ``distributed/mesh.py`` and gathers its FSDP
dims just before use. Two named differences (ROADMAP): a mesh axis that
the ``"seq"`` rule claims is left out of the default parameter rules, as
is, from the tensor-parallel ones, an axis the ``"batch"`` rule spans,
and from the FSDP one an axis it does not (an explicit override that puts
a parameter axis there is refused, ``param_rule_conflicts``; GSPMD would
take it), and the other families
keep replicated parameters (an explicit parameter override for them is
refused). Under ``moe_impl="ep"`` the MoE family's expert leaves
(``w_gate``, ``w_up``, ``w_down``) split their experts over the expert
axes (``expert_axes``: every mesh axis but "model", the reference's
``moe_forward_ep`` shard_map spec), which ``models/moe.py:moe_forward_ep``
runs on; ``moe_ff`` stays whole over "model" (a named difference: the
reference stores it split and gathers it at the shard_map's entry) and
the other MoE / MLA leaves stay replicated.

The active rules are process-wide, not thread-local as the reference's:
autograd runs a checkpointed layer's recomputation on its own thread, and
that forward must see the same sequence shard and layout as the first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import NamedTuple, Optional

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

# The parameter entries of DEFAULT_RULES (TP, FSDP, EP).
PARAM_RULES = ("vocab", "embed", "embed_unsharded", "heads", "kv_heads", "head_dim",
               "ff", "moe_ff", "experts", "kv_lora", "layers")
# The parameter rules a dense layer runs on the rank's slice (tensor
# parallelism) and the one it gathers just before use (FSDP).
TP_RULES = ("heads", "kv_heads", "ff", "vocab")
FSDP_RULES = ("embed",)
# The parameter rule expert parallelism places (the rank's own experts).
EP_RULES = ("experts",)

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


def shards_parameters(cfg) -> bool:
    """Whether the parameter rules apply to ``cfg``: the dense family with
    GQA and a plain MLP. The other families, MoE and MLA keep replicated
    parameters, bar the expert leaves under ``expert_parallel``."""
    return cfg.family == "dense" and not cfg.moe and not cfg.mla


def expert_parallel(cfg) -> bool:
    """Whether ``cfg`` runs the expert-parallel MoE (``moe_impl="ep"``)."""
    return bool(cfg.moe) and cfg.moe_impl == "ep"


def expert_axes(mesh) -> tuple:
    """The mesh axes experts split over under expert parallelism: every
    axis but "model" (``repro/models/moe.py:134``)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def param_rules(mesh, overrides: Optional[dict] = None, cfg=None) -> dict:
    """The merged rules as mesh-axis tuples, with the parameter entries the
    port applies. A default parameter rule (one no override names) loses
    the axes the ``"seq"`` rule claims (the sequence keeps its axis); a
    default tensor-parallel rule also loses every axis the ``"batch"``
    rule spans (ranks that hold other rows cannot sum one row's partials),
    and the default FSDP rule keeps only axes the batch spans (its
    gradient is a sum of the rows' partials there). For a ``cfg`` whose
    parameters stay replicated (``shards_parameters``) every parameter
    rule maps to (), bar ``"experts"`` under ``expert_parallel``, which
    maps to the expert axes."""
    rules = _merged(overrides)
    claimed = set(_rule_axes(mesh, rules, "seq"))
    rows = set(batch_axes(mesh, overrides))
    out = {}
    for name in rules:
        axes = _rule_axes(mesh, rules, name)
        if name in PARAM_RULES:
            if cfg is not None and not shards_parameters(cfg):
                # expert parallelism: the experts over the expert axes
                axes = (tuple(a for a in expert_axes(mesh) if a not in claimed)
                        if name in EP_RULES and expert_parallel(cfg) else ())
            elif not (overrides and name in overrides):
                keep = ((lambda a: a not in rows) if name in TP_RULES else
                        (lambda a: a in rows) if name in FSDP_RULES else
                        (lambda a: True))
                axes = tuple(a for a in axes if a not in claimed and keep(a))
        out[name] = axes
    return out


def param_rule_conflicts(mesh, overrides: Optional[dict] = None, cfg=None) -> list[str]:
    """The explicit parameter overrides the port refuses: one that puts a
    parameter axis on a mesh axis the ``"seq"`` rule claims; for a ``cfg``
    whose parameters stay replicated, one that shards at all; for the
    dense family, one whose layout the model cannot run: a tensor-parallel
    rule over an axis the batch or the sequence spans, ``"embed"`` over an
    axis they do not span (its gradient would not be a sum of partials
    there), or ``"layers"`` / ``"head_dim"`` split."""
    if not overrides:
        return []
    rules = _merged(overrides)
    claimed = set(_rule_axes(mesh, rules, "seq"))
    spanned = claimed | set(_rule_axes(mesh, rules, "batch"))
    bad = []
    for name in PARAM_RULES:
        if name not in overrides:
            continue
        axes = tuple(a for a in _rule_axes(mesh, rules, name) if mesh.shape[a] > 1)
        if not axes:
            continue
        why = None
        if set(axes) & claimed:
            why = "on the sequence's axis"
        elif cfg is not None and not shards_parameters(cfg):
            why = f"{cfg.name}: its parameters stay replicated"
        elif name in TP_RULES and set(axes) & spanned:
            why = "tensor parallelism over an axis the batch spans"
        elif name in FSDP_RULES and not set(axes) <= spanned:
            why = "FSDP over an axis the batch does not span"
        elif name in ("layers", "head_dim"):
            why = "a dimension the model does not split"
        if why:
            bad.append(f"{name} -> {overrides[name]} ({why})")
    return bad


# A placement: for each dimension of a tensor, the mesh axes it is split
# over (a tuple, () = whole), the port's counterpart of a PartitionSpec.
def spec_for(axes: tuple, rules: Optional[dict] = None) -> tuple:
    """Logical axes -> a placement under ``rules`` (mesh-axis tuples, as
    ``param_rules`` gives them; default the active context's): a mesh axis
    appears at most once per tensor (``sharding.py:215``)."""
    if rules is None:
        rules = _active.rules if _active is not None else {}
    used: set = set()
    parts = []
    for ax in axes:
        flat = tuple(a for a in rules.get(ax, ()) if a not in used) if ax else ()
        used.update(flat)
        parts.append(flat)
    return tuple(parts)


def named_sharding(mesh, axes: tuple, rules: Optional[dict] = None,
                   shape: Optional[tuple] = None) -> tuple:
    """Where ``mesh`` splits a tensor of logical ``axes``: ``spec_for``
    (``divisible_spec`` when its ``shape`` is given) with the axes of size
    1 dropped (``sharding.py:243``)."""
    spec = spec_for(axes, rules) if shape is None else divisible_spec(mesh, axes, shape, rules)
    return tuple(tuple(a for a in p if mesh.shape[a] > 1) for p in spec)


def divisible_spec(mesh, axes: tuple, shape: tuple, rules: Optional[dict] = None) -> tuple:
    """The placement under the rules, dropping any dimension whose size the
    product of its mesh axes does not divide (``sharding.py:256``; 1 kv
    head stays whole over a model axis of 2)."""
    return tuple(() if p and dim % mesh.axis_size(p) else p
                 for dim, p in zip(shape, spec_for(axes, rules)))


def shardings_for(mesh, specs, rules: Optional[dict] = None):
    """Placements of a ``ParamSpec`` tree, divisibility-validated
    (``sharding.py:268``). The reference's ``param_shardings`` (the rules
    alone, divisibility unchecked) has no counterpart: a rank's slice must
    divide."""
    from repro_torch.models.params import map_specs

    return map_specs(lambda _p, s: divisible_spec(mesh, s.axes, s.shape, rules), specs)


class TensorParallel(NamedTuple):
    """The mesh axes a dense layer's tensor-parallel dims split over (()
    = whole): query heads, kv heads, the MLP's hidden width, the vocab."""
    heads: tuple
    kv_heads: tuple
    ff: tuple
    vocab: tuple


@dataclasses.dataclass(frozen=True)
class Placement:
    """One leaf's place on a mesh: ``dims``, for each dimension the mesh
    axes (of size > 1) it is split over; ``gather``, the (dim, axes) pairs
    the model all-gathers just before use (its FSDP dims; the
    tensor-parallel ones stay the rank's slice). A class, not a tuple, so
    that a tree of them has one leaf per parameter."""
    dims: tuple
    gather: tuple = ()

    @property
    def split(self) -> tuple:
        """Every mesh axis the leaf is split over."""
        return tuple(dict.fromkeys(a for p in self.dims for a in p))

    @property
    def gathered(self) -> tuple:
        """The mesh axes the model gathers the leaf over."""
        return tuple(dict.fromkeys(a for _, p in self.gather for a in p))


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Where every parameter leaf lives on ``mesh``: ``placements``, a tree
    of ``Placement`` like the parameters', and the layer's tensor-parallel
    axes ``tp``."""
    mesh: object
    placements: dict
    tp: TensorParallel


def param_layout(mesh, cfg, specs, overrides: Optional[dict] = None) -> Optional[ParamLayout]:
    """The layout the rules give ``specs`` of ``cfg`` on ``mesh``, or None
    when every leaf stays whole (parameters replicated, as before any
    parameter rule applied). A leaf's FSDP dims are the ones gathered
    before use; tensor-parallel and expert dims stay the rank's. Raises
    ``NotImplementedError`` for a layout the dense layer cannot run (kv
    heads split where the query heads are not, or the embedding and the
    unembedding split over other axes)."""
    from repro_torch.models.params import map_specs, tree_leaves

    rules = param_rules(mesh, overrides, cfg)

    def place(_path, spec):
        dims = named_sharding(mesh, spec.axes, rules, spec.shape)
        return Placement(dims, tuple((d, p) for d, (ax, p) in enumerate(zip(spec.axes, dims))
                                     if p and ax in FSDP_RULES))

    places = map_specs(place, specs)
    if not any(p.split for p in tree_leaves(places)):
        return None
    if not shards_parameters(cfg):   # expert parallelism: no tensor-parallel dim
        return ParamLayout(mesh=mesh, placements=places, tp=TensorParallel((), (), (), ()))
    stacked = not isinstance(places["layers"], list)
    layer = places["layers"] if stacked else places["layers"][0]
    tp = TensorParallel(heads=layer["attn"]["w_q"].dims[1 + stacked],
                        kv_heads=layer["attn"]["w_k"].dims[1 + stacked],
                        ff=layer["mlp"]["w_up"].dims[1 + stacked],
                        vocab=places["embed"].dims[0])
    if tp.kv_heads and tp.kv_heads != tp.heads:
        raise NotImplementedError(f"parameter sharding: kv heads over {tp.kv_heads} but "
                                  f"query heads over {tp.heads}")
    if "lm_head" in places and places["lm_head"].dims[1] != tp.vocab:
        raise NotImplementedError(f"parameter sharding: the embedding's vocab over "
                                  f"{tp.vocab}, the unembedding's over "
                                  f"{places['lm_head'].dims[1]}")
    return ParamLayout(mesh=mesh, placements=places, tp=tp)


@dataclasses.dataclass(frozen=True)
class _Active:
    mesh: object
    rules: dict
    layout: Optional[ParamLayout] = None


_lock = threading.Lock()
_active: Optional[_Active] = None
# depth of the open ``whole_sequence`` contexts (process-wide, as the rules)
_whole = 0


@contextlib.contextmanager
def sharding_rules(mesh, overrides: Optional[dict] = None,
                   layout: Optional[ParamLayout] = None):
    """Activate the logical-axis rules for model code within this context
    (``sharding.py:156``), process-wide; contexts do not nest. ``layout``
    (``param_layout``): the parameters the model is given are the rank's
    slices placed so; without one they are whole."""
    global _active
    rules = {k: _rule_axes(mesh, _merged(overrides), k) for k in _merged(overrides)}
    with _lock:
        if _active is not None:
            raise RuntimeError("sharding_rules: a context is already active")
        _active = _Active(mesh, rules, layout)
    try:
        yield
    finally:
        with _lock:
            _active = None


def active_mesh():
    """The mesh of the active context (None outside one)."""
    act = _active
    return act.mesh if act is not None else None


def active_layout() -> Optional[ParamLayout]:
    """The parameter layout of the active context (None: whole
    parameters, or no context)."""
    act = _active
    return act.layout if act is not None else None


def logical_constraint(x, axes: tuple, partial: tuple = ()):
    """The activation ``x`` of logical ``axes`` made to match the active
    rules (``sharding.py:233``). A rank holds its own rows already, so
    only a partial sum moves: ``partial`` names the mesh axes over which
    x is one rank's share (a row-parallel product's output), and those
    that the rules map none of ``axes`` onto are summed over the ranks
    (``mesh.tp_reduce``: all-reduce forward, identity backward). Identity
    outside a context."""
    act = _active
    if act is None or not partial:
        return x
    kept = {a for ax in axes if ax for a in act.rules.get(ax, ())}
    summed = tuple(a for a in partial if a not in kept)
    if not summed:
        return x
    from repro_torch.distributed.mesh import tp_reduce

    return tp_reduce(x, act.mesh.mesh_id, ",".join(summed))


@contextlib.contextmanager
def whole_sequence():
    """Suspend the active sequence shard for sites whose rows are whole on
    every rank (Whisper's encoder: the reference lays ``frames`` out as
    ("batch", None, None)): inside, ``active_seq_sharding`` reports no
    sequence axes and ``seq_offset`` 0, so attention gathers no keys,
    refuses no impl and dispatches the single-device key with no
    ``kv_offset``. The reduce axes (``active_reduce_axes``) stay: the
    rows' gradients are still summed over the sequence's ranks.
    Process-wide, as the rules are (a remat recompute runs on autograd's
    thread); contexts nest."""
    global _whole
    with _lock:
        _whole += 1
    try:
        yield
    finally:
        with _lock:
            _whole -= 1


def active_seq_sharding():
    """(mesh, seq_axes, lead_axes) for the context-parallel attention
    (``sharding.py:180``). ``seq_axes`` are the mesh axes the "seq" rule
    maps onto, empty without an active context, inside ``whole_sequence``
    or when they span <= 1 ranks; ``lead_axes`` the "batch" + "heads_act"
    axes minus any the sequence claims (a mesh axis may appear once).
    Outside a context: (None, (), ())."""
    act = _active
    if act is None:
        return None, (), ()
    mesh, rules = act.mesh, act.rules
    seq_axes = rules.get("seq", ())
    if _whole or mesh.axis_size(seq_axes) <= 1:
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
