"""DeepSeek-V2-Lite serving on the port (absorbed MLA + MoE) against the JAX
reference, on the CPU.

Reduced DeepSeek-V2-Lite (2 layers, d_model 128, 4 heads, kv_lora 32, rope
16, c = 16, 8 experts top-2 + 1 shared) with the reference's own weights
through ``params_from_numpy``:

* ``moe_forward`` at capacity_factor 1.25 (tokens dropped) and 100
  (dropless): output, aux loss, the routing and the kept mask;
* the weight bridge round trip and the parameter and cache layouts;
* one ``mla_decode`` step on the gather and paged routes (exact,
  recompute on gather, frozen, full attention), ``batched_prefill``
  (``ss_fused`` and ``replay``), two chunks of ``chunk_prefill``, and the
  frozen rebase and the stats reseed, each against the reference's
  function on the same numpy inputs: outputs or logits and every cache
  leaf;
* greedy tokens of the port's ``ServeEngine(device="cpu")`` equal to the
  JAX engine's on five routes at capacity_factor 100 (the main route
  ``ss_fused`` + ``paged``, the default replay + gather, chunks of 32,
  frozen streaming, chunks of 16 with the prefix cache), on the main route
  at the config's own 1.25 (the requests of the reference's own MLA test,
  ``tests/test_paged_serve.py::test_mla_paged_decode``), and for reduced
  Kimi-K2 (GQA + MoE) on the main route.

The port stores MLA's sequence leaves and ``k_lmk`` with a unit kv-head
axis ((B, 1, S, r) where the reference has (B, S, r)): ``_ref_layout``
inserts it on the reference's side before a comparison.

Tolerances follow ROADMAP P1: 5e-5 of max-abs at one fp32 layer, 5e-4 on
logits at two (random weights amplify rounding with depth); positions of a
replayed prompt whose context fills only 2-4 landmark rows carry
delta_ss's rounding noise (P2) and are held at 5e-4. Greedy tokens are
identical. Capacity depends on the padded length, which both engines
take from the same buckets. Each JAX engine run is made once per module.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import model_specs as jmodel_specs  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro.serve import decode_state as jdecode_state  # noqa: E402
from repro.serve import prefill as jprefill  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.kv_cache import cache_specs as jcache_specs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models.model import layer_params, model_specs  # noqa: E402
from repro_torch.models.params import (map_specs, params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.serve import decode, decode_state, prefill  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import cache_specs  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
SEQ_MAX = 64
ONE_LAYER_TOL = 5e-5
TOL = 5e-4
STREAM = ("bv_m", "bv_l", "bv_acc")
# leaves the port keeps with a unit kv-head axis ahead of their last two
UNIT_AXIS = ("latent", "rope", "k_lmk")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines run many small ops: one intra-op thread per test worker
    keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(capacity_factor=100.0, **kw):
    jcfg = dataclasses.replace(jbase.reduced(jget_config(ARCH), **kw),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(base.reduced(get_config(ARCH), **kw),
                              capacity_factor=capacity_factor)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def one_layer(weights):
    """The first layer of ``weights`` as a one-layer model (no second
    draw of the reference's weights)."""
    jcfg, jparams, cfg, params = weights
    first = lambda t: t[:1]  # noqa: E731
    return (dataclasses.replace(jcfg, num_layers=1),
            dict(jparams, layers=jax.tree.map(first, jparams["layers"])),
            dataclasses.replace(cfg, num_layers=1),
            dict(params, layers=jax.tree.map(first, params["layers"])))


def _rel(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _ref_layout(name: str, x):
    """A reference leaf in the port's layout (the unit kv-head axis of
    MLA's sequence leaves and ``k_lmk``)."""
    x = np.asarray(x)
    return np.expand_dims(x, x.ndim - 2) if name in UNIT_AXIS else x


def _layer0(jparams, params):
    return (jax.tree.map(lambda a: a[0], jparams["layers"]),
            layer_params(params, 0))


# ==========================================================================
# MoE feed-forward
# ==========================================================================
@pytest.mark.parametrize("capacity_factor", [1.25, 100.0], ids=["drops", "dropless"])
def test_moe_forward_matches_jax(weights, capacity_factor):
    """Layer 0's MoE: output within 5e-5 of max-abs, aux loss within 1e-6,
    and the routing identical: the same top-k experts in the same order,
    the same slots, the same kept mask (tokens dropped at 1.25, none at
    100)."""
    jcfg, cfg = _cfgs(capacity_factor)
    jp, p = (lp["moe"] for lp in _layer0(weights[1], weights[3]))
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    out, aux = moe.moe_forward(p, cfg, torch.from_numpy(x))
    assert _rel(out, jout) <= ONE_LAYER_TOL
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the reference's routing and slot assignment (moe.py:46-69), from its gates
    gates = jax.nn.softmax((jnp.asarray(x) @ jp["router"]).astype(jnp.float32), axis=-1)
    _, jtop_i = jax.lax.top_k(gates, jcfg.top_k)
    hot = jax.nn.one_hot(jtop_i, jcfg.num_experts, dtype=jnp.int32).reshape(2, -1, jcfg.num_experts)
    jslot = jnp.sum((jnp.cumsum(hot, axis=1) - 1) * hot, axis=-1).reshape(jtop_i.shape)
    jkeep = np.asarray(jslot < jmoe.capacity(jcfg, 24))
    _, _, top_i = moe.route(p, cfg, torch.from_numpy(x))
    slot, keep = moe.dispatch_slots(cfg, top_i, 24)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(slot.numpy()[jkeep], np.asarray(jslot)[jkeep])
    assert bool((~jkeep).any()) == (capacity_factor < 2)


def test_capacity_matches_jax():
    for capacity_factor in (1.25, 100.0):
        jcfg, cfg = _cfgs(capacity_factor)
        for s in (1, 7, 16, 24, 48, 480):
            assert moe.capacity(cfg, s) == jmoe.capacity(jcfg, s)
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert [moe.capacity(full, s) for s in (1, 128, 512)] == [
        jmoe.capacity(jfull, s) for s in (1, 128, 512)]


def test_expert_ties_keep_the_lower_index_first():
    """Equal gates: the lower expert id first, as ``jax.lax.top_k`` orders."""
    jcfg, cfg = _cfgs()
    p = {"router": torch.zeros(cfg.d_model, cfg.num_experts)}
    _, w, top_i = moe.route(p, cfg, torch.ones(1, 3, cfg.d_model))
    assert top_i.tolist() == [[list(range(cfg.top_k))] * 3]
    _, jtop_i = jax.lax.top_k(jnp.full((1, 3, jcfg.num_experts), 0.125), jcfg.top_k)
    assert np.asarray(jtop_i).tolist() == top_i.tolist()
    assert torch.allclose(w, torch.full_like(w, 1 / cfg.top_k))


# ==========================================================================
# Config, parameters and cache layout
# ==========================================================================
def test_config_registry_and_specs_mirror_jax():
    assert ARCH in ARCH_IDS and "kimi-k2-1t-a32b" in ARCH_IDS
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    jcfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)

    def shapes(tree, is_port):
        if is_port:
            out = {}
            map_specs(lambda path, s: out.__setitem__(path, tuple(s.shape)), tree)
            return out
        paths, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))
        return {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
                tuple(s.shape) for p, s in paths}

    assert shapes(model_specs(cfg), True) == shapes(jmodel_specs(jcfg), False)
    port_cache, ref_cache = shapes(cache_specs(cfg, 2, 32), True), shapes(
        jcache_specs(jcfg, 2, 32), False)
    assert set(port_cache) == set(ref_cache)
    for path, shape in ref_cache.items():
        name = path.rsplit("/", 1)[-1]
        want = list(shape)
        if name in UNIT_AXIS:
            want.insert(len(want) - 2, 1)
        assert port_cache[path] == tuple(want), path


def test_weight_bridge_round_trips(weights):
    """Every MLA and MoE leaf crosses ``params_from_numpy`` and comes back
    through ``params_to_numpy`` bit for bit."""
    _, jparams, _, params = weights
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    back = params_to_numpy(params)
    names = set()
    for path, leaf in ref:
        node = back
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
            names.add(getattr(k, "key", None))
        np.testing.assert_array_equal(node, leaf)
    assert {"w_q_nope", "w_q_rope", "w_dkv", "w_k_rope", "w_uk", "w_uv", "w_o", "norm_kv",
            "router", "w_gate", "w_up", "w_down", "shared"} <= names


def test_mla_latents_match_jax(one_layer):
    jcfg, jparams, cfg, params = one_layer
    jp, p = _layer0(jparams, params)
    x = np.random.default_rng(4).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 5, (2, 9))
    jc, jr = jattention.mla_latents(jp["attn"], jcfg, jnp.asarray(x), jnp.asarray(pos))
    c, r = attention.mla_latents(p["attn"], cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert _rel(c, jc) <= ONE_LAYER_TOL and _rel(r, jr) <= ONE_LAYER_TOL


# ==========================================================================
# One decode step, layer level
# ==========================================================================
DECODE_CASES = {
    # name: (route, decode_streaming, decode_attention_impl)
    "gather_exact": ("gather", "exact", "spectral_shift"),
    "paged_exact": ("paged", "exact", "spectral_shift"),
    "gather_recompute": ("gather", "recompute", "spectral_shift"),
    "gather_frozen": ("gather", "frozen", "spectral_shift"),
    "paged_frozen": ("paged", "frozen", "spectral_shift"),
    "paged_full": ("paged", "exact", "full"),
}


def _decode_state(cfg, rng, pos, s_view):
    """Random lane state of one MLA layer, in the reference's layout per
    lane: committed latent / rope rows 0..pos-1 of an s_view-long view,
    landmark sums and streaming stats on the rows reached so far."""
    c, h, r, dr = cfg.num_landmarks, cfg.num_heads, cfg.kv_lora_rank, cfg.rope_head_dim
    seg = -(-SEQ_MAX // c)
    lanes = []
    for p_ in pos:
        rows = (np.arange(c) <= p_ // seg)[:, None]
        lat = np.zeros((1, s_view, r), np.float32)
        rope = np.zeros((1, s_view, dr), np.float32)
        lat[0, :p_] = rng.standard_normal((p_, r))
        rope[0, :p_] = rng.standard_normal((p_, dr))
        lanes.append(dict(
            latent=lat, rope=rope,
            q_lmk=(rng.standard_normal((1, h, c, r + dr)) * rows).astype(np.float32),
            k_lmk=(rng.standard_normal((1, c, r + dr)) * rows).astype(np.float32),
            bv_m=(rng.standard_normal((1, h, c, 1)) * rows).astype(np.float32),
            bv_l=(rng.uniform(0.5, 2.0, (1, h, c, 1)) * rows).astype(np.float32),
            bv_acc=(rng.standard_normal((1, h, c, r)) * rows).astype(np.float32)))
    return lanes


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_mla_decode_step_matches_jax(one_layer, case):
    """Two lanes (positions 13 and 37 of a 64 horizon, blocks of 8): the
    port's all-lane step against the reference's per-lane ``mla_decode``:
    the attention output and every leaf (the new token's latent and rope,
    both landmark sums, the streaming stats) within 5e-5 of max-abs."""
    route, streaming, impl = DECODE_CASES[case]
    jcfg, jparams, cfg, params = one_layer
    jcfg = dataclasses.replace(jcfg, decode_streaming=streaming,
                               decode_attention_impl=impl)
    cfg = dataclasses.replace(cfg, decode_streaming=streaming, decode_attention_impl=impl)
    jp, p = _layer0(jparams, params)
    rng = np.random.default_rng(5)
    pos, bs, s_view = np.array([13, 37], np.int32), 8, 40
    lanes = _decode_state(cfg, rng, pos, s_view)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    dense = {k: np.concatenate([ln[k] for ln in lanes]) for k in lanes[0]}
    port_cache = {k: torch.from_numpy(_ref_layout(k, v)) for k, v in dense.items()}
    if route == "paged":
        # each lane's rows in its own blocks of shared pools (1, nb, bs, .)
        n_slots = s_view // bs
        table = np.arange(1, 2 * n_slots + 1, dtype=np.int32).reshape(2, n_slots)[:, ::-1].copy()
        pools = {}
        for k in ("latent", "rope"):
            pool = np.zeros((1, 2 * n_slots + 1, bs, dense[k].shape[-1]), np.float32)
            for b in range(2):
                pool[0, table[b]] = dense[k][b].reshape(n_slots, bs, -1)
            pools[k] = pool
            port_cache[k] = torch.from_numpy(pool)
    out, new = decode.mla_decode(
        p["attn"], cfg, torch.from_numpy(x), port_cache, torch.from_numpy(pos),
        seq_max=SEQ_MAX, table=torch.from_numpy(table) if route == "paged" else None,
        block_size=bs)
    # the reference's layer step, compiled once for both lanes
    jstep = jax.jit(lambda x_, c_, p_, t_: jdecode.mla_decode(
        jp["attn"], jcfg, x_, c_, p_, impl, SEQ_MAX, None if t_ is None else (t_, bs, True)))
    for b in range(2):
        jcache = {k: jnp.asarray(v) for k, v in lanes[b].items()}
        paged = None
        if route == "paged":
            jcache.update((k, jnp.asarray(pools[k])) for k in pools)
            paged = (jnp.asarray(table[b]), bs, True)
        jout, jnew = jstep(jnp.asarray(x[b:b + 1]), jcache, jnp.asarray(pos[b]),
                           None if paged is None else paged[0])
        assert _rel(out[b:b + 1], jout) <= ONE_LAYER_TOL
        for k in ("q_lmk", "k_lmk", *STREAM):
            assert _rel(new[k][b:b + 1], _ref_layout(k, jnew[k])) <= ONE_LAYER_TOL, k
        for k in ("latent", "rope"):
            ref = np.asarray(jnew[k])
            ref = ref[:, pos[b]] if route == "gather" else ref[:, 0]
            assert _rel(new[k][b, 0, 0], ref[0]) <= ONE_LAYER_TOL, k


# ==========================================================================
# Prefill, whole prompt and chunked
# ==========================================================================
def _prefill_both(model, prefill_impl, n_valid=37, n_pad=48, seed=6):
    jcfg, jparams, cfg, params = model
    tokens = np.zeros((1, n_pad), np.int32)
    tokens[0, :n_valid] = np.random.default_rng(seed).integers(3, cfg.vocab_size, n_valid)
    jlog, jcache = jprefill.batched_prefill(jparams, jcfg, jnp.asarray(tokens),
                                            jnp.asarray(n_valid, jnp.int32),
                                            seq_max=SEQ_MAX, prefill_impl=prefill_impl)
    log, cache = prefill.batched_prefill(params, cfg, torch.from_numpy(tokens).long(),
                                         n_valid, seq_max=SEQ_MAX, prefill_impl=prefill_impl)
    return (np.asarray(jlog)[0, :n_valid], jcache), (log[0, :n_valid], cache)


@pytest.mark.parametrize("prefill_impl", ["ss_fused", "replay"])
def test_one_layer_mla_prefill_matches_jax(one_layer, prefill_impl):
    """A 37-token prompt in a 48-token bucket at one layer: every cache
    leaf within 5e-5 of max-abs; the logits within 5e-5 under ``ss_fused``
    and 5e-4 under ``replay``, whose per-position decode math amplifies
    rounding alike in both implementations where a position's c x c core
    is ill-conditioned (P1, P2)."""
    (jlog, jcache), (log, cache) = _prefill_both(one_layer, prefill_impl)
    assert _rel(log, jlog) <= (ONE_LAYER_TOL if prefill_impl == "ss_fused" else TOL)
    assert set(cache["layers"]) == set(jcache["layers"])
    for name, leaf in cache["layers"].items():
        assert _rel(leaf, _ref_layout(name, jcache["layers"][name])) <= ONE_LAYER_TOL, name


def test_two_layer_mla_prefill_logits_match_jax(weights):
    (jlog, _), (log, _) = _prefill_both(weights, "ss_fused")
    assert _rel(log, jlog) <= TOL


def test_one_layer_mla_chunks_match_jax(one_layer):
    """Two consecutive chunks of one prompt (32 tokens, then a ragged 19 of
    32) under ``stats_impl="ss_fused"`` (K1 at the chunk site: the Pallas
    kernel interpreted on the reference's side), each side fed its own
    previous chunk: the stats carry and every other leaf within 5e-5 of
    max-abs; the logits equal the port's own whole-prompt replay of the
    same tokens within 1e-5 (a chunk is the replay math at its global
    positions) and the reference's within 5e-4 at every position: the
    replay math at a position whose c x c core is ill-conditioned amplifies
    rounding in both implementations alike, chunked or not (P1, P2)."""
    jcfg, jparams, cfg, params = one_layer
    pad = 32
    toks = np.random.default_rng(8).integers(3, cfg.vocab_size, 51)
    whole, _ = prefill.batched_prefill(params, cfg, torch.from_numpy(toks[None]).long(),
                                       51, seq_max=SEQ_MAX, prefill_impl="replay")
    zero = jprefill._zero_cache(jcfg, 0)["layers"]
    jlayers = dict(zero)
    layers_t = {k: torch.from_numpy(_ref_layout(k, v).copy()) for k, v in zero.items()}
    for start, cv in ((0, 32), (32, 19)):
        chunk = np.zeros((1, pad), np.int32)
        chunk[0, :cv] = toks[start:start + cv]
        jl, jc = jprefill.chunk_prefill(jparams, jcfg, {"layers": jlayers},
                                        jnp.asarray(chunk), start, cv, seq_max=SEQ_MAX,
                                        stats_impl="ss_fused")
        lg, pc = prefill.chunk_prefill(params, cfg, {"layers": layers_t},
                                       torch.from_numpy(chunk).long(), start, cv,
                                       seq_max=SEQ_MAX, stats_impl="ss_fused")
        assert _rel(lg[0, :cv], whole[0, start:start + cv]) <= 1e-5
        assert _rel(lg[0, :cv], np.asarray(jl)[0, :cv]) <= TOL
        for name in jc["layers"]:
            assert _rel(pc["layers"][name], _ref_layout(name, jc["layers"][name])) \
                <= ONE_LAYER_TOL, name
        # the next chunk sees this one's rows committed after the earlier ones
        jlayers = {name: (jnp.concatenate([jlayers[name], jc["layers"][name][..., :cv, :]],
                                          axis=2) if name in ("latent", "rope")
                          else jc["layers"][name]) for name in jlayers}
        layers_t = {name: (torch.cat([layers_t[name], pc["layers"][name][..., :cv, :]], 3)
                           if name in ("latent", "rope") else pc["layers"][name])
                    for name in layers_t}


# ==========================================================================
# Frozen rebase and stats reseed
# ==========================================================================
@pytest.mark.parametrize("which", ["rebase", "reseed"])
def test_mla_rebase_and_reseed_match_jax(one_layer, which):
    """``rebase_layer`` at segment boundaries (positions 16 and 32: rows
    active - 1 and active recomputed) and ``reseed_layer`` (positions 13
    and 37: every reached row) for two lanes at once, against the
    reference's per-lane ``_rebase_attn_layer`` / ``_reseed_attn_layer``
    with ``mla=True``: every leaf within 5e-5 of max-abs."""
    jcfg, _, cfg, _ = one_layer
    pos = np.array([16, 32] if which == "rebase" else [13, 37], np.int32)
    lanes = _decode_state(cfg, np.random.default_rng(9), pos + 1, 48)
    dense = {k: np.concatenate([ln[k] for ln in lanes]) for k in lanes[0]}
    lc = {k: torch.from_numpy(_ref_layout(k, v)) for k, v in dense.items()}
    fn = decode_state.rebase_layer if which == "rebase" else decode_state.reseed_layer
    out = fn(cfg, lc, torch.from_numpy(pos), SEQ_MAX)
    for b in range(2):
        jl = {k: jnp.asarray(v) for k, v in lanes[b].items()}
        if which == "rebase":
            ref = jdecode_state._rebase_attn_layer(jcfg, jl, jnp.asarray(pos[b]), SEQ_MAX, True)
        else:
            ref = jdecode_state._reseed_attn_layer(jcfg, jl, jnp.asarray(pos[b]), SEQ_MAX,
                                                   True, None)
        for k in ref:
            assert _rel(out[k][b:b + 1], _ref_layout(k, ref[k])) <= ONE_LAYER_TOL, k


# ==========================================================================
# The engine, route by route
# ==========================================================================
PROMPT_LENS = (10, 29, 45)      # <= c (exact window); > c, two pad lengths
# one 64-token bucket for both prompts > c: one prefill program per engine
BASE = dict(max_lanes=2, max_seq=64, block_size=8, prefill_bucket=64)
MAIN = dict(prefill_impl="ss_fused", decode_impl="paged")
# route: (ServeConfig fields, ModelConfig fields)
ROUTES = {
    "main": (MAIN, {}),
    "default": ({}, {}),
    "chunked": (dict(MAIN, chunked_prefill=True, prefill_chunk_tokens=32), {}),
    "frozen": (MAIN, dict(decode_streaming="frozen")),
    "prefix_cache": (dict(MAIN, prefix_cache=True, prefill_chunk_tokens=16), {}),
}


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=n).tolist() for n in lens]


def _serve(engine_cls, request_cls, cfg, params, serve, prompts, max_new=6, **kw):
    eng = engine_cls(cfg, params, serve=serve, **kw)
    for uid, prompt in enumerate(prompts):
        eng.submit(request_cls(uid, list(prompt), max_new_tokens=max_new))
    return eng.run(), eng


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_tokens_identical_to_jax_engine(weights, route):
    jcfg, jparams, cfg, params = weights
    serve_kw, model_kw = ROUTES[route]
    prompts = _prompts(cfg.vocab_size)
    if route == "prefix_cache":
        prompts.append(prompts[1])      # a repeat: the prefix cache's full hit
    jout, jeng = _serve(JServeEngine, JRequest, dataclasses.replace(jcfg, **model_kw),
                        jparams, jbase.ServeConfig(**BASE, **serve_kw), prompts)
    out, eng = _serve(ServeEngine, Request, dataclasses.replace(cfg, **model_kw), params,
                      base.ServeConfig(**BASE, **serve_kw), prompts, device="cpu")
    assert sorted(out) == list(range(len(prompts)))
    assert out == jout
    stats, jstats = eng.stats(), jeng.stats()
    assert stats["mode"] == jstats["mode"] and stats["decode_impl"] == jstats["decode_impl"]
    if route == "frozen":
        assert stats["rebases"] == jstats["rebases"] > 0
    if route == "prefix_cache":
        assert stats["prefix"]["hits"] == jstats["prefix"]["hits"] >= 1


def test_main_route_at_the_configs_capacity_factor(weights):
    """capacity_factor 1.25 (the config's own; prompts drop tokens at their
    experts): the requests of the reference's own MLA test
    (``tests/test_paged_serve.py::test_mla_paged_decode``: seed 36, 4-23
    tokens, 8 new, max_seq 64) through the main route."""
    jcfg, jparams, cfg, params = weights
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=get_config(ARCH).capacity_factor)
                 for c in (jcfg, cfg))
    assert cfg.capacity_factor == 1.25
    rng = np.random.default_rng(36)
    prompts = [rng.integers(3, cfg.vocab_size, int(rng.integers(4, 24))).tolist()
               for _ in range(3)]
    serve = dict(max_lanes=2, max_seq=64, block_size=8, **MAIN)
    jout, _ = _serve(JServeEngine, JRequest, jcfg, jparams, jbase.ServeConfig(**serve),
                     prompts, max_new=8)
    out, _ = _serve(ServeEngine, Request, cfg, params, base.ServeConfig(**serve), prompts,
                    max_new=8, device="cpu")
    assert out == jout


def test_gqa_moe_main_route_identical_to_jax_engine():
    """Reduced Kimi-K2 (GQA with one kv head, 8 experts top-2 + 1 shared;
    at full width it fits no single card): the main route."""
    jcfg = jbase.reduced(jget_config("kimi-k2-1t-a32b"))
    cfg = base.ModelConfig(**dataclasses.asdict(jcfg))
    assert cfg.moe and not cfg.mla and cfg.family == "moe"
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(3))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    prompts = _prompts(cfg.vocab_size)
    jout, _ = _serve(JServeEngine, JRequest, jcfg, jparams,
                     jbase.ServeConfig(**BASE, **MAIN), prompts)
    out, eng = _serve(ServeEngine, Request, cfg, params, base.ServeConfig(**BASE, **MAIN),
                      prompts, device="cpu")
    assert eng.stats()["decode_impl"] == "paged"
    assert out == jout
