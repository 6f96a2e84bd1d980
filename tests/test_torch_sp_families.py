"""Sequence parallelism for the recurrent families and exact attention,
and the frontend families under a batch split, in the port, on the CPU.

One group of 4 ``gloo`` ranks on a ("data", "model") mesh of 2 x 2
(``launch/mesh.py:spawn_local``) runs, with inputs from numpy seeds:

* the building blocks of ``distributed/seq_parallel.py`` over 2 shards
  (the sequence over "model") and 4 (over both axes): the halo, the affine
  carry and the state chain (forward, and the chain's backward) against
  the unsharded results, exactly;
* ``full`` / ``chunked`` attention over 2 and 4 shards, causal and
  bidirectional (``models/attention.py:gather_keys``, then
  ``_core_attention``), against the reference's ``full_attention`` /
  ``chunked_attention`` on the whole sequence (1e-5), their gradients
  against the port's single-device route (1e-5);
* the port's ``mamba_forward``, ``mlstm_chunked`` and ``slstm_scan`` over 2
  and 4 shards of 20 / 10 rows (chunks of 8: no shard a whole number of
  chunks) against the reference's on the whole sequence (1e-5), their
  gradients against the port's single device (the mLSTM's: the reference's
  are NaN at its configs' chunk, R4);
* the sequence-parallel ``Trainer`` ({"seq": "model"}) on reduced Hymba
  (``chunked`` and ``spectral_shift_fused``, remat none and full) and
  reduced xLSTM (an mLSTM and an sLSTM block) against the single-device
  ``Trainer`` (losses 1e-4, params 2e-4); step 0's loss at one layer
  (Hymba under ``chunked``, xLSTM with one sLSTM block) against
  ``jax.jit(make_train_step)`` (1e-4), each beside a control (shard 1's
  incoming mamba state zeroed; its sLSTM state dropped) that must miss
  that bound;
* Whisper and LLaVA trained data-parallel (rows over "data") against one
  device, and ``make_global_batch``'s frames / patches rows, exactly.

Then, with no ranks, ``launch/dryrun.py:run_cell`` of the hybrid, ssm and
``qwen2-7b`` (its own ``chunked`` attention) cells at reduced depth on a
2 x 2 ``AbstractMesh``: each traces and counts the collectives this slice
adds; a MoE train cell stays refused under the sequence shard.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MESH, AXES = (2, 2), ("data", "model")
SPLITS = {2: ("model",), 4: ("data", "model")}
SEQ, BATCH, STEPS = 48, 4, 2       # the trainers: 24 positions a shard
REC_SEQ, REC_CHUNK = 40, 8         # the recurrences: 20 / 10 rows a shard
ENC = 16                           # Whisper's stub frames
HALO = 3                           # a conv of width 4


def _inputs() -> dict:
    rng = np.random.default_rng(30)

    def rn(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    b, s, h, d = 2, REC_SEQ, 2, 16
    return dict(
        x=rn(b, s, 6),
        ab=np.stack([rng.uniform(0.2, 0.9, (4, b, 6)), rng.standard_normal((4, b, 6))],
                    1).astype(np.float32),
        ints=rng.integers(-4, 5, (b, s, 6)).astype(np.float32),
        q=rn(b, h, s, d, s=0.5), k=rn(b, h, s, d, s=0.5), v=rn(b, h, s, d),
        w=rn(b, h, s, d),
        ilog=rn(b, h, s), fpre=rn(b, h, s, s=2.0) + 2.0,
        xg=rn(b, s, h, 4, d, s=0.5), r_w=rn(h, 4, d, d, s=0.05),
        xm=rn(b, s, 16), wy=rn(b, s, 16), ws=rn(b, s, h, d))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
def _hybrid(impl: str, remat: str = "none", layers: int = 2):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    return reduced(get_config("hymba-1.5b"), attention_impl=impl, remat=remat,
                   attention_backend="interpret", num_landmarks=8, ssm_chunk=16,
                   num_layers=layers)


def _ssm(layers: int = 2):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    return reduced(get_config("xlstm-350m"), slstm_every=2 if layers == 2 else 1,
                   ssm_chunk=16, num_layers=layers)


def _frontend(arch: str):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    kw = dict(encoder_layers=2) if arch == "whisper-base" else {}
    return reduced(get_config(arch), num_layers=2, **kw)


def _shape():
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("train_4k", SEQ, BATCH, "train")


def _data(cfg):
    from repro_torch.data.pipeline import StubFrontendLM

    return StubFrontendLM(cfg.family, cfg.vocab_size, SEQ, BATCH, d_model=cfg.d_model,
                          num_patches=cfg.num_patches, enc_len=ENC, seed=0)


TRAINERS = {
    "hybrid_chunked_none": lambda: _hybrid("chunked", "none"),
    "hybrid_chunked_full": lambda: _hybrid("chunked", "full"),
    "hybrid_fused_none": lambda: _hybrid("spectral_shift_fused", "none"),
    "hybrid_fused_full": lambda: _hybrid("spectral_shift_fused", "full"),
    "ssm": lambda: _ssm(2),
}
DP = {"whisper": "whisper-base", "llava": "llava-next-34b"}


def _numpy(leaves) -> list:
    return [t.detach().float().numpy().copy() for t in leaves]


def _train(cfg, ckpt: str, mesh=None, overrides=None, data=None) -> dict:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import Trainer

    kw = {} if mesh is None else dict(rule_overrides=overrides)
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=ckpt, seed=0, checkpoint_every=0),
                 _shape(), mesh, device="cpu", data=data, **kw)
    losses = [h["loss"] for h in tr.run(STEPS, log_every=100)]
    return {"losses": losses, "params": _numpy(tree_leaves(tr.params))}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------
def _blocks(mesh, inp: dict) -> dict:
    from repro_torch.distributed import seq_parallel as sp

    out = {}
    for shards, axes in SPLITS.items():
        i = mesh.index(axes)
        n = REC_SEQ // shards
        rows = slice(i * n, (i + 1) * n)
        x = torch.from_numpy(inp["x"])[:, rows]
        out[("halo", shards)] = sp.halo_exchange(x, mesh, axes, HALO).numpy()
        ab = torch.from_numpy(inp["ab"][:shards])
        out[("carry", shards)] = sp.affine_carry(ab[i, 0], ab[i, 1], mesh, axes).numpy()
        xi = torch.from_numpy(inp["ints"])[:, rows].requires_grad_(True)
        anchor = torch.zeros(3, requires_grad=True)

        def run(st):
            y = st[0][:, None] + torch.cumsum(xi, dim=1)
            return y, (y[:, -1],)

        y, (fin,) = sp.state_chain(run, (torch.zeros_like(xi[:, 0]),), mesh, axes, anchor)
        w = torch.from_numpy(inp["ints"])[:, rows]
        gx, _ = torch.autograd.grad((y * w).sum(), (xi, anchor), allow_unused=True)
        out[("chain", shards)] = (y.detach().numpy(), fin.detach().numpy(), gx.numpy())
    return out


def _attention(mesh, inp: dict) -> dict:
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.models.attention import _core_attention, gather_keys

    cfg = _hybrid("chunked")
    out = {}
    for shards, axes in SPLITS.items():
        i = mesh.index(axes)
        n = REC_SEQ // shards
        rows = slice(i * n, (i + 1) * n)
        q, k, v, w = (torch.from_numpy(inp[name])[:, :, rows] for name in "qkvw")
        for impl in ("full", "chunked"):
            for causal in (True, False):
                ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
                with sharding_rules(mesh, {"seq": axes}):
                    kg, vg = gather_keys(kl, vl, causal=causal)
                    o = _core_attention(cfg, impl, ql, kg, vg, causal=causal)
                    grads = torch.autograd.grad((o * w).sum(), (ql, kl, vl))
                out[(impl, causal, shards)] = (o.detach().numpy(), _numpy(grads))
    return out


def _recurrences(mesh, inp: dict, mamba_p: dict) -> dict:
    import torch.nn.functional as F

    from repro_torch.distributed.seq_parallel import SeqShard
    from repro_torch.models import ssm

    out = {}
    for shards, axes in SPLITS.items():
        shard = SeqShard(mesh, axes)
        n = REC_SEQ // shards
        rows = slice(shard.index * n, (shard.index + 1) * n)
        # mamba: output and the gradients of x and every parameter (summed
        # over the shards)
        p = {k: torch.from_numpy(t).requires_grad_(True) for k, t in mamba_p.items()}
        x = torch.from_numpy(inp["xm"])[:, rows].requires_grad_(True)
        y, (h_fin, _) = ssm.mamba_forward(p, x, 4, chunk=REC_CHUNK, shard=shard)
        wy = torch.from_numpy(inp["wy"])[:, rows]
        g = torch.autograd.grad((y * wy).sum(), (x, *p.values()))
        pg = [mesh.all_reduce(t, "sum", axes).numpy() for t in g[1:]]
        out[("mamba", shards)] = (y.detach().numpy(), h_fin.detach().numpy(),
                                  g[0].numpy(), pg)
        # mLSTM: the (C, n, m) chain
        q, k, v = (torch.from_numpy(inp[name])[:, :, rows].requires_grad_(True)
                   for name in "qkv")
        ilog = torch.from_numpy(inp["ilog"])[:, :, rows].requires_grad_(True)
        fpre = torch.from_numpy(inp["fpre"])[:, :, rows].requires_grad_(True)
        flog = F.logsigmoid(fpre)
        b, h, _, d = q.shape
        hs, _ = shard.chain(
            lambda st: ssm.mlstm_chunked(q, k, v, ilog, flog, state=st, chunk=REC_CHUNK,
                                         exact_final=True),
            ssm.mlstm_fresh_state(b, h, d, q.device), anchor=ilog)
        w = torch.from_numpy(inp["w"])[:, :, rows]
        g = torch.autograd.grad((hs * w).sum(), (q, k, v, ilog, fpre))
        out[("mlstm", shards)] = (hs.detach().numpy(), _numpy(g))
        # sLSTM: the (c, n, m, h) chain
        xg = torch.from_numpy(inp["xg"])[:, rows].requires_grad_(True)
        r_w = torch.from_numpy(inp["r_w"]).requires_grad_(True)
        hs, _ = shard.chain(lambda st: ssm.slstm_scan(xg, r_w, state=st),
                            ssm.slstm_fresh_state(b, h, d, xg.device), anchor=r_w)
        ws = torch.from_numpy(inp["ws"])[:, rows]
        gx, gr = torch.autograd.grad((hs * ws).sum(), (xg, r_w))
        out[("slstm", shards)] = (hs.detach().numpy(), gx.numpy(),
                                  mesh.all_reduce(gr, "sum", axes).numpy())
    return out


def _step0(mesh, cfg, control) -> tuple:
    """Step 0's loss and the rank's logits (the forward at the seed's
    weights) of the SP trainer on ``cfg``, sound and under ``control``
    (module, name, value)."""
    import tempfile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model import model_forward
    from repro_torch.train.train_step import make_eval_step
    from repro_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, TrainConfig(checkpoint_dir=tmp, seed=0), _shape(), mesh,
                     rule_overrides={"seq": "model"}, device="cpu")
    out = []
    for patch in (None, control):
        if patch is not None:
            module, name, value = patch
            saved = getattr(module, name)
            setattr(module, name, value)
        try:
            with tr._rules(), torch.no_grad():
                batch = tr._batch(0)
                _, m = make_eval_step(tr.cfg)(tr.params, batch)
                logits, _ = model_forward(tr.params, tr.cfg, batch)
        finally:
            if patch is not None:
                setattr(module, name, saved)
        out.append((float(m["ce"]), logits.numpy()))
    return tuple(out)


def _controls(mesh) -> dict:
    from repro_torch.distributed import seq_parallel as sp

    carry, chain = sp.affine_carry, sp.state_chain

    def zeroed_carry(a, b, mesh_, axes):   # shard 1 loses its entering mamba state
        h = carry(a, b, mesh_, axes)
        return h * 0 if mesh_.index(axes) == 1 else h

    def dropped_chain(run, fresh, mesh_, axes, anchor):   # shard 1 starts afresh
        one = mesh_.index(axes) == 1
        return chain(lambda st: run(fresh if one else st), fresh, mesh_, axes, anchor)

    return {"hybrid": _step0(mesh, _hybrid("chunked", layers=1),
                             (sp, "affine_carry", zeroed_carry)),
            "ssm": _step0(mesh, _ssm(1), (sp, "state_chain", dropped_chain))}


def _rank(mesh, inp: dict, mamba_p: dict, root: str) -> dict:
    import os

    from repro_torch.data.pipeline import make_global_batch

    res = {"blocks": _blocks(mesh, inp), "attention": _attention(mesh, inp),
           "recurrences": _recurrences(mesh, inp, mamba_p), "step0": _controls(mesh)}
    res["sp"] = {name: _train(make(), os.path.join(root, name), mesh, {"seq": "model"})
                 for name, make in TRAINERS.items()}
    res["dp"] = {}
    for name, arch in DP.items():
        cfg = _frontend(arch)
        res["dp"][name] = _train(cfg, os.path.join(root, name), mesh, None, _data(cfg))
        res["dp"][name]["batch"] = make_global_batch(_data(cfg).batch(0), mesh)
    return res


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba_params():
    """Reference mamba parameters (d 16, state 4, width 4, dt rank 8), as
    numpy."""
    import jax

    from repro.models import ssm as jssm
    from repro.models.params import init_params as jinit_params

    jp = jinit_params(jssm.mamba_specs(16, 16, 4, 4, 8), jax.random.PRNGKey(3))
    return {k: np.array(v, dtype=np.float32) for k, v in jp.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, mamba_params):
    from repro_torch.launch.mesh import spawn_local

    root = str(tmp_path_factory.mktemp("sp_families"))
    return spawn_local(_rank, MESH, AXES, args=(_inputs(), mamba_params, root),
                       device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def single(tmp_path_factory) -> dict:
    """The single-device Trainer on every config the ranks train, and the
    initial weights of the one-layer configs."""
    from repro_torch.models.params import params_to_numpy
    from repro_torch.train.trainer import Trainer
    from repro_torch.configs.base import TrainConfig

    root = tmp_path_factory.mktemp("single")
    out = {name: _train(make(), str(root / name)) for name, make in TRAINERS.items()
           if name.endswith("_none") or name == "ssm"}
    for name, arch in DP.items():
        cfg = _frontend(arch)
        out[name] = _train(cfg, str(root / name), data=_data(cfg))
    for name, cfg in (("hybrid_1", _hybrid("chunked", layers=1)), ("ssm_1", _ssm(1))):
        tr = Trainer(cfg, TrainConfig(checkpoint_dir=str(root / name), seed=0), _shape(),
                     device="cpu")
        out[name] = params_to_numpy(tr.params)
    return out


def _reference(name: str) -> str:
    """The single-device run a sequence-parallel one is held to (remat
    changes no value)."""
    return name.replace("_full", "_none")


# --------------------------------------------------------------------------
# the building blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shards", sorted(SPLITS))
def test_halo_carry_and_chain_match_unsharded(ranks, shards):
    inp = _inputs()
    n = REC_SEQ // shards
    x = inp["x"]
    ab = inp["ab"][:shards]
    total = np.cumsum(inp["ints"], axis=1)
    # d/dx_t of sum_s w_s cumsum(x)_s: the reverse cumsum of w from t on
    # (w = x), which the chain carries back across the shards
    want_g = np.flip(np.cumsum(np.flip(inp["ints"], 1), 1), 1)
    for rank, r in enumerate(ranks):
        i = _shard_of(rank, shards)
        want = (np.zeros_like(x[:, :HALO]) if i == 0
                else x[:, i * n - HALO:i * n])
        np.testing.assert_array_equal(r["blocks"][("halo", shards)], want)
        h = np.zeros_like(ab[0, 1])
        for j in range(i):
            h = ab[j, 0] * h + ab[j, 1]
        np.testing.assert_array_equal(r["blocks"][("carry", shards)], h)
        y, fin, gx = r["blocks"][("chain", shards)]
        rows = slice(i * n, (i + 1) * n)
        np.testing.assert_array_equal(y, total[:, rows])
        np.testing.assert_array_equal(fin, total[:, (i + 1) * n - 1])
        np.testing.assert_array_equal(gx, want_g[:, rows])


# --------------------------------------------------------------------------
# exact attention over gathered keys
# --------------------------------------------------------------------------
def _shard_of(rank: int, shards: int) -> int:
    return rank % 2 if shards == 2 else rank


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shards", sorted(SPLITS))
def test_exact_attention_under_a_shard(ranks, impl, causal, shards):
    import importlib

    import jax.numpy as jnp

    # the modules (each package's ``core`` exports a function of that name)
    jattn = importlib.import_module("repro.core.attention")
    attn = importlib.import_module("repro_torch.core.attention")
    inp = _inputs()
    ref = np.asarray(getattr(jattn, f"{impl}_attention")(
        *(jnp.asarray(inp[k]) for k in "qkv"), causal=causal))
    q, k, v = (torch.from_numpy(inp[name]).requires_grad_(True) for name in "qkv")
    one = getattr(attn, f"{impl}_attention")(q, k, v, causal=causal)
    grads = torch.autograd.grad((one * torch.from_numpy(inp["w"])).sum(), (q, k, v))
    n = REC_SEQ // shards
    for rank, r in enumerate(ranks):
        i = _shard_of(rank, shards)
        rows = slice(i * n, (i + 1) * n)
        out, g = r["attention"][(impl, causal, shards)]
        np.testing.assert_allclose(out, ref[:, :, rows], atol=1e-5, rtol=0)
        for a, b in zip(g, grads):
            np.testing.assert_allclose(a, b.numpy()[:, :, rows], atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# the recurrences over shards
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shards", sorted(SPLITS))
def test_mamba_over_shards(ranks, mamba_params, shards):
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    inp = _inputs()
    x = inp["xm"]
    ref, (jh, _) = jssm.mamba_forward({k: jnp.asarray(v) for k, v in mamba_params.items()},
                                      jnp.asarray(x), 4, chunk=REC_CHUNK)
    p = {k: torch.from_numpy(t.copy()).requires_grad_(True)
         for k, t in mamba_params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = ssm.mamba_forward(p, xt, 4, chunk=REC_CHUNK)
    g = torch.autograd.grad((y * torch.from_numpy(inp["wy"])).sum(),
                            (xt, *p.values()))
    n = REC_SEQ // shards
    for rank, r in enumerate(ranks):
        i = _shard_of(rank, shards)
        rows = slice(i * n, (i + 1) * n)
        out, h_fin, gx, pg = r["recurrences"][("mamba", shards)]
        np.testing.assert_allclose(out, np.asarray(ref)[:, rows], atol=1e-5, rtol=0)
        if i == shards - 1:
            np.testing.assert_allclose(h_fin, np.asarray(jh), atol=1e-5, rtol=0)
        np.testing.assert_allclose(gx, g[0].numpy()[:, rows], atol=1e-5, rtol=0)
        for a, b in zip(pg, g[1:]):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shards", sorted(SPLITS))
def test_mlstm_over_shards(ranks, shards):
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    inp = _inputs()
    flog = np.asarray(jax.nn.log_sigmoid(jnp.asarray(inp["fpre"])))
    ref, _ = jssm.mlstm_chunked(*(jnp.asarray(inp[k]) for k in "qkv"),
                                jnp.asarray(inp["ilog"]), jnp.asarray(flog), chunk=REC_CHUNK)
    q, k, v, ilog, fpre = (torch.from_numpy(inp[name]).requires_grad_(True)
                           for name in ("q", "k", "v", "ilog", "fpre"))
    hs, _ = ssm.mlstm_chunked(q, k, v, ilog, torch.nn.functional.logsigmoid(fpre),
                              chunk=REC_CHUNK)
    g = torch.autograd.grad((hs * torch.from_numpy(inp["w"])).sum(), (q, k, v, ilog, fpre))
    n = REC_SEQ // shards
    for rank, r in enumerate(ranks):
        i = _shard_of(rank, shards)
        rows = slice(i * n, (i + 1) * n)
        out, grads = r["recurrences"][("mlstm", shards)]
        np.testing.assert_allclose(out, np.asarray(ref)[:, :, rows], atol=1e-5, rtol=0)
        for a, b in zip(grads, g):
            np.testing.assert_allclose(a, b.numpy()[:, :, rows], atol=1e-5, rtol=0)


@pytest.mark.parametrize("shards", sorted(SPLITS))
def test_slstm_over_shards(ranks, shards):
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    inp = _inputs()
    ref, _ = jssm.slstm_scan(jnp.asarray(inp["xg"]), jnp.asarray(inp["r_w"]))
    xg = torch.from_numpy(inp["xg"]).requires_grad_(True)
    r_w = torch.from_numpy(inp["r_w"]).requires_grad_(True)
    hs, _ = ssm.slstm_scan(xg, r_w)
    gx, gr = torch.autograd.grad((hs * torch.from_numpy(inp["ws"])).sum(), (xg, r_w))
    n = REC_SEQ // shards
    for rank, r in enumerate(ranks):
        i = _shard_of(rank, shards)
        rows = slice(i * n, (i + 1) * n)
        out, sgx, sgr = r["recurrences"][("slstm", shards)]
        np.testing.assert_allclose(out, np.asarray(ref)[:, rows], atol=1e-5, rtol=0)
        np.testing.assert_allclose(sgx, gx.numpy()[:, rows], atol=1e-5, rtol=0)
        np.testing.assert_allclose(sgr, gr.numpy(), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_sp_trainer_matches_single_device(ranks, single, name):
    ref = single[_reference(name)]
    for r in ranks:
        run = r["sp"][name]
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-4)
        for a, b in zip(run["params"], ref["params"]):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)


# step 0 at one layer: the loss against ``jax.jit(make_train_step)``, and
# the rank's logits against the reference's forward, relative to their
# max-abs; the control must miss the logits' bound (at the seed's weights
# the mamba state decays within a few tokens, so shard 1's zeroed carry
# moves the loss by 2e-6 only)
STEP0_LOSS_TOL, STEP0_LOGITS_TOL = 1e-4, 1e-5


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_sp_step0_matches_jax_and_the_control_misses(ranks, single, family):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.configs.registry import get_config as jget_config
    from repro.data import pipeline as jpipeline
    from repro.models import model as jmodel
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jschedules
    from repro.train import train_step as jtrain_step

    cfg = _hybrid("chunked", layers=1) if family == "hybrid" else _ssm(1)
    kw = {k: getattr(cfg, k) for k in ("num_layers", "ssm_chunk", "slstm_every",
                                        "attention_impl", "num_landmarks")}
    jcfg = jbase.reduced(jget_config(cfg.name), **kw)
    jt = jbase.TrainConfig(seed=0)
    lr_fn = jschedules.warmup_cosine(jt.learning_rate, jt.warmup_steps, jt.total_steps)
    params = jax.tree.map(jnp.asarray, single[f"{family}_1"])
    step = jax.jit(jtrain_step.make_train_step(jcfg, jt, lr_fn))
    batch = jpipeline.SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=0).batch(0)
    tokens = {"tokens": jnp.asarray(batch["tokens"])}
    _, _, m = step(params, jadamw.adamw_init(params), tokens)
    ref = float(m["loss"])
    ref_logits = np.asarray(jmodel.model_forward(params, jcfg, tokens)[0])
    n = SEQ // 2
    for rank, r in enumerate(ranks):
        (sound, logits), (_, control) = r["step0"][family]
        d, i = rank // 2, rank % 2
        want = ref_logits[d * BATCH // 2:(d + 1) * BATCH // 2, i * n:(i + 1) * n]
        scale = np.abs(want).max()
        assert abs(sound - ref) / abs(ref) <= STEP0_LOSS_TOL, (sound, ref)
        assert np.abs(logits - want).max() / scale <= STEP0_LOGITS_TOL
        if i == 1:   # shard 1 is the one the control changes
            assert np.abs(control - want).max() / scale > STEP0_LOGITS_TOL


@pytest.mark.parametrize("name", sorted(DP))
def test_frontend_families_data_parallel(ranks, single, name):
    from repro_torch.data.pipeline import FRONTEND_KEYS

    ref = single[name]
    host = _data(_frontend(DP[name])).batch(0)
    key = [k for k in FRONTEND_KEYS if k in host][0]
    for rank, r in enumerate(ranks):
        run = r["dp"][name]
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-4)
        for a, b in zip(run["params"], ref["params"]):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
        rows = slice((rank // 2) * BATCH // 2, (rank // 2 + 1) * BATCH // 2)
        np.testing.assert_array_equal(run["batch"][key], host[key][rows])
        np.testing.assert_array_equal(run["batch"]["tokens"], host["tokens"][rows])


# --------------------------------------------------------------------------
# the dry-run's cells
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,attention,op", [
    ("hymba-1.5b", None, "all-gather"),
    ("hymba-1.5b", "spectral_shift_fused", "all-gather"),
    ("xlstm-350m", None, "send"),
    ("qwen2-7b", None, "all-gather"),
])
def test_run_cell_traces_the_new_cells(arch, attention, op):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.launch.dryrun import run_cell

    over = dict(num_layers=2, ssm_chunk=64) if arch != "qwen2-7b" else dict(num_layers=2)
    cell = run_cell(arch, "train_4k", False, attention=attention, cfg_overrides=over,
                    extra_rules={"seq": "model"}, mesh=AbstractMesh(MESH, AXES),
                    shape=ShapeConfig("train_4k", 256, 4, "train"))
    assert cell["flops_total"] > 0
    assert cell["collectives"][op]["count"] > 0, cell["collectives"]
    if arch == "xlstm-350m":   # rank 0 sends its states and receives their cotangents
        assert cell["collectives"]["recv"]["count"] == cell["collectives"]["send"]["count"]
    with pytest.raises(NotImplementedError, match="under a sequence shard"):
        run_cell("deepseek-v2-lite-16b", "train_4k", False, cfg_overrides=dict(num_layers=1),
                 extra_rules={"seq": "model"}, mesh=AbstractMesh(MESH, AXES),
                 shape=ShapeConfig("train_4k", 256, 4, "train"))
