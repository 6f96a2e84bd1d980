"""Whisper and LLaVA under a sequence shard in the port, on the CPU.

Two groups of ``gloo`` ranks (``launch/mesh.py:spawn_local``), the
sequence over "model" of a 1 x 2 and a 1 x 3 mesh, run with inputs from
numpy seeds:

* ``models/attention.py:cross_attention_forward`` over 2 and 3 shards of
  the decoder sequence (the encoder output whole on every rank) against
  the reference's on the whole sequence: forward 1e-5, the gradients of
  the decoder rows, the encoder output and the weights 1e-4 of
  ``jax.grad``. The decoder lengths: 10 over 2 (segments of 3 straddle the
  shard boundary, 10 is no multiple of c = 4: a padded last segment), 12
  over 3 (segments of 3 straddle both boundaries), n = c (every query a
  landmark: the gathered q), and the global n_q == n_k, which the
  reference runs as self attention and the port refuses. A control, Q~
  from the rank's own rows, must miss the forward bound;
* the sequence-parallel ``Trainer`` on reduced Whisper (1 + 1 layers, 2
  shards; decoder 48 with ``dec_pos`` read at each shard's offset, and
  4100 > ``dec_pos``'s 4096 rows, 2050 a shard, with none added) and on
  reduced LLaVA (1 layer, 3 shards of the joint sequence of 20 patches +
  28 text tokens: shard 0 patches only, the prefix ending inside shard 1,
  shard 2 text only), each held two ways: step 0's loss and gradients
  (summed over the ranks) against the reference's ``loss_fn`` and
  ``jax.grad`` on the whole sequence (1e-4 of max-abs), and two steps
  against the single-device ``Trainer`` (losses 1e-4, params 2e-4). Beside
  each step 0 a control must move the loss past its bound: ``dec_pos``
  read from row 0 on every shard; the boundary shard's text placed at
  offset 0 of its slice.

Without ranks: ``data/pipeline.py:make_global_batch``'s split of the
joint sequence on an ``AbstractMesh`` of each rank, exactly against
slicing the whole joint sequence, and ``launch/dryrun.py:run_cell`` of a
Whisper and a LLaVA train cell on a 2 x 2 abstract mesh.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

AXES = ("data", "model")
# cross attention: (global n_q, n_k, c) per case and shard count
CROSS = {2: {"straddle_ragged": (10, 7, 4), "n_le_c": (4, 7, 4), "square": (8, 8, 4)},
         3: {"straddle": (12, 7, 4), "n_le_c": (6, 9, 6), "square": (6, 6, 4)}}
CROSS_FWD_TOL, CROSS_GRAD_TOL = 1e-5, 1e-4
SEQ, BATCH, STEPS, ENC = 48, 2, 2, 40
LONG = 4100                  # past dec_pos's 4096 rows, 2050 a shard
PATCHES = 20                 # LLaVA's prefix: ends inside shard 1 of 3 (16 a shard)
STEP0_TOL = 1e-4             # loss, relative; grads, of each leaf's max-abs


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
def _cross_cfg(c: int, pkg: str = "repro_torch"):
    import importlib

    base = importlib.import_module(f"{pkg}.configs.base")
    registry = importlib.import_module(f"{pkg}.configs.registry")
    return base.reduced(registry.get_config("whisper-base"), d_model=32, num_heads=2,
                        num_kv_heads=2, num_landmarks=c)


FRONTENDS = {   # name: (arch, reduced overrides, seq, shards)
    "whisper": ("whisper-base", dict(num_layers=1, encoder_layers=1, num_landmarks=10),
                SEQ, 2),
    "whisper_long": ("whisper-base", dict(num_layers=1, encoder_layers=1, d_model=32,
                                          num_heads=2, num_kv_heads=2, num_landmarks=10),
                     LONG, 2),
    "llava": ("llava-next-34b", dict(num_layers=1, num_landmarks=10,
                                     num_patches=PATCHES), SEQ, 3),
}
TRAINED = ("whisper", "llava")   # two steps against the single device


def _cfg(name: str, pkg: str = "repro_torch"):
    import importlib

    base = importlib.import_module(f"{pkg}.configs.base")
    registry = importlib.import_module(f"{pkg}.configs.registry")
    arch, over, _, _ = FRONTENDS[name]
    return base.reduced(registry.get_config(arch), **over)


def _data(name: str):
    from repro_torch.data.pipeline import StubFrontendLM

    cfg, seq = _cfg(name), FRONTENDS[name][2]
    return StubFrontendLM(cfg.family, cfg.vocab_size, seq, BATCH, d_model=cfg.d_model,
                          num_patches=cfg.num_patches, enc_len=ENC, seed=0)


def _shape(name: str):
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("train_4k", FRONTENDS[name][2], BATCH, "train")


def _trainer(name: str, ckpt: str, mesh=None):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer

    kw = {} if mesh is None else dict(rule_overrides={"seq": "model"})
    return Trainer(_cfg(name), TrainConfig(checkpoint_dir=ckpt, seed=0, checkpoint_every=0),
                   _shape(name), mesh, device="cpu", data=_data(name), **kw)


def _cross_inputs(n_q: int, n_k: int) -> dict:
    rng = np.random.default_rng(31)
    d, h, dh = 32, 2, 16

    def rn(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(p={"w_q": rn(d, h, dh, s=0.15), "w_k": rn(d, h, dh, s=0.15),
                   "w_v": rn(d, h, dh, s=0.15), "w_o": rn(h, dh, d, s=0.15)},
                x=rn(2, n_q, d), enc=rn(2, n_k, d), w=rn(2, n_q, d))


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------
def _cross(mesh, shards: int) -> dict:
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.kernels import sharded
    from repro_torch.models.attention import cross_attention_forward
    from repro_torch.core.landmarks import segment_means

    i = mesh.index(("model",))
    out = {}
    for case, (n_q, n_k, c) in CROSS[shards].items():
        inp = _cross_inputs(n_q, n_k)
        n = n_q // shards
        rows = slice(i * n, (i + 1) * n)
        cfg = _cross_cfg(c)
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inp["p"].items()}
        x = torch.from_numpy(inp["x"][:, rows]).requires_grad_(True)
        enc = torch.from_numpy(inp["enc"]).requires_grad_(True)
        w = torch.from_numpy(inp["w"][:, rows])
        with sharding_rules(mesh, {"seq": "model"}):
            try:
                o = cross_attention_forward(p, cfg, x, enc, impl="spectral_shift")
            except NotImplementedError as e:
                out[case] = str(e)
                continue
            g = torch.autograd.grad((o * w).sum(), (x, enc, *p.values()))
            ctl = None
            if n_q > c:   # the control: Q~ from the rank's own rows
                local = sharded.global_segment_means
                sharded.global_segment_means = lambda t, m, *_: segment_means(t, m)
                try:
                    with torch.no_grad():
                        ctl = cross_attention_forward(p, cfg, x, enc,
                                                      impl="spectral_shift").numpy()
                finally:
                    sharded.global_segment_means = local
        summed = [mesh.all_reduce(t, "sum", ("model",)).numpy() for t in g[1:]]
        out[case] = dict(out=o.detach().numpy(), ctl=ctl, dx=g[0].numpy(),
                         grads=summed)
    return out


def _step0(mesh, name: str, ckpt: str) -> dict:
    """Step 0's loss and gradients (summed over the ranks) of the SP
    trainer, and the loss under its control."""
    import repro_torch.models.model as model_module
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import make_eval_step, make_grad_step

    tr = _trainer(name, ckpt, mesh)
    with tr._rules():
        batch = tr._batch(0)
        loss, grads = make_grad_step(tr.cfg)(tr.params, batch)
        if name.startswith("whisper"):   # dec_pos read from row 0 on every shard
            sound = model_module._dec_pos_rows
            patch = ("_dec_pos_rows", lambda pos, off, s, n: sound(pos, 0, s, n))
        else:   # the boundary shard's text at offset 0 of its slice
            patch = ("_joint_rows", lambda pe, x: torch.cat(
                [x, pe] if pe.shape[1] and x.shape[1] else [pe, x], dim=1))
        saved = getattr(model_module, patch[0])
        setattr(model_module, patch[0], patch[1])
        try:
            _, m = make_eval_step(tr.cfg)(tr.params, batch)
        finally:
            setattr(model_module, patch[0], saved)
    return dict(loss=float(loss), control=float(m["ce"]),
                grads=[t.numpy() for t in tree_leaves(grads)],
                batch={k: v.numpy() for k, v in batch.items()})


def _steps(mesh, name: str, ckpt: str) -> dict:
    from repro_torch.models.params import tree_leaves

    tr = _trainer(name, ckpt, mesh)
    losses = [h["loss"] for h in tr.run(STEPS, log_every=100)]
    return dict(losses=losses, params=[t.detach().numpy().copy()
                                       for t in tree_leaves(tr.params)])


def _rank(mesh, root: str) -> dict:
    import os

    shards = mesh.axis_size(("model",))
    res = {"cross": _cross(mesh, shards), "step0": {}, "steps": {}}
    for name, (_, _, _, n) in FRONTENDS.items():
        if n != shards:
            continue
        res["step0"][name] = _step0(mesh, name, os.path.join(root, f"{name}_0"))
        if name in TRAINED:
            res["steps"][name] = _steps(mesh, name, os.path.join(root, name))
    return res


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> dict:
    from repro_torch.launch.mesh import spawn_local

    from concurrent.futures import ThreadPoolExecutor

    def group(shards):   # the two groups run at once, each on its own port
        root = str(tmp_path_factory.mktemp(f"sp_frontends_{shards}"))
        return spawn_local(_rank, (1, shards), AXES, args=(root,), device="cpu",
                           timeout_s=240)

    with ThreadPoolExecutor(2) as pool:
        return dict(zip((2, 3), pool.map(group, (2, 3))))


@pytest.fixture(scope="module")
def single(tmp_path_factory) -> dict:
    """The single-device Trainer: its initial weights (numpy) for every
    frontend case and two steps of the trained ones."""
    from repro_torch.models.params import params_to_numpy, tree_leaves

    root = tmp_path_factory.mktemp("sp_frontends_single")
    out = {}
    for name in FRONTENDS:
        tr = _trainer(name, str(root / name))
        out[name] = {"params0": params_to_numpy(tr.params)}
        if name in TRAINED:
            out[name]["losses"] = [h["loss"] for h in tr.run(STEPS, log_every=100)]
            out[name]["params"] = [t.detach().numpy().copy() for t in tree_leaves(tr.params)]
    return out


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --------------------------------------------------------------------------
# cross attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shards,case", [(s, c) for s in CROSS for c in CROSS[s]])
def test_cross_attention_over_shards_matches_jax(ranks, shards, case):
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn

    n_q, n_k, c = CROSS[shards][case]
    inp = _cross_inputs(n_q, n_k)
    if n_q == n_k:   # the self-attention route over the whole sequence: refused
        for r in ranks[shards]:
            assert "plain routes do not run under a sequence shard" in r["cross"][case]
        return
    jcfg = _cross_cfg(c, "repro")

    def run(p, x, enc):
        return jattn.cross_attention_forward(p, jcfg, x, enc, impl="spectral_shift")

    jp = {k: jnp.asarray(v) for k, v in inp["p"].items()}
    args = (jp, jnp.asarray(inp["x"]), jnp.asarray(inp["enc"]))
    ref, vjp = jax.vjp(jax.jit(run), *args)
    ref = np.asarray(ref)
    gp, gx, genc = vjp(jnp.asarray(inp["w"]))
    n = n_q // shards
    missed = 0.0
    for i, r in enumerate(ranks[shards]):
        got = r["cross"][case]
        rows = slice(i * n, (i + 1) * n)
        assert _max_rel(got["out"], ref[:, rows]) <= CROSS_FWD_TOL
        assert _max_rel(got["dx"], np.asarray(gx)[:, rows]) <= CROSS_GRAD_TOL
        for a, b in zip(got["grads"], [genc, *(gp[k] for k in inp["p"])]):
            assert _max_rel(a, b) <= CROSS_GRAD_TOL
        if n_q > c:
            missed = max(missed, _max_rel(got["ctl"], ref[:, rows]))
    assert n_q <= c or missed > CROSS_FWD_TOL, missed


# --------------------------------------------------------------------------
# the joint split and the dry-run (no ranks)
# --------------------------------------------------------------------------
def test_joint_split_matches_slicing_the_joint_sequence():
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.mesh import AbstractMesh

    host = _data("llava").batch(0)
    p, s = host["patches"].shape[1], host["tokens"].shape[1]
    assert (p, s) == (PATCHES, SEQ - PATCHES)
    joint_ids = np.concatenate([-1 - np.arange(p)[None].repeat(BATCH, 0), host["tokens"]], 1)
    targets = np.concatenate([np.zeros((BATCH, p), np.int32), host["tokens"][:, 1:],
                              np.zeros((BATCH, 1), np.int32)], 1)
    kinds = []
    for rank in range(3):
        got = make_global_batch(host, AbstractMesh((1, 3), AXES, rank=rank), {"seq": "model"})
        cols = slice(rank * 16, (rank + 1) * 16)
        ids = joint_ids[:, cols]
        np.testing.assert_array_equal(got["patches"], host["patches"][:, -1 - ids[0][ids[0] < 0]])
        np.testing.assert_array_equal(got["tokens"], ids[:, ids[0] >= 0])
        np.testing.assert_array_equal(got["targets"], targets[:, cols])
        kinds.append((got["patches"].shape[1] > 0, got["tokens"].shape[1] > 0))
    assert kinds == [(True, False), (True, True), (False, True)]


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_run_cell_traces_the_frontend_cells(arch):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.launch.dryrun import run_cell

    over = dict(num_layers=1, encoder_layers=1) if arch == "whisper-base" else dict(num_layers=1)
    cell = run_cell(arch, "train_4k", False, cfg_overrides=over, extra_rules={"seq": "model"},
                    mesh=AbstractMesh((2, 2), AXES), shape=ShapeConfig("train_4k", 256, 4,
                                                                        "train"))
    assert cell["flops_total"] > 0
    # the decoder's (or the joint sequence's) keys gathered over "model"
    assert cell["collectives"]["all-gather"]["count"] > 0, cell["collectives"]


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------
def _reference_step0(name: str, params0: dict, host: dict):
    import jax
    import jax.numpy as jnp

    from repro.models import model as jmodel

    jcfg = _cfg(name, "repro")
    jparams = jax.tree.map(jnp.asarray, params0)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(jparams, jbatch)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_sp_step0_matches_jax_and_the_control_misses(ranks, single, name):
    from repro_torch.models.params import flatten_with_paths

    shards = FRONTENDS[name][3]
    ref_loss, ref_grads = _reference_step0(name, single[name]["params0"],
                                           _data(name).batch(0))
    # the port's leaves in its tree order, the reference's in jax's (sorted
    # keys): match them by path
    paths = list(flatten_with_paths(single[name]["params0"]))
    order = sorted(range(len(paths)), key=lambda j: paths[j].split("::"))
    for r in ranks[shards]:
        got = r["step0"][name]
        assert abs(got["loss"] - ref_loss) / abs(ref_loss) <= STEP0_TOL, (got["loss"], ref_loss)
        grads = [got["grads"][j] for j in order]
        assert len(grads) == len(ref_grads)
        for a, b in zip(grads, ref_grads):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= STEP0_TOL * max(np.abs(b).max(), 1e-30)
    if name != "whisper_long":   # past 4096 no shard reads dec_pos: no control
        control = max(abs(r["step0"][name]["control"] - ref_loss) / abs(ref_loss)
                      for r in ranks[shards])
        assert control > STEP0_TOL, control


@pytest.mark.parametrize("name", TRAINED)
def test_sp_trainer_matches_single_device(ranks, single, name):
    ref = single[name]
    for r in ranks[FRONTENDS[name][3]]:
        run = r["steps"][name]
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-4)
        for a, b in zip(run["params"], ref["params"]):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
