"""The port's serving engine against the JAX reference, on the CPU, plus
the port's standalone-ness.

Greedy tokens of ``repro_torch``'s ``ServeEngine(device="cpu")`` must be
identical to the reference ``ServeEngine`` on reduced Qwen2-7B with
``ServeConfig(prefill_impl="ss_fused", decode_impl="paged")`` and
``decode_streaming="exact"``: once with a pool that holds every request,
once with a pool small enough to force recompute preemptions.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.model import model_specs as jmodel_specs  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# <= c (c = 16), > c inside a 32 bucket, > c across buckets, > c unpadded
PROMPT_LENS = (10, 29, 45, 32)


@pytest.fixture(scope="module")
def weights():
    jcfg = jbase.reduced(jget_config("qwen2-7b"))
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def reduced_cfg():
    return base.reduced(get_config("qwen2-7b"))


def _requests(vocab: int):
    rng = np.random.default_rng(0)
    return [(uid, rng.integers(3, vocab, size=n).tolist())
            for uid, n in enumerate(PROMPT_LENS)]


@pytest.mark.parametrize("num_blocks", [0, 12], ids=["roomy_pool", "preempting_pool"])
def test_greedy_tokens_identical_to_jax_engine(weights, num_blocks):
    jcfg, jparams, params = weights
    kw = dict(max_lanes=3, max_seq=96, block_size=8, num_blocks=num_blocks,
              prefill_impl="ss_fused", decode_impl="paged")
    jeng = JServeEngine(jcfg, jparams, serve=jbase.ServeConfig(**kw))
    eng = ServeEngine(reduced_cfg(), params, serve=base.ServeConfig(**kw),
                      device="cpu")
    for uid, prompt in _requests(jcfg.vocab_size):
        jeng.submit(JRequest(uid, prompt, max_new_tokens=10))
        eng.submit(Request(uid, prompt, max_new_tokens=10))
    jout, out = jeng.run(), eng.run()
    assert sorted(out) == sorted(jout) == list(range(len(PROMPT_LENS)))
    assert out == jout
    jpre = jeng.sched.total_preemptions
    assert eng.stats()["preemptions"] == jpre
    assert (jpre > 0) == (num_blocks > 0)


def test_engine_refuses_cuda_without_a_gpu(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ServeEngine(reduced_cfg(), weights[2],
                    serve=base.ServeConfig(prefill_impl="ss_fused",
                                           decode_impl="paged"))


@pytest.mark.parametrize("which,field,value", [("model", "decode_streaming", "frozen"),
                                               ("serve", "prefix_cache", True),
                                               ("serve", "chunked_prefill", True),
                                               ("serve", "telemetry", True),
                                               ("serve", "numerics_guard", True),
                                               ("serve", "max_queue", 4),
                                               ("serve", "watchdog_ticks", 8)])
def test_engine_rejects_unported_settings(weights, which, field, value):
    """Every setting of the list is served, alone and with telemetry on
    beside it (the flight recorder, the registry, the monitors:
    ``tests/test_torch_telemetry_engine.py``): frozen streaming, also
    under the chunked tick and the prefix cache
    (``tests/test_torch_frozen.py``), the numerics guard, ``max_queue``,
    the watchdog (``tests/test_torch_chaos.py``). Nothing is refused."""
    cfg, serve = reduced_cfg(), base.ServeConfig()
    if which == "model":
        cfg = dataclasses.replace(cfg, **{field: value})
    else:
        serve = dataclasses.replace(serve, **{field: value})
        if field in ("prefix_cache", "chunked_prefill"):
            cfg = dataclasses.replace(cfg, decode_streaming="frozen")
    alone = ServeEngine(cfg, weights[2], serve=serve, device="cpu")
    assert alone.telemetry.enabled == (field == "telemetry")
    eng = ServeEngine(cfg, weights[2], serve=dataclasses.replace(serve, telemetry=True),
                      device="cpu")
    assert eng.telemetry.enabled and eng.sched.registry is eng.telemetry.metrics
    assert set(eng.stats()) - set(alone.stats()) <= {"telemetry", "flight",
                                                      "program_shapes"}


@pytest.mark.parametrize("field", ["moe", "mla"])
def test_engine_still_refuses_telemetry_and_other_families(weights, field):
    """Telemetry constructs (``ServeConfig(telemetry=True)`` is served);
    the dense family with MoE or MLA flags set is still refused."""
    eng = ServeEngine(reduced_cfg(), weights[2], serve=base.ServeConfig(telemetry=True),
                      device="cpu")
    assert eng.stats()["program_shapes"]["decode_tick"] == 0
    with pytest.raises(NotImplementedError, match="family"):
        ServeEngine(dataclasses.replace(reduced_cfg(), **{field: True}), weights[2],
                    serve=base.ServeConfig(telemetry=True), device="cpu")


def test_engine_refuses_an_unknown_family(weights):
    """Every family of the reference's engine is served (``xlstm``,
    ``whisper`` and ``llava`` in ``tests/test_torch_xlstm.py``,
    ``_whisper.py``, ``_vlm.py``); a family string the reference does not
    know is refused at construction, as are its cache specs and decode
    step."""
    from repro_torch.serve import decode, kv_cache

    cfg = dataclasses.replace(reduced_cfg(), family="rwkv")
    with pytest.raises(NotImplementedError, match="family 'rwkv'"):
        ServeEngine(cfg, weights[2], device="cpu")
    with pytest.raises(NotImplementedError, match="unknown family"):
        kv_cache.cache_specs(cfg, 1, 64)
    with pytest.raises(NotImplementedError, match="unknown family"):
        decode.decode_step(weights[2], cfg, {}, torch.zeros((1, 1), dtype=torch.long),
                           seq_max=64)


def test_engine_refuses_head_dims_past_the_kernels_on_cuda(weights, monkeypatch):
    """On CUDA a config whose kernel-facing head dims exceed a serving
    kernel's own limit (K1, K2, K5: d 576, dv 512) is refused at
    construction, before any weight reaches the device (the device check
    is patched, so no card is needed): GQA's head dim, and MLA's kv_lora +
    rope keys and kv_lora values. DeepSeek-V2-Lite's own 576 / 512 pass
    the check."""
    from repro_torch.serve.engine import _check_supported, kernel_head_dims

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = dataclasses.replace(reduced_cfg(), head_dim=580)
    with pytest.raises(NotImplementedError, match=r"head dims \(d=580, dv=580\) past"):
        ServeEngine(cfg, weights[2], device="cuda")
    deepseek = get_config("deepseek-v2-lite-16b")
    assert kernel_head_dims(deepseek) == (576, 512)
    _check_supported(deepseek, base.ServeConfig(), torch.device("cuda"))
    wide = dataclasses.replace(deepseek, rope_head_dim=128)
    with pytest.raises(NotImplementedError, match=r"head dims \(d=640, dv=512\) past"):
        _check_supported(wide, base.ServeConfig(), torch.device("cuda"))


@pytest.mark.parametrize("cls", ["ModelConfig", "ServeConfig", "TrainConfig",
                                 "ShapeConfig"])
def test_config_fields_and_defaults_mirror_jax(cls):
    ours = {f.name: f.default for f in dataclasses.fields(getattr(base, cls))}
    ref = {f.name: f.default for f in dataclasses.fields(getattr(jbase, cls))}
    assert ours == ref


def test_shape_presets_and_remat_defaults_mirror_jax():
    assert ({k: dataclasses.asdict(v) for k, v in base.SHAPE_PRESETS.items()}
            == {k: dataclasses.asdict(v) for k, v in jbase.SHAPE_PRESETS.items()})
    assert base.REMAT_DEFAULTS == jbase.REMAT_DEFAULTS
    for remat in ("none", "full", "dots", "ss_stats", "auto"):
        for backend in ("cpu", "gpu", "tpu"):
            assert (base.resolve_remat(remat, backend)
                    == jbase.resolve_remat(remat, backend))


def test_reduced_and_registry_mirror_jax():
    ours = dataclasses.asdict(base.reduced(get_config("qwen2-7b")))
    assert ours == dataclasses.asdict(jbase.reduced(jget_config("qwen2-7b")))
    assert dataclasses.asdict(get_config("qwen2-7b")) == dataclasses.asdict(
        jget_config("qwen2-7b"))


def test_serve_config_validation_mirrors_jax():
    for bad in (dict(max_seq=100, block_size=16), dict(prefill_impl="x"),
                dict(decode_impl="x"), dict(prefill_chunk_tokens=0)):
        with pytest.raises(ValueError):
            jbase.ServeConfig(**bad)
        with pytest.raises(ValueError):
            base.ServeConfig(**bad)


def test_port_imports_neither_jax_nor_the_reference():
    script = """
import json, pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "leaks": sorted(
    m for m in sys.modules if m == "jax" or m.startswith("jax.")
    or m == "repro" or m.startswith("repro."))}))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.engine" in result["modules"]
    assert "repro_torch.serve.chaos" in result["modules"]
    assert "repro_torch.launch.serve" in result["modules"]
    assert "repro_torch.train.trainer" in result["modules"]
    assert "repro_torch.launch.train" in result["modules"]
    assert "repro_torch.models.moe" in result["modules"]
    assert "repro_torch.configs.deepseek_v2_lite_16b" in result["modules"]
    for module in ("", ".metrics", ".tracing", ".flight", ".monitors", ".provenance",
                   ".export", ".accounting"):
        assert f"repro_torch.telemetry{module}" in result["modules"]
    assert result["leaks"] == []


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Alone (no repo around it) and in a checkout without a card,
    ``chip_smoke.py`` exits non-zero and prints no result line."""
    root = os.path.join(os.path.dirname(__file__), "..")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(root, "chip_smoke.py")).read())
    for cwd, path in ((root, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run([sys.executable, path], capture_output=True,
                              text=True, cwd=cwd, timeout=120,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
