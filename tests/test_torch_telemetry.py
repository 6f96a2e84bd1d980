"""The port's telemetry package (``repro_torch.telemetry``: metrics,
tracing, flight, monitors, provenance, export, accounting and the
``Telemetry`` bundle) against the reference's ``repro.telemetry``, on the
CPU.

The unit cases of ``tests/test_telemetry.py`` and
``tests/test_flight_trace.py`` are replayed through both packages: each
case runs on each package, holds that package to the reference test's
own asserts, and returns what it built; the two results must be equal
(``snapshot()``s, traces, JSONL lines). Where a case records time, a
shared fake ``time.perf_counter`` makes the timestamps equal too. The
reference's XLA compile
detector is replayed through ``ProgramAccounting``: a call sequence's
first-seen argument signatures equal the jit cache misses of the same
sequence. The engine, scheduler, prefix cache, chaos, trainer and
launcher wiring are in ``tests/test_torch_telemetry_engine.py``.
"""
from __future__ import annotations

import dataclasses
import io
import itertools
import json
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import telemetry as jtel  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.telemetry import accounting as jacct  # noqa: E402
from repro.telemetry import flight as jflight  # noqa: E402
from repro.telemetry import metrics as jmetrics  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.telemetry import accounting  # noqa: E402
from repro_torch.telemetry import flight  # noqa: E402
from repro_torch.telemetry import metrics  # noqa: E402

# side -> (the package, its metrics module, its flight module)
SIDES = {"port": (tel, metrics, flight), "jax": (jtel, jmetrics, jflight)}


class FakeClock:
    """A deterministic ``time.perf_counter``: 1 ms a call from 0."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._ticks = itertools.count()

    def __call__(self):
        return next(self._ticks) * 1e-3


@pytest.fixture
def fake_clock(monkeypatch):
    """One fake clock for both packages' tracers and flight recorders;
    ``_on_both`` restarts it before each side."""
    clock = FakeClock()
    monkeypatch.setattr("time.perf_counter", clock)
    return clock


def _on_both(fn, clock=None):
    """Run ``fn(side)`` for the port and the reference (``clock``, if
    given, restarted before each); both must pass their asserts and return
    the same value."""
    results = []
    for side in ("port", "jax"):
        if clock is not None:
            clock.reset()
        results.append(fn(side))
    assert results[0] == results[1]
    return results[0]


# ==========================================================================
# metrics.py
# ==========================================================================
def test_buckets_mirror_the_reference():
    assert metrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert metrics.TICK_BUCKETS == jmetrics.TICK_BUCKETS
    assert metrics.RATIO_BUCKETS == jmetrics.RATIO_BUCKETS

    def case(side):
        m = SIDES[side][1]
        b = m.exp_buckets(1.0, 1000.0, per_decade=3)
        assert b[0] == 1.0 and b[-1] >= 1000.0
        assert np.allclose(np.diff(np.log10(b)), 1 / 3)
        with pytest.raises(ValueError):
            m.exp_buckets(0.0, 1.0)
        return b

    _on_both(case)


def test_histogram_bucket_math_and_percentiles():
    def case(side):
        m = SIDES[side][1]
        h = m.Histogram(bounds=(1.0, 2.0, 4.0, 8.0))
        for v in (0.5, 1.0, 1.5, 3.0, 100.0):
            h.observe(v)
        assert h.counts == [2, 1, 1, 0, 1]
        assert h.count == 5 and h.sum == pytest.approx(106.0)
        assert h.mean == pytest.approx(21.2)
        h1 = m.Histogram(bounds=tuple(float(i) for i in range(1, 65)))
        assert h1.percentile(50) is None
        for v in [1] * 50 + [10] * 40 + [60] * 10:
            h1.observe(v)
        assert (h1.percentile(50), h1.percentile(90), h1.percentile(99)) == (1.0, 10.0, 60.0)
        h2 = m.Histogram(bounds=m.TICK_BUCKETS)
        for _ in range(7):
            h2.observe(30)
        assert h2.percentile(50) == 30.0 == h2.percentile(99)
        h3 = m.Histogram(bounds=(1.0, 2.0))
        h3.observe(99.0)
        assert h3.percentile(50) == 2.0
        with pytest.raises(ValueError):
            m.Histogram(bounds=(2.0, 1.0))
        return [h.sample(), h1.sample(), h2.sample(), h3.sample(), h.counts, h1.counts]

    _on_both(case)


def test_registry_families_and_kinds():
    def case(side):
        r = SIDES[side][1].MetricsRegistry()
        c = r.counter("reqs_total", labels=("impl",))
        c.labels(impl="paged").inc(2)
        c.labels(impl="gather").inc()
        assert c.labels(impl="paged").value == 2.0
        with pytest.raises(ValueError):
            c.labels(wrong="x")
        assert r.counter("reqs_total", labels=("impl",)) is c
        with pytest.raises(ValueError):
            r.gauge("reqs_total")
        r.gauge("depth", fn=lambda: 7.0)
        g = r.gauge("set_gauge")
        g.set(3)
        r.histogram("lat", labels=("span",), buckets=(0.1, 1.0)).labels(span="x").observe(0.5)
        snap = r.snapshot()
        assert snap["reqs_total"]["impl=paged"]["value"] == 2.0
        assert snap["depth"]["value"] == 7.0
        return snap, list(r.iter_samples())

    _on_both(case)


def test_null_registry_emits_nothing():
    def case(side):
        m = SIDES[side][1]
        r = m.NullRegistry()
        c = r.counter("x")
        c.inc(5)
        h = r.histogram("h", buckets=(1.0,))
        h.observe(3)
        assert c.value == 0.0 and h.percentile(50) is None
        assert r.snapshot() == {} and list(r.iter_samples()) == []
        assert c.labels(anything="goes") is c and r.get("x") is None
        return r.snapshot()

    _on_both(case)


# ==========================================================================
# tracing.py and the Telemetry bundle
# ==========================================================================
def test_span_nesting_and_jsonl_roundtrip(fake_clock):
    def case(side):
        pkg = SIDES[side][0]
        r = pkg.MetricsRegistry()
        tr = pkg.Tracer(r)
        with tr.span("tick", lane=0):
            with tr.span("inner"):
                pass
        with tr.span("tick", lane=1):
            pass
        assert len(tr.events) == 3
        assert tr.events[0]["name"] == "inner" and tr.events[0]["depth"] == 1
        assert tr.events[1]["dur_s"] >= tr.events[0]["dur_s"]
        fh = io.StringIO()
        assert tr.dump_jsonl(fh) == 3
        lines = [json.loads(x) for x in fh.getvalue().splitlines()]
        assert all(line["kind"] == "span" for line in lines)
        assert lines[1]["labels"] == {"lane": 0}
        assert r.get("span_seconds").labels(span="tick").count == 2
        return lines, r.snapshot()

    _on_both(case, fake_clock)


def test_tracer_bounded_buffer():
    def case(side):
        tr = SIDES[side][0].Tracer(max_events=2)
        for _ in range(4):
            with tr.span("x"):
                pass
        assert len(tr.events) == 2 and tr.dropped == 2
        return tr.summary()

    assert _on_both(case) == {"events": 2, "dropped": 2}


def test_null_tracer_and_disabled_telemetry(tmp_path):
    def case(side):
        pkg = SIDES[side][0]
        nt = pkg.NullTracer()
        with nt.span("a"), nt.step_span("s", 3):
            pass
        assert nt.summary()["events"] == 0 and nt.dump_jsonl(io.StringIO()) == 0
        t = pkg.Telemetry(enabled=False)
        with t.span("x"):
            pass
        t.stamp_provenance(jbase.ServeConfig())
        p = tmp_path / f"{side}.jsonl"
        assert t.dump_jsonl(p) == 0 and not p.exists()
        assert t.meta_defaults == {}
        assert not t.flight.enabled and t.flight.lifelines() == []
        return t.snapshot(), pkg.null_telemetry().snapshot()

    assert _on_both(case)[0] == {"metrics": {}, "spans": {"events": 0, "dropped": 0}}


def test_annotated_spans_reach_the_torch_profiler(tmp_path):
    """``annotate=True`` wraps each span in ``record_function`` (a step
    span as ``name#step``), so the names appear among the profiler's
    events; ``profile_session`` writes the profiler's Chrome trace."""
    t = tel.Telemetry(annotate=True)
    with tel.profile_session(str(tmp_path), name="trace.json") as prof:
        with t.span("serve_tick"):
            with t.span("decode_dispatch", lanes=2):
                torch.ones(8).sum()
        with t.step_span("train_step", 3):
            torch.ones(4).mul(2)
    names = {e.name for e in prof.events()}
    assert {"serve_tick", "decode_dispatch", "train_step#3"} <= names
    assert [e["name"] for e in t.tracer.events] == ["decode_dispatch", "serve_tick",
                                                    "train_step"]
    assert t.tracer.events[-1]["labels"] == {"step": 3}
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert "serve_tick" in {e.get("name") for e in trace["traceEvents"]}


# ==========================================================================
# flight.py
# ==========================================================================
def test_decode_and_chunk_runs_coalesce(fake_clock):
    def case(side):
        fl = SIDES[side][2].FlightRecorder()
        fl.record(7, "submit", prompt_len=5)
        for tick in range(10, 15):
            fl.record(7, "decode", tick=tick, pos=tick - 4)
        line = fl.lifeline(7)
        assert line.kinds() == ["submit", "decode"]
        run = line.events[-1]
        assert (run["tick0"], run["tick1"], run["pos0"], run["pos1"], run["n"]) == (
            10, 14, 6, 10, 5)
        fl.record(7, "decode", tick=20, pos=11)
        assert line.kinds() == ["submit", "decode", "decode"]
        for tick, chunk in ((30, 0), (31, 1), (33, 2)):
            fl.record(8, "prefill_chunk", tick=tick, chunk=chunk, tok0=16 * chunk,
                      tok1=16 * chunk + 16, lane=1)
        assert [e.get("chunk1") for e in fl.lifeline(8).events] == [1, 2]
        return [ln.events for ln in fl.lifelines()], fl.summary()

    _on_both(case, fake_clock)


def test_ring_buffer_eviction_and_event_cap(fake_clock):
    def case(side):
        m = SIDES[side][1]
        reg = m.MetricsRegistry()
        fl = SIDES[side][2].FlightRecorder(max_requests=4, max_events=8, registry=reg)
        for uid in range(10):
            fl.record(uid, "submit", prompt_len=1)
        assert [ln.uid for ln in fl.lifelines()] == [6, 7, 8, 9]
        assert fl.summary()["evicted_requests"] == 6
        for tick in range(0, 40, 2):
            fl.record(9, "decode", tick=tick, pos=tick)
        line = fl.lifeline(9)
        assert len(line.events) == 8 and line.dropped == 20 - 7
        assert fl.summary()["dropped_events"] == line.dropped
        assert reg.snapshot()["flight_events_dropped_total"]["value"] == line.dropped
        fh = io.StringIO()
        assert fl.dump_jsonl(fh) == 4
        return reg.snapshot(), fh.getvalue()

    _on_both(case, fake_clock)


def test_counter_samples_bounded_and_null_recorder(fake_clock):
    def case(side):
        fm = SIDES[side][2]
        fl = fm.FlightRecorder(max_counter_samples=16)
        for i in range(100):
            fl.counter_sample("queue_depth", i)
        samples = fl.counters["queue_depth"]
        assert len(samples) == 16 and samples[-1][1] == 99.0
        null = fm.NullFlightRecorder()
        null.record(1, "submit")
        null.counter_sample("x", 1.0)
        assert not null.enabled and null.lifelines() == [] and null.lifeline(1) is None
        assert null.dump_jsonl(io.StringIO()) == 0
        return list(samples), null.summary()

    _on_both(case, fake_clock)


# ==========================================================================
# monitors.py
# ==========================================================================
def test_drift_residual_and_monitor_match_the_reference():
    """``bv_row_residual`` on the reference's own frozen-mode protocol
    (``tests/test_telemetry.py:test_drift_probe_matches_offline_rebase_numbers``):
    at every segment boundary the port's residual on the pre / post stats
    equals the reference's and the offline formula's."""
    from repro.serve.decode_state import (landmark_counts, landmark_means, rebase_rows,
                                          recompute_stats, segment_len, stream_append)

    B, H, S, D, C = 1, 2, 32, 8, 8
    seg = segment_len(S, C)
    scale = D ** -0.5
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    q = jax.random.normal(ks[0], (B, H, S, D)) * 0.5
    k, v = q, jax.random.normal(ks[2], (B, H, S, D))
    stats = (jnp.zeros((B, H, C, 1)), jnp.zeros((B, H, C, 1)), jnp.zeros((B, H, C, D)))
    q_sums = jnp.zeros((B, H, C, D))
    checked = []
    for t in range(S):
        onehot = jax.nn.one_hot(t // seg, C, dtype=jnp.float32)
        q_sums = q_sums + onehot[:, None] * q[:, :, t][:, :, None, :]
        counts = landmark_counts(jnp.asarray(t), S, C)
        q_l = landmark_means(q_sums, counts)
        active = t // seg
        stats = stream_append(stats, q_l, k[:, :, t], v[:, :, t], scale,
                              row_mask=jnp.arange(C) <= active)
        if t > 0 and t % seg == 0:
            rows = [max(active - 1, 0), active]
            pre = tuple(np.asarray(x) for x in stats)
            stats = rebase_rows(stats, q_l, k, v, t, scale, jnp.stack(rows))
            post = tuple(np.asarray(x) for x in stats)
            ours = tel.bv_row_residual((pre[1], pre[2]), (post[1], post[2]), rows)
            ref = jtel.bv_row_residual((pre[1], pre[2]), (post[1], post[2]), rows)
            _, l_r, acc_r = recompute_stats(q_l, k, v, t, scale, row_valid=counts > 0)
            bv_f = pre[2] / np.maximum(pre[1], 1e-30)
            bv_e = np.asarray(acc_r) / np.maximum(np.asarray(l_r), 1e-30)
            per_row = np.linalg.norm(bv_f - bv_e, axis=-1) / np.maximum(
                np.linalg.norm(bv_e, axis=-1), 1e-30)
            assert ours == ref == pytest.approx(float(np.max(per_row[..., rows])), rel=1e-5)
            # the engine hands the probe only the two rows, re-indexed 0, 1
            sliced = tel.bv_row_residual((pre[1][..., rows, :], pre[2][..., rows, :]),
                                         (post[1][..., rows, :], post[2][..., rows, :]),
                                         range(len(rows)))
            assert sliced == ours
            checked.append(ours)
    assert len(checked) >= 2
    np.testing.assert_array_equal(tel.bv_from_stats(pre[1], pre[2]),
                                  jtel.bv_from_stats(pre[1], pre[2]))

    def case(side):
        pkg = SIDES[side][0]
        r = pkg.MetricsRegistry()
        mon = pkg.DriftMonitor(r)
        for x in checked + [0.01, 0.02]:
            mon.observe(x)
        assert r.get("drift_rebase_residual").count == len(checked) + 2
        assert r.get("drift_rebase_residual_last").value == 0.02
        return r.snapshot()

    _on_both(case)


def test_spectrum_mass_and_monitor_match_the_reference():
    C = 8
    m, l = np.zeros((1, C, 1)), np.ones((1, C, 1))
    assert tel.spectrum_mass(m, l, reached=C) == pytest.approx((1 / C, 1.0))
    l1 = np.full((1, C, 1), 1e-12)
    l1[0, 3, 0] = 1.0
    top1, eff = tel.spectrum_mass(m, l1, reached=C)
    assert top1 == pytest.approx(1.0, abs=1e-6) and eff == pytest.approx(1 / C, rel=1e-3)
    rng = np.random.default_rng(0)
    draws = [(rng.normal(size=(2, 4, C, 1)), rng.uniform(0.1, 2, size=(2, 4, C, 1)), r)
             for r in (1, 3, C, 2 * C)]
    for mm, ll, reached in draws:
        assert tel.spectrum_mass(mm, ll, reached) == jtel.spectrum_mass(mm, ll, reached)

    def case(side):
        pkg = SIDES[side][0]
        r = pkg.MetricsRegistry()
        mon = pkg.SpectrumMonitor(r)
        for mm, ll, reached in draws:
            mon.observe(mm, ll, reached)
        return r.snapshot()

    _on_both(case)


# ==========================================================================
# provenance.py
# ==========================================================================
@pytest.mark.parametrize("make", [
    lambda b: (b.ServeConfig(max_lanes=2, max_seq=64, block_size=8, telemetry=True),),
    lambda b: (b.ModelConfig(), b.ServeConfig()),
    lambda b: (b.TrainConfig(), b.ShapeConfig("t", 64, 2, "train")),
], ids=["serve", "model+serve", "train+shape"])
def test_config_hash_equals_the_reference(make):
    """The port's configs have the reference's fields, so the same values
    hash to the same digest; the hash follows content, not identity."""
    ours, ref = make(base), make(jbase)
    assert tel.config_hash(*ours) == jtel.config_hash(*ref)
    assert len(tel.config_hash(*ours)) == 12
    assert tel.config_hash(*ours) == tel.config_hash(*(dataclasses.replace(c) for c in ours))
    bumped = (dataclasses.replace(ours[0], **{dataclasses.fields(ours[0])[0].name: 7}),
              *ours[1:])
    assert tel.config_hash(*bumped) != tel.config_hash(*ours)


def test_provenance_stamp():
    sha = tel.git_sha()
    assert sha == jtel.git_sha()
    assert sha == "unknown" or len(sha) == 40
    serve = base.ServeConfig()
    p = tel.provenance(serve)
    assert p["torch"] == torch.__version__ and p["cuda"] == torch.version.cuda
    assert p["git_sha"] == sha and p["config_hash"] == tel.config_hash(serve)
    assert "device" not in tel.provenance(serve, device="cpu") and "jax" not in p
    assert "config_hash" not in tel.provenance()
    t = tel.Telemetry()
    t.stamp_provenance(serve, device=torch.device("cpu"))
    assert t.meta_defaults == tel.provenance(serve)


def test_provenance_of_a_cpu_run_leaves_cuda_uninitialised():
    """A CPU engine stamps provenance without initialising CUDA (checked
    in a fresh process)."""
    import os
    import sys

    script = ("import torch; from repro_torch.telemetry import provenance; "
              "provenance(device='cpu'); print(torch.cuda.is_initialized())")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=src), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_git_sha_degrades_on_hung_git(monkeypatch):
    def hang(*a, **k):
        raise subprocess.TimeoutExpired(cmd=a[0], timeout=k.get("timeout", 10))

    monkeypatch.setattr(subprocess, "run", hang)
    monkeypatch.delenv("GITHUB_SHA", raising=False)
    tel.git_sha.cache_clear()
    try:
        assert tel.git_sha() == "unknown"
        monkeypatch.setenv("GITHUB_SHA", "f" * 40)
        tel.git_sha.cache_clear()
        assert tel.git_sha() == "f" * 40
    finally:
        tel.git_sha.cache_clear()


# ==========================================================================
# export.py and the JSONL dump
# ==========================================================================
def _bundle(pkg):
    """A Telemetry bundle with spans, a full lifeline vocabulary and counter
    tracks, recorded under the fake clock."""
    t = pkg.Telemetry()
    fl = t.flight
    with t.span("serve_tick"):
        with t.span("admit"):
            fl.record(0, "submit", prompt_len=12, tick=0)
            fl.record(1, "submit", prompt_len=30, tick=0)
            fl.record(2, "reject", tick=0, queue_depth=2, retry_after_ticks=2)
            fl.record(0, "admit", lane=0, tick=1, queued_ticks=1)
        with t.span("prefill", lane=0):
            fl.record(0, "prefill_start", bucket=16, lane=0, tick=1)
            fl.record(0, "prefill_end", bucket=16)
    for tick in range(2, 5):
        with t.span("serve_tick"):
            with t.span("decode_dispatch", lanes=1):
                fl.record(0, "decode", tick=tick, pos=11 + tick)
            fl.record(1, "prefill_chunk", tick=tick, chunk=tick - 2, tok0=8 * (tick - 2),
                      tok1=8 * (tick - 1), lane=1)
            fl.counter_sample("queue_depth", 4 - tick)
            fl.counter_sample("pool_blocks_used", tick)
    fl.record(1, "prefix_attach", tick=5, lane=1, blocks=2, tokens=16, mode="partial")
    fl.record(1, "cow", tick=5, src=3, dst=7)
    fl.record(0, "rebase", tick=5, pos=16)
    fl.record(1, "preempt", lane=1, tick=6, parked=True)
    fl.record(1, "requeue", tick=6)
    fl.record(1, "park_drop", tick=7)
    fl.record(0, "quarantine", tick=7, lane=0, trips=1)
    fl.record(0, "demote", tick=8, trips=2)
    fl.record(-1, "chaos", tick=8, site="drop_sample", lane=0, ordinal=0, detail="")
    fl.record(-1, "watchdog", tick=9, stall_ticks=4, rung=0)
    fl.record(0, "finish", tick=9, tokens=6, latency_ticks=9)
    fl.record(1, "cancel", tick=10)
    fl.record(3, "submit", prompt_len=4, tick=10)
    fl.record(3, "deadline", tick=12)
    fl.record(2, "submit", prompt_len=9, tick=12)  # the rejected uid, resubmitted
    fl.record(2, "cancel", tick=13)
    t.metrics.counter("serve_ticks_total").inc(4)
    return t


def test_chrome_trace_equals_the_reference(fake_clock, tmp_path):
    def case(side):
        pkg = SIDES[side][0]
        t = _bundle(pkg)
        trace = pkg.chrome_trace(t, meta={"case": "test"})
        assert pkg.validate_trace(trace) == []
        assert trace["metadata"]["trace_schema"] == "repro-chrome-trace-v1"
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"queued", "prefill", "decode", "prefill_chunk", "prefix_attach", "cow",
                "preempt", "finish", "chaos", "watchdog"} <= names
        assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"} == {
            "queue_depth", "pool_blocks_used"}
        t.meta_defaults = {"stamp": "x"}
        path = tmp_path / f"{side}.json"
        n = pkg.write_chrome_trace(path, t, meta={"case": "file"})
        written = json.loads(path.read_text())
        assert n == len(written["traceEvents"]) and written["metadata"]["stamp"] == "x"
        bad = {"traceEvents": [{"ph": "E", "pid": 0, "tid": 0, "ts": 1.0},
                               {"ph": "B", "pid": 0, "tid": 0, "ts": 0.5},
                               {"ph": "B", "pid": 0, "tid": 1, "ts": "x"}]}
        return trace, written, pkg.validate_trace(bad)

    trace, _, errors = _on_both(case, fake_clock)
    assert len(errors) == 4


def test_single_instant_lifeline_trace_matches_the_reference(fake_clock):
    """A lifeline of one instant event (a uid that ``max_queue`` rejected
    and that never came back) renders its ``request`` slice as B and E at
    one timestamp, sorted E first: the reference's ``validate_trace``
    flags its own export (ROADMAP Queue 3, R3). The port's copy renders and
    flags it identically."""
    def case(side):
        t = SIDES[side][0].Telemetry()
        t.flight.record(2, "reject", tick=0, queue_depth=2, retry_after_ticks=2)
        trace = SIDES[side][0].chrome_trace(t)
        return trace, SIDES[side][0].validate_trace(trace)

    _, errors = _on_both(case, fake_clock)
    assert errors == ["event 4: E without open B on track (1, 2)",
                      "track (1, 2): 1 unclosed B events"]


def test_jsonl_dump_equals_the_reference(fake_clock, tmp_path):
    """Meta (schema, caller meta; the provenance stamp names each package's
    own framework), metric, span and flight lines: equal apart from
    timestamps (equal here as well, under the shared fake clock)."""
    def case(side):
        pkg = SIDES[side][0]
        t = _bundle(pkg)
        path = tmp_path / f"{side}.jsonl"
        n = t.dump_jsonl(path, meta={"bench": "test"})
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert n == len(lines) and lines[0]["kind"] == "meta"
        assert lines[0]["schema"] == "repro-telemetry-v1" and lines[0]["bench"] == "test"
        kinds = [line["kind"] for line in lines]
        assert kinds.count("flight") == 5 and "span" in kinds and "metric" in kinds
        return lines, t.snapshot()

    _on_both(case, fake_clock)


# ==========================================================================
# accounting.py
# ==========================================================================
def test_program_shapes_equal_jit_cache_misses():
    """The reference's detector (``TestAccounting::test_recompile_detector``)
    through ``ProgramAccounting``: the same call sequence gives as many
    first-seen signatures as the jitted function has cache misses, and
    ``program_calls_total`` its calls."""
    reg = jtel.MetricsRegistry()
    jacc = jtel.XLAAccounting(reg)
    jfn = jacc.wrap(jax.jit(lambda x: x * 2.0), "toy")
    r = tel.MetricsRegistry()
    acc = tel.ProgramAccounting(r)
    fn = acc.wrap(lambda x: x * 2.0, "toy")
    shapes = [4] + [4] * 100 + [8, 4, 8, 16]
    for n in shapes:
        jfn(jnp.ones(n))
        fn(torch.ones(n))
        assert acc.shapes("toy") == jacc.compiles("toy")
    assert acc.shapes("toy") == 3
    snap = r.snapshot()
    assert snap["program_shapes_total"]["program=toy"]["value"] == 3
    assert snap["program_calls_total"]["program=toy"]["value"] == len(shapes)
    assert snap["program_first_call_seconds"]["program=toy"]["count"] == 3
    fn(torch.ones(4, dtype=torch.float64))  # a dtype is a new signature, as in jit
    assert acc.shapes("toy") == 4


def test_signature_keys_on_shapes_and_static_args_only():
    """Host scalars are traced operands in the reference (a chunk's start,
    ``n_valid``), so they stay out of the key; lists of lane ids are a
    fixed-shape array there; the arguments named ``static`` (a view's
    block count) enter by value; nested containers and dataclasses are
    walked."""
    sig = tel.arg_signature
    t = torch.zeros(2, 3)
    assert sig((t, 5), {}) == sig((torch.ones(2, 3), 9), {})
    assert sig((t, 5), {}, static=(1,)) != sig((t, 9), {}, static=(1,))
    assert sig((np.zeros((1, 4), np.int32), [0, 2]), {}) == sig(
        (np.ones((1, 4), np.int32), [1]), {})
    assert sig(({"a": t, "b": [t, t]},), {}) != sig(({"a": t, "b": [t]},), {})
    state = jbase.ShapeConfig("t", 64, 2, "train")
    assert sig((state,), {}) == sig((dataclasses.replace(state, seq_len=8),), {})
    assert sig((), {"n": torch.zeros(3)}) != sig((), {"n": torch.zeros(4)})
    assert sig((), {"nbv": 2}, static=("nbv",)) != sig((), {"nbv": 4}, static=("nbv",))
    reg = tel.MetricsRegistry()
    acc = tel.ProgramAccounting(reg)
    calls = []
    fn = acc.wrap(lambda row, toks, start, nbv: calls.append(nbv), "chunk", static=(3,))
    for start in (0, 16, 32):
        fn(np.zeros(4, np.int32), torch.zeros(1, 16), start, 4)
    assert acc.shapes("chunk") == 1
    fn(np.zeros(4, np.int32), torch.zeros(1, 16), 48, 8)
    assert acc.shapes("chunk") == 2 and calls == [4, 4, 4, 8]


def test_kernel_builds_count_under_the_tagged_program(monkeypatch, tmp_path):
    """``kernels/build.py`` reports each ``nvcc`` build to the accounting
    hook: ``kernel_builds_total{program=}`` under the innermost
    ``tagged_program`` (``"untagged"`` outside one), ``kernel_build_seconds``
    per build; nothing is counted while the module registry is null. The
    compiler is a stand-in that writes the output file."""
    from repro_torch.kernels import build

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()

        def communicate(self):
            return "ptxas info: 0 bytes spill", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    reg = tel.MetricsRegistry()
    accounting.set_metrics(reg)
    try:
        with tel.tagged_program("decode_tick"):
            with tel.tagged_program("prefill"):
                report = build.build(("landmark_summary", "query_side"))
            assert accounting.current_program() == "decode_tick"
        build.build(("paged_row_stats",))
        build.build(("paged_row_stats",))  # built already: no nvcc, no count
    finally:
        accounting.set_metrics(None)
    assert sorted(report) == ["landmark_summary", "query_side"]
    snap = reg.snapshot()
    assert snap["kernel_builds_total"] == {"program=prefill": {"value": 2.0},
                                           "program=untagged": {"value": 1.0}}
    assert snap["kernel_build_seconds"]["count"] == 3
    for p in tmp_path.iterdir():
        p.unlink()
    build.build(("paged_row_stats",))  # the null registry again: nothing counted
    assert reg.snapshot()["kernel_builds_total"]["program=untagged"]["value"] == 1.0


def test_numerics_probe_counts_like_the_reference():
    """``TestNumericsProbe``: the same arrays through both probes (the
    port's also as torch tensors, where the count runs on the tensor's
    device) give the same counts and snapshots; integer inputs count 0."""
    m = np.zeros((2, 16), np.float32)
    m_inf = m.copy()
    m_inf[1, 3] = np.inf
    l_nan = np.ones((2, 16), np.float32)
    l_nan[0, 0] = l_nan[1, 5] = np.nan
    cases = [("landmark_m", m, 0), ("landmark_m", m_inf, 1), ("landmark_l", l_nan, 2),
             ("tokens", np.arange(8), 0)]

    def run(probe, as_tensor):
        got = []
        for site, arr, want in cases:
            x = torch.from_numpy(arr) if as_tensor else arr
            assert probe.check(site, x) == want
            got.append(probe.last_bad)
        return got

    ref_reg, reg, treg = jtel.MetricsRegistry(), tel.MetricsRegistry(), tel.MetricsRegistry()
    ref = run(jtel.NumericsProbe(ref_reg), False)
    assert run(tel.NumericsProbe(reg), False) == ref == run(tel.NumericsProbe(treg), True)
    assert reg.snapshot() == ref_reg.snapshot() == treg.snapshot()
    assert reg.snapshot()["numerics_nonfinite_total"]["site=landmark_l"]["value"] == 2
    probe = tel.NumericsProbe(tel.MetricsRegistry())
    bf16 = torch.tensor([1.0, float("inf"), float("nan")], dtype=torch.bfloat16)
    assert probe.check("x", bf16) == 2 and probe.check("i", torch.arange(3)) == 0
    assert tel.NullNumericsProbe().check("x", bf16) == 0


def test_the_port_package_mirrors_the_reference_names():
    """Module, class and function names a reader looks for in both."""
    for name in ("Telemetry", "null_telemetry", "MetricsRegistry", "NullRegistry", "Tracer",
                 "NullTracer", "FlightRecorder", "NullFlightRecorder", "DriftMonitor",
                 "SpectrumMonitor", "bv_from_stats", "bv_row_residual", "spectrum_mass",
                 "config_hash", "git_sha", "provenance", "chrome_trace", "validate_trace",
                 "write_chrome_trace", "NumericsProbe", "NullNumericsProbe",
                 "tagged_program", "LATENCY_BUCKETS", "RATIO_BUCKETS", "TICK_BUCKETS",
                 "Counter", "Gauge", "Histogram", "exp_buckets"):
        assert hasattr(tel, name) and hasattr(jtel, name), name
    assert flight.Lifeline.__slots__ == jflight.Lifeline.__slots__
    assert accounting.current_program() == jacct.current_program() == "untagged"
