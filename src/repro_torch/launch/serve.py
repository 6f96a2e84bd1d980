"""Serving launcher: the port's engine on random weights, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --prompt-lens 48,200,333,480 --max-new 16

serves a full-width model (``--arch``: qwen2-7b, the default, granite-20b,
deepseek-v2-lite-16b, absorbed MLA with an MoE feed-forward, hymba-1.5b,
GQA and a mamba SSM in parallel, or xlstm-350m, attention-free, both of
which prefill by token replay whatever the flags, as in the reference; or
llava-next-34b's decoder, text prompts only; whisper-base is refused, as
the reference's launcher refuses it: its decoder needs encoder features;
every layer unless ``--layers`` cuts depth; bf16 working weights drawn
from a seeded ``torch.Generator``) through
``ServeConfig(prefill_impl="ss_fused", decode_impl="paged")`` and prints
requests finished, tokens, tok/s, TTFT, the route and the launch count of
each kernel. ``--prefill-impl``,
``--decode-impl``, ``--block-size`` and ``--no-paged`` pick another
route (``--prefill-impl replay --decode-impl gather`` is the reference's
default ``ServeConfig()``). ``--chunk-tokens N`` switches to the
continuous-batching tick with prompt chunks of N tokens (0, the default,
keeps the two-phase engine) and ``--prefix-cache`` turns on the prefix
cache (which rides the chunked tick); the summary then gives the ms per
tick of ticks that ran chunks and of ticks that did not, apart.
``--decode-streaming exact|frozen|recompute`` picks the decode state's
policy (default exact); under frozen the summary adds the boundary
rebases and their ms each. ``--telemetry-dir DIR`` serves with
``ServeConfig(telemetry=True)`` and writes ``DIR/telemetry.jsonl`` (the
metrics, tick spans and flight lifelines) and ``DIR/trace.json`` (a
Perfetto / chrome://tracing trace of the spans, the request lifelines and
the pool's counter tracks), and prints the mean ms of each span.
``--reduced`` serves the reduced test config, ``--device cpu`` runs the
kernels' plain versions instead. Weights and prompts come from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig, reduced
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.model import model_specs, torch_dtype
from repro_torch.models.params import init_params
from repro_torch.serve.engine import Request, ServeEngine, resolve_device


def random_params(cfg: ModelConfig, seed: int, device):
    """Weights of ``cfg`` drawn from a seeded generator on ``device``,
    directly in the working dtype (no fp32 master copy is kept)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(model_specs(cfg), gen,
                       dtype=torch_dtype(cfg.compute_dtype), device=device)


def serve_requests(engine: ServeEngine, prompt_lens, max_new: int,
                   seed: int) -> dict:
    """Submit one random prompt per length, drive the engine to completion
    and return a summary (counts reset just before the run, read after)."""
    rng = np.random.default_rng(seed)
    vocab = engine.cfg.vocab_size
    for uid, n in enumerate(prompt_lens):
        engine.submit(Request(uid, rng.integers(3, vocab, size=n).tolist(),
                              max_new_tokens=max_new))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    outputs = engine.run()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    stats = engine.stats()
    tokens = sum(len(v) for v in outputs.values())
    return {"requests": len(prompt_lens), "finished": len(outputs),
            "tokens": tokens, "seconds": dt, "tok_per_s": tokens / dt,
            "ttft_s": stats["ttft_s"], "preemptions": stats["preemptions"],
            "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
            "decode_ticks": stats["decode_ticks"], "launches": counts,
            "mode": stats["mode"], "decode_impl": stats["decode_impl"],
            "chunks": stats["chunks"], "chunk_ticks": stats["chunk_ticks"],
            "chunk_tick_s": stats["chunk_tick_s"], "plain_ticks": stats["plain_ticks"],
            "plain_tick_s": stats["plain_tick_s"], "parked": stats["parked"],
            "cow_copies": stats["cow_copies"], "prefix": stats.get("prefix"),
            "rebases": stats.get("rebases"), "rebase_s": stats.get("rebase_s"),
            "outputs": outputs}


def tick_summary(out: dict) -> str:
    """The engine's decode route and timing, in words: for the chunked
    tick the ms per tick of ticks that ran chunks and of the rest apart,
    else the whole-prompt prefill seconds and the decode ticks; under
    frozen streaming also the boundary rebases and their ms each."""
    if out["mode"].endswith("chunked-prefill"):
        chunk_ms = 1e3 * out["chunk_tick_s"] / max(out["chunk_ticks"], 1)
        plain_ms = 1e3 * out["plain_tick_s"] / max(out["plain_ticks"], 1)
        text = (f"{out['chunks']} chunks; {out['chunk_ticks']} ticks with chunks "
                f"{chunk_ms:.1f} ms per tick, {out['plain_ticks']} ticks without "
                f"{plain_ms:.1f} ms per tick")
        if out["prefix"] is not None:
            text += f"; prefix {out['prefix']}, cow_copies={out['cow_copies']}"
    else:
        text = (f"prefill {out['prefill_s']:.3f}s, {out['decode_ticks']} decode ticks "
                f"{out['decode_s']:.3f}s")
    if out["rebases"] is not None:
        text += (f", {out['rebases']} rebases "
                 f"{1e3 * out['rebase_s'] / max(out['rebases'], 1):.2f} ms each")
    return text


# Device-activity categories of ``profile_top``, by kernel-name fragment
# (the port's kernels by their ``csrc`` names), first match wins.
PROFILE_GROUPS = (
    ("port kernels", ("landmark_summary", "query_side", "paged_row_stats",
                      "ls_bwd_", "qs_bwd_")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copies", ("memcpy", "memset")),
    ("elementwise/reduce", ("elementwise", "reduce", "softmax", "index", "scatter")),
)


def profile_top(prof, wall_s: float, limit: int = 12) -> str:
    """One line: the device's busy share of ``wall_s``, its busy ms by
    category (PROFILE_GROUPS, the rest as "other"), the port kernels' busy
    ms by name (a kernel and its merge launch together), and its ``limit``
    costliest device activities (kernels, copies; ms) in a torch.profiler
    run."""
    from torch.autograd import DeviceType

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    def group(name):
        name = name.lower()
        return next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                    "other")

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=dev_ms, reverse=True)
    busy = sum(dev_ms(e) for e in rows) / 1e3
    groups: dict[str, float] = {}
    for e in rows:
        groups[group(e.key)] = groups.get(group(e.key), 0.0) + dev_ms(e)
    top = {e.key[:60]: round(dev_ms(e), 3) for e in rows[:limit]}
    port = {}
    for e in rows:
        name = next((k for k in PROFILE_GROUPS[0][1] if k in e.key.lower()), None)
        if name is not None:
            port[name] = round(port.get(name, 0.0) + dev_ms(e), 3)
    return (f"device busy {busy:.3f}s of {wall_s:.3f}s wall "
            f"({100 * busy / wall_s:.1f}%); busy ms by category "
            f"{ {g: round(ms, 3) for g, ms in groups.items()} }; port kernels' "
            f"ms by name {port}; top self device ms: {top}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (width is never cut)")
    ap.add_argument("--prompt-lens", default="48,200,333,480")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prefill-impl", default="ss_fused", choices=("ss_fused", "replay"))
    ap.add_argument("--decode-impl", default="paged", choices=("paged", "gather"))
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--no-paged", action="store_true",
                    help="lane-dense K/V storage (ServeConfig(paged=False))")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="chunked prefill inside the decode tick, N tokens a "
                         "chunk (0: the two-phase engine)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="the prefix cache (ServeConfig(prefix_cache=True))")
    ap.add_argument("--decode-streaming", default="exact",
                    choices=("exact", "frozen", "recompute"),
                    help="ModelConfig.decode_streaming: frozen streams every "
                         "landmark row and rebases at segment boundaries")
    ap.add_argument("--telemetry-dir", default="",
                    help="serve with telemetry on and write telemetry.jsonl and "
                         "trace.json (Perfetto) here")
    ap.add_argument("--profile", action="store_true",
                    help="run under torch.profiler and print the device's "
                         "busy share of that same run and its costliest "
                         "operations")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch),
                              decode_streaming=args.decode_streaming)
    if cfg.family == "audio":
        raise SystemExit("whisper serving needs encoder features (the reference's "
                         "launcher refuses it too)")
    device = resolve_device(args.device)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    serve = ServeConfig(max_lanes=args.lanes, max_seq=args.max_seq,
                        block_size=args.block_size, paged=not args.no_paged,
                        prefill_impl=args.prefill_impl, decode_impl=args.decode_impl,
                        chunked_prefill=args.chunk_tokens > 0,
                        prefill_chunk_tokens=args.chunk_tokens or 64,
                        prefix_cache=args.prefix_cache,
                        telemetry=bool(args.telemetry_dir))
    engine = ServeEngine(cfg, random_params(cfg, 0, device),
                         serve=serve, device=device)
    lens = [int(x) for x in args.prompt_lens.split(",")]
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = serve_requests(engine, lens, args.max_new, seed=0)
        print(f"[serve] profile: {profile_top(prof, out['seconds'])}")
    else:
        out = serve_requests(engine, lens, args.max_new, seed=0)
    ttft = out["ttft_s"]
    print(f"[serve] {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"on {device}: {out['finished']}/{out['requests']} requests, "
          f"{out['tokens']} tokens in {out['seconds']:.3f}s "
          f"({out['tok_per_s']:.1f} tok/s), TTFT mean "
          f"{np.mean(ttft) * 1e3:.1f} ms max {np.max(ttft) * 1e3:.1f} ms, "
          f"{tick_summary(out)}, preemptions={out['preemptions']}, "
          f"route {out['mode']} / {out['decode_impl']} decode, "
          f"launches={out['launches']}")
    if args.telemetry_dir:
        import os

        from repro_torch.telemetry import write_chrome_trace

        os.makedirs(args.telemetry_dir, exist_ok=True)
        tel = engine.telemetry
        n = tel.dump_jsonl(os.path.join(args.telemetry_dir, "telemetry.jsonl"))
        events = write_chrome_trace(os.path.join(args.telemetry_dir, "trace.json"), tel)
        spans = tel.metrics.snapshot().get("span_seconds", {})
        means = {k.split("=", 1)[1]: round(1e3 * v["sum"] / v["count"], 3)
                 for k, v in spans.items()}
        print(f"[serve] telemetry: {n} JSONL lines and a trace of {events} events in "
              f"{args.telemetry_dir}; span mean ms {means}")
    return out


if __name__ == "__main__":
    main()
