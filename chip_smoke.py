#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--layers 28] [--train-layers 4]

Phases, one line each (any failure raises and exits non-zero before the
result line):

1. environment: the card's name and power limit, torch / CUDA versions,
   and the build of every kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once), with ptxas's registers and spills;
2. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes, in fp32 (TF32 off) and bf16, plus the edges of the bf16
   K1 / K3 split-key grid (c = 16 and 32, kv_valid inside the first key
   chunk, ragged, and 0; K1 at c = 128; K3's dK / dV past kv_valid exact
   zeros and its gradients bitwise identical over two launches) and of the
   bf16 K2 / K4 query-tile runs (n = 1, 63, 65, 352, 4000; c = 16, 32, 64;
   dv = 64; the F-mask with q_offset 37 / 1000; bitwise identical over two
   launches) and of the K5 split-slot grid (fp32 and bf16; kv_valid 0, 1,
   15, 16, 17, 31, 32, 33, a block's and a chunk's edge +-1, every slot
   valid; tables of 1 to 1024 slots; r = 1, 7, 8, 9, 16, 48, 64, 96;
   block sizes 8, 16, 32, 48, 64, 128 (past 32 keys a block runs as 32-key
   slices); dv = 64; NaN in every pool row the kernel must not read; the
   kv_valid-0 anchor exact; bitwise over two launches), then timed with
   CUDA events (``ms``: back-to-back calls, host included) and the
   profiler (``device_ms``) beside the plain version, the roofline bound
   (and which term binds) and one library call where there is one, with
   the kernel's share of its bound and its ratio to the library call: K1
   and K2 at the serving shape with their K/V warm in L2 (on the path they
   read what the projections just wrote), K5 cold (it rotates over pool
   copies larger than L2, as decode reads a different layer's pools at
   each launch) at the serving shape and at a 16k horizon, and at
   granite-20b's decode shape (r = 48, block 64) at 512 and 16k keys; K1
   (with stats) and K2 causal and the backward kernels K3 and K4 at the
   training shape (batch 2 x 28 heads, seq 4096), with a kv_valid case for
   K3 and a q_offset case for K4; K1 and K2 at granite-20b's prefill
   shapes (48 batch-heads, n = 256/384/512); K1 at the chunked tick's stats
   handoff (fp32 landmark means, bf16 window of 128 keys, kv_valid 48 / 77
   / 128, with stats); and K1, K2 and K5 at DeepSeek-V2-Lite's absorbed-MLA
   shapes (``mla_kernel_entries``: d = 576, dv = 512, 16 heads; K1 in bf16,
   with fp32 landmark means over bf16 keys and stats, and at the chunk
   site; K2; K5 with the latent (512) and rope (64) pools, the latent pool
   also the value pool, at the serving shape and a 16k horizon, against
   one concatenated pool and on NaN-poisoned split-slot edges), fp32 and
   bf16, timed beside their plain versions and bounds; every tiling the
   dispatch registry's measured sweeps can choose (``tiling_checks``: K1-K4
   at the training shape at block_n 256 / 512 / 1024, K1 / K2 at the
   serving shape at 256 / 512, K5 at chunk_slots 4 / 8 / 16) in fp32 and
   bf16, K5' (the single-lane ``paged_row_stats``) on every lane, overrides
   the kernels cannot take refused before any launch; K1-K4 at paper-bert's
   training shape (64 batch-heads, d = 64), timed; K1-K4 at Hymba-1.5B's
   training shape (50 batch-heads of d = 64) and K5 at its decode shape
   (hkv 5, r 5, d = 64, bs 16, kv_valid 0 / 17 / 60 / 116, fp32 and bf16)
   and at a 16k horizon (``hymba_k5_entries``), held and timed; K5 at
   Whisper-base's decode shape (hkv 8, r 1, d = 64, kv_valid 0 / 17 / 60 /
   116) and at its 4096-key ``dec_pos`` horizon (``whisper_k5_entries``);
   K1-K4 at Whisper-base's encoder training shape, bidirectional (b = 32,
   n = 1500, c = 32, d = 64: ``bidir_train_kernel_entries``); K5 at
   LLaVA-NeXT-34B's decode shape (hkv 8, r 7, d = 128, kv_valid 48 / 200 /
   333 / 480) and K1 (as the fused prefill and as the stats seed) and K2 at
   its prefill shape (b = 56, n = 352, kv_valid 333: ``llava_ss_entries``),
   each held in fp32 and bf16 and timed; the context-parallel attention's
   launches (``shard_kernel_entries``): K1 and K3 at every shard's
   ``kv_offset`` and K2 and K4 at its ``q_offset``, Qwen2-7B's training
   shape at n = 8192 over 2 and 4 shards and n = 8000 over 4, Whisper's
   bidirectional encoder shape (n = 1500, c = 32) over 2, ``sp_train``'s
   paper-bert shape (b = 16, n = 8192, d = 64, causal) over 2 and
   ``sp_hymba_fused``'s Hymba-1.5B shape (one row x 25 heads: b = 25,
   n = 4096, c = 64, d = 64, causal) over 2 and ``sp_llava``'s
   LLaVA-NeXT-34B shape (one row x 56 heads: b = 56, n = 8192, c = 64,
   d = 128, causal) over 4, in fp32 and bf16
   (K1's rows that reach no key of a shard come back empty, K3's keys no
   row reaches get zero dK / dV), the last shard of each timed; K1-K4 at
   ``tp_train``'s rank shape (4 rows x 4 query heads: b = 16, n = 4096,
   c = 64, d = 64, causal) in fp32 and bf16, timed (``tp_rank_launch``);
   K1-K4 past 64 landmarks (``wide_c_entries``: c = 96, a partial last
   tile, 128 and 256) at the serving shape (b = 28, n = 352) and the
   training shapes of Qwen2-7B (b = 56, d = 128) and paper-bert (b = 64,
   d = 64), n = 4096, causal, fp32 and bf16, every backward launch
   repeated and held bitwise, Qwen2-7B's 8k shape over 2 shards at c = 128
   (``kv_offset`` / ``q_offset``), c = 128 and 256 timed;
3. model parity, 2 full-width layers in fp32, prefill logits and 4 paged
   decode steps, kernel route against the plain route (every kernel
   swapped for its plain version), both on the card: Qwen2-7B (block 16)
   and granite-20b (48 query heads on 1 kv head, block 64); then Qwen2-7B
   with ``decode_attention_impl="full"``, the paged route (K5) against the
   gather route; then the loss and every gradient leaf of one grad step,
   kernel route against plain route, and under ``remat`` "ss_stats" and
   "dots" against "none"; then chunked prefill (chunks of 128, the ss_fused
   stats handoff: K1 at the chunk site) and 4 paged decode steps, kernel
   route against plain route (logits, and the streaming stats after the
   prefill and after the decode steps), and against whole-prompt
   ``replay`` prefill at 1 fp32 layer, at 2 fp32 layers (printed) and at
   2 layers computed wholly in float64; then ``decode_streaming="frozen"``
   (20 paged decode steps with the engine's boundary rebases), kernel
   route against plain route (logits; K5 never launches), and every
   frozen landmark row's BV against an exact recompute over the lane's
   keys (held in float64, printed in fp32 beside exact streaming's); then
   DeepSeek-V2-Lite at full width, 2 fp32 layers (absorbed MLA + MoE),
   kernel route against plain route: logits, and the streaming stats after
   the prefills and after the decode steps; then Hymba-1.5B at full width
   (``hymba_model_checks``): token-replay serving through the paged decode
   step (K5 from kv_valid 0), kernel route against plain route, 1 fp32
   layer held, 2 printed; the loss and grads of a 2-layer fp32 grad step
   under spectral_shift_fused, kernel against plain route, and remat
   "ss_stats" against "none"; and one fp32 grad step of DeepSeek-V2-Lite
   at 2 layers, chunked against full attention; LLaVA-NeXT-34B at full
   width, 2 fp32 layers, in the Qwen2-7B loop (prefill logits and 4 paged
   decode steps, kernel route against plain route); Whisper-base
   (``whisper_model_checks``): token-replay serving through the paged
   decode step (K5 from kv_valid 0), kernel route against plain route, 1
   fp32 decoder layer held, 2 printed, and one grad step with its encoder
   under spectral_shift_fused (K1-K4 bidirectional at n = 1500), against
   the plain route and against spectral_shift, 1 + 1 layers held, 2 + 2
   printed; xLSTM-350M at all 24 blocks (``xlstm_model_checks``): 16
   tokens replayed through the decode step against ``model_forward`` from
   the same served zero state, within 2e-2 (no kernel); last, Qwen2-7B at
   ``num_landmarks=128`` (``wide_c_model_checks``): 2 fp32 layers'
   logits and 1 layer's grads, kernel route against plain route;
4. serving, bf16 random weights from a seeded ``torch.Generator``, 4
   lanes, max_seq 512, prompts of 48/200/333/480 tokens, 16 new tokens
   each, the launch counts of each run read on their own: the main path
   (full-width Qwen2-7B, ``--layers`` cuts depth, never width;
   ``prefill_impl="ss_fused"``, ``decode_impl="paged"``: every serving
   kernel must launch); the same at ``num_landmarks=128`` (``serve_c128``:
   seg 4, K1 2 and K2 1 a layer for each prompt past 128 tokens, K5 > 0);
   the reference's default route on the same model
   (``ServeConfig(seed=0)``: replay prefill, gather decode, block 16: no
   port kernel may launch); full-width granite-20b cut to 8 layers
   (``ss_fused``, ``paged``, block 64: K1, K2 and K5 must launch); the
   continuous-batching tick on the main path's model and settings with
   ``chunked_prefill=True`` and chunks of 128 (``serve_chunked``: K1 and
   K5 must launch, K2 never), the same on a pool of 32 blocks with 64 new
   tokens at 8 layers (``serve_chunked_tight``: preemptions, parked
   victims, resumed requests), each prompt alone at 8 layers, cold and
   preempted after its first chunk while the pool has room
   (``serve_park_resume``: the parked snapshot is restored, tokens and
   launches identical to the cold run), and at 8 layers with
   ``prefix_cache=True`` over the sequence A, A, B (A's first 256 tokens +
   77), C, C one request at a time (``serve_prefix_cache``: hits 3, misses
   2, a copy-on-write, tokens
   identical to a cold chunked engine on the same sequence); then the
   main path with ``decode_streaming="frozen"`` (``serve_frozen``: K1 and
   K2 launch, K5 never; boundary rebases and their ms), and at 8 layers
   frozen with chunks of 128 and the prefix cache over the same sequence
   (``serve_frozen_chunked_prefix``: tokens identical to a cold frozen
   chunked engine), the chaos soak's four fault plans at seed 0 on a
   Poisson trace with the watchdog armed (``serve_chaos``: each drains
   with every request finished, no leaked block, tokens identical to the
   fault-free run) and the numerics guard demoting a frozen lane whose
   stats were poisoned (``serve_guard``: K5 runs for it alone, the other
   requests' tokens identical to the fault-free run); then DeepSeek-V2-Lite
   (``serve_deepseek``: all 27 layers at full width on the main path's
   settings, K1, K2 and K5 must launch; tok/s, TTFT, ms per decode tick,
   peak GiB) and its first 4 layers under frozen streaming with chunks of
   128 and the prefix cache over the same sequence
   (``serve_deepseek_chunked_frozen``: tokens identical to a cold frozen
   chunked engine); Hymba-1.5B (``serve_hymba``: 8 of its 32 layers at
   full width, ``ss_fused`` + ``paged``, prompts of 16/40/64/100 tokens,
   which the family prefills by token replay, as the reference: K5 8 a
   tick, K1 and K2 never; ``serve_hymba_frozen``: frozen streaming, K5
   never, lane rebases); Whisper-base (``serve_whisper``: its 6 decoder layers,
   ``ss_fused`` + ``paged``, prompts of 16/40/64/100 tokens by token
   replay, cross K/V zero as the reference's engine serves them: K5 6 a
   tick; ``serve_whisper_frozen``: K5 never, lane rebases);
   LLaVA-NeXT-34B cut to 16 layers (``serve_llava``: the main path's
   settings and prompts, text only: K1 96 / K2 48 / K5 16 a tick);
   xLSTM-350M (``serve_xlstm``: all 24 blocks, token replay on lane-dense
   state, ``dense+replay-prefill``, no launch); telemetry on the card: the main path again with
   ``telemetry=True`` and ``numerics_probe_every=4`` (``serve_telemetry``:
   tokens and K1 / K2 / K5 launches identical to the telemetry-off main
   path of the same weights, a JSONL dump that parses with the port's core
   metric families, a Chrome trace that validates, no non-finite value
   seen by the numerics probe, ``program_shapes`` flat when the same
   prompts run again; the mean ms of the tick spans and tok/s with
   telemetry on and off), one main-path run under ``torch.profiler`` with
   annotated spans (``serve_telemetry_annotated``: every span name among
   the profiler's events), frozen at 28 layers with telemetry
   (``serve_frozen_telemetry``: one drift residual per lane rebase, tokens
   identical to ``serve_frozen``), the 8-layer frozen prefix path's engine
   with telemetry (``prefix_attach`` and ``cow`` in the lifelines, a valid
   trace) and the chaos plans with telemetry (``chaos_injections_total``
   equal to ``stats()["chaos_injections"]``); ``serve_autotune``: the main
   path with ``autotune=True`` (the engine's warm-up times K5 across view
   quanta and slot chunks on the device; tokens compared with the
   autotune-off run; the chosen tilings' logits held to the kernels' own
   plans at 2 fp32 layers, MODEL_TOL); every autotune-off engine resolves
   heuristic plans only (the run's autotune cache is a fresh file);
5. training: the ``Trainer`` on full-width Qwen2-7B cut to
   ``--train-layers`` layers, bf16 compute over fp32 master weights, seq
   4096, batch 2, 5 steps each under ``remat="full"`` (launches per step
   K1 8 / K2 8 / K3 4 / K4 4 at 4 layers, then a bit-identical checkpoint
   round trip of the parameters) and ``remat="auto"`` (ss_stats on the
   card: K1 4 / K2 8 / K3 4 / K4 4) and ``remat="dots"`` (K1 8 / K2 8 /
   K3 4 / K4 4), every loss finite, ms per step and peak memory of each;
   then ``remat="full"`` again with a ``Telemetry`` (``train_telemetry``:
   ``train_step_seconds`` counts every step, the losses equal the run
   without it); ``train_autotune`` (``autotune=True``: the warm-up times
   K1-K4 forward and backward at each tiling at the train shape on the
   device, 3 steps at the winner's tiling with the phase-5 launches,
   losses held to the heuristic plan's, a control with a broken K1 that
   the bound must catch, a second Trainer resolves from the disk cache
   without a sweep); ``train_paper_bert`` (the paper's config at full
   size, 3 steps each under spectral_shift, nystrom and
   spectral_shift_fused, the fused losses held to spectral_shift's, the
   same broken-K1 controls, and spectral_shift_fused with
   ``attention_backend="jnp"``: no launch; ``train_paper_bert_c128``:
   spectral_shift_fused at ``num_landmarks=128``, the c = 64 run's
   launches, losses finite and flat beside its); ``train_chunked`` (Qwen2-7B's
   own ``chunked`` attention beside ``full``: no kernel launches);
   ``train_whisper`` (Whisper-base at 6 + 6 layers, decoder seq 4096, 1500
   stub frames, batch 4, 3 steps with the encoder under spectral_shift and
   under spectral_shift_fused: K1-K4 18 each), ``train_llava``
   (LLaVA-NeXT-34B cut to 2 layers, 2048 stub patches + 2048 tokens, batch
   1, 3 steps under chunked and spectral_shift_fused: K1 12 / K2 12 / K3 6
   / K4 6) and ``train_xlstm`` (xLSTM-350M cut to 6 of its 24 blocks, one
   of them sLSTM, seq 4096, batch 2, 2 steps, no launch); then context
   parallelism and parameter sharding on 4 ranks that share
   the card (``sp_phase``: ``launch/mesh.py:spawn_local``, a 2 x 2
   ("data", "model") mesh, gloo staging the collectives through the host):
   ``sp_attention`` (the sharded attention at Qwen2-7B's shape, n = 8192,
   causal, over 2 and 4 shards, against the single-device fused route:
   fp32 within 2e-4 / 5e-4 of max-abs forward / gradients, bf16 printed,
   remat "ss_stats" bitwise equal to none, K1-K4 counted on each rank)
   and ``sp_train`` (paper-bert at full width and depth, global seq 8192,
   batch 4, 2 steps, data over "data" and the sequence over "model",
   step 0's loss within 1.5e-3 of the single-process ``Trainer``'s, a
   bound a control with one shard's B-side partial dropped must exceed,
   the later losses within the sanity bound 5e-3, a 1-layer fp32 twin's
   gradients within 5e-4; ms a step, peak
   GiB and the collectives' share per rank; its parameters stay whole
   through the override ``{"seq": "model", "embed": None}``) and
   ``tp_train`` (paper-bert at full width cut to 4 fp32 layers, seq
   4096, global batch 8, 2 steps under the default rules: FSDP over
   "data", query heads, MLP width and vocab over "model", K1-K4 at each
   rank's 4 rows x 4 heads; step 0's forward of the same weights within
   1e-4 of one device's, a bound a control with layer 0's MLP all-reduce
   dropped must exceed; the 1-layer fp32 twin's gathered gradients within
   5e-4, the checkpoint restored bitwise onto a 1 x 4 mesh and onto one
   device; ms a step, peak GiB, the collectives' share); ``ep_train``
   (DeepSeek-V2-Lite at full width cut to 2 layers, ``moe_impl="ep"`` on a
   4 x 1 mesh of the same ranks, 16 of the 64 experts a rank: step 0 at 1
   fp32 layer with capacity E / k within 1e-6 of one device's under
   "gspmd", a bound a control with the return exchange reversed must
   exceed; then bf16, seq 2048, batch 4, 2 steps: ms a step, the
   exchanges' and all-reduces' shares, the dropped slots, peak GiB; no
   kernel) and ``pp_train`` (paper-bert at full width and depth over a
   ("pipe",) mesh of 4 stages of 3 layers, 8 microbatches of 2 x 4096:
   at 4 fp32 layers the pipelined forward and loss equal the sequential
   layers' one microbatch at a time bitwise, the stage gradients within
   1e-5, a control fed a stale activation must differ; then bf16, 3
   forward + backward passes of the CE: ms a step, send / recv /
   broadcast shares beside the schedule's bubble, peak GiB, K1-K4 24 each
   a rank and step), ``dryrun`` (one ``tp_train`` step on the card under
   ``FlopCounterMode`` with ``Mesh.traffic`` counted: its FLOPs by op,
   K1-K4's from ``kernels/cost.py`` through their custom ops, its
   collectives and state bytes equal to ``launch/dryrun.py:run_cell`` on a
   2 x 2 ``AbstractMesh`` at every rank, exactly; the time of Qwen2-7B's
   ``train_4k`` cell on the production mesh, on the host) and
   ``elastic_train`` (``tp_train``'s config and shape over 4 hosts of one
   rank, a checkpoint every 2 steps, host0 failing before step 2 of 4: the
   survivors, world ranks 1 and 2, go on over 1 x 2 from the step-2
   checkpoint, bitwise equal to an uninterrupted 1 x 2 restore, beside a
   control restoring step 0's state at step 2 that must differ; the
   restart's seconds, ms a step before and after, peak GiB); the family
   paths (``family_rank``): ``sp_hymba_chunked`` and ``sp_hymba_fused``
   (Hymba-1.5B at full width cut to 2 of 32 layers, seq 4096 over
   "model", batch 2 over "data", under its own ``chunked`` attention (K /
   V all-gathered) and under ``spectral_shift_fused`` (K1-K4 at the
   shard's offsets); the mamba conv's halo and the scan's affine carry),
   ``sp_xlstm`` (xLSTM-350M at full width cut to 6 blocks, one sLSTM,
   seq 2048 over "model", batch 2: the mLSTM / sLSTM state chain) and
   ``dp_whisper`` (Whisper-base 6 + 6 layers, decoder seq 4096 beside 1500
   stub frames, batch 4 over a 4 x 1 mesh of the same ranks): each one's
   step 0 at fp32 (TF32 off), every position's CE within 1e-4 of the
   single process's, a bound a control (shard 1's entering mamba state
   zeroed; shard 1's sLSTM state dropped; every row given the next row's
   frames) must exceed; then 2 bf16 steps: losses (a 2e-2 sanity bound
   against the single process), ms a step, peak GiB, the collectives'
   share, launches (K1 2 / K2 2 / K3 1 / K4 1 a layer and step under the
   fused Hymba, none elsewhere); ``sp_whisper`` (Whisper-base
   6 + 6 layers, decoder seq 4096 over "model" of the 2 x 2 group, batch 4,
   the encoder whole on every rank through K1-K4 in the bf16 steps; step 0
   in float64 at 2 + 2 layers beside two controls: cross attention's query landmarks from
   the rank's own rows, ``dec_pos`` read from row 0 on every shard) and
   ``sp_llava`` (LLaVA-NeXT-34B at one fp32 layer, joint seq 8192 of 2880
   patches and the text over 4 ranks of a 1 x 4 mesh: step 0's CE within
   1e-3 and the summed gradients of the projector, the embedding and the
   layer within 5e-4 of the single process, run after the ranks, beside a
   control with the boundary shard's text moved to the front of its
   slice; no optimizer step: AdamW's state would not fit four ranks); the
   dry-run's Qwen2-7B cell under its own ``chunked`` attention traced,
   and Whisper's and LLaVA's train cells;
   then each kernel timed at the tiling the sweeps chose
   (``autotuned_launch``);
6. a ``{"kernels": [...]}`` line (launches summed over the serving and
   training runs, and by path), the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Without a GPU, or without
``src/repro_torch`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Logits of the 2-layer fp32 model, kernel route vs plain route, both on
# the card. (On the CPU the plain route differs from either by up to 1.4e-2
# at two layers: cuBLAS vs CPU BLAS rounding, amplified about tenfold per
# layer by the random-weight spectral-shift core; see PERF.md.)
MODEL_TOL = 2e-4
# Chunked against whole-prompt replay prefill, one fp32 layer, at every
# prompt position (the sampled ones are held to MODEL_TOL): rounding that
# the random-weight core amplifies where a position's context fills 2-4
# landmark rows (ROADMAP P2). Measured on an H100: 4.3e-4 at such
# positions, 2.0e-4 at the others; the limit leaves 2.3x (PERF.md).
P2_TOL = 1e-3
# Streaming stats (m, l, acc) of layer 1 after chunked prefill and 4 paged
# decode steps, kernel route vs plain route, relative to max-abs: layer 1's
# keys carry layer 0's rounding. Measured on an H100: at most 4.6e-4 over
# both layers; the limit leaves 2.2x (PERF.md).
STATS_TOL = 1e-3
# By the dtype of the output held: fp32 outputs (K1's m and l, all of K5's)
# accumulate in fp32 on both sides from the same inputs whatever the input
# dtype, so they are held at the fp32 tolerance; a bf16 output at its ulp.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Loss and every gradient leaf of one 2-layer fp32 grad step, kernel route
# vs plain route on the card, relative to the plain route's max-abs.
# Measured on an H100: worst leaf 9.2e-5 (w_down), loss identical (PERF.md).
GRAD_TOL = 5e-4
# Loss and every gradient leaf of one grad step under remat "ss_stats" and
# "dots" against remat "none", the same kernel route, relative to max-abs.
REMAT_TOL = 1e-6
SERVE_KERNELS = ("landmark_summary", "query_side", "paged_row_stats")
TRAIN_KERNELS = ("landmark_summary", "query_side", "landmark_summary_bwd",
                 "query_side_bwd")
TRAIN_BATCH = 2   # train_4k's global batch of 256 cut to what one card holds
TRAIN_STEPS = 5
L2_BYTES = 50 * 2**20   # H100 SXM L2


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events after ``warmup`` calls. ``fn`` may be a list of calls, taken in
    turn (to rotate over copies of the operands)."""
    import torch

    if isinstance(fn, list):
        calls = fn
        state = {"i": 0}

        def fn():
            state["i"] = (state["i"] + 1) % len(calls)
            return calls[state["i"]]()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, floor: float = 0.0):
    """Device time per call of ``fn``: the summed device activities
    (kernels, copies, memsets) that ``iters`` calls launch, by torch.profiler,
    over ``iters``. Unlike ``cuda_ms`` it leaves out the host's time between
    launches, which a small kernel issued back to back can be bound by.
    A window whose time falls below ``floor`` (the bound: no launch can
    beat it) lost activity and is profiled again; None (not measured)
    after three such windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = fn if isinstance(fn, list) else [fn]
    calls[0]()
    torch.cuda.synchronize()
    # The profiler now and then hands back a window with no device activity
    # at all (seen once on an H100), or with part of it (a time below the
    # bound): profile again.
    seen = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        seen = max(seen, us)
        if us > 0 and us / 1e3 / iters >= floor:
            return us / 1e3 / iters
    if seen > 0:
        log(f"device_ms: every window fell below the bound {floor:.4f} ms "
            f"(at most {seen / 1e3 / iters:.4f} ms): not measured")
        return None
    raise RuntimeError("device_ms: the profiler recorded no device activity "
                       "in three windows")


def device_us_by_kernel(calls, iters: int = 20) -> dict:
    """Device microseconds per call of each kernel that ``calls`` (taken in
    turn) launch, by torch.profiler: K5's main kernel and its merge apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    return {re.sub(r"^.*::|[<(].*$", "", e.key): round(e.self_device_time_total / iters, 2)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


# Every bound below is the least time the card could take for a launch's
# work: ``kernels/cost.py``'s bytes and flops of each kernel (the one
# definition the FLOP counter of the dry-run reads too) at the H100's rates.
def k1_bound(b, c, keys, d, dv, pairs, *, q_bytes=2, kv_bytes=2, out_bytes=2, stats=False):
    from repro_torch.kernels import cost

    return cost.bound_ms(*cost.landmark_summary_cost(
        b, c, keys, d, dv, pairs, q_bytes=q_bytes, kv_bytes=kv_bytes, out_bytes=out_bytes,
        stats=stats), "bfloat16")


def k2_bound(b, n, c, d, dv, pairs, es=2):
    from repro_torch.kernels import cost

    return cost.bound_ms(*cost.query_side_cost(b, n, c, d, dv, pairs, es=es), "bfloat16")


def k3_bound(b, c, keys, d, dv, pairs, es=2):
    from repro_torch.kernels import cost

    return cost.bound_ms(*cost.landmark_summary_bwd_cost(b, c, keys, d, dv, pairs, es=es),
                         "bfloat16")


def k4_bound(b, n, c, d, dv, pairs, es=2):
    from repro_torch.kernels import cost

    return cost.bound_ms(*cost.query_side_bwd_cost(b, n, c, d, dv, pairs, es=es), "bfloat16")


def k5_bound(kv_valid, hkv: int, r: int, d: int, dv: int, bs: int,
             es: int = 4, v_is_key: bool = False) -> tuple[float, str]:
    """K5's bound for one launch at the peak of the pools' type (``es``
    bytes an element: 2 is bf16, 4 fp32)."""
    from repro_torch.kernels import cost

    return cost.bound_ms(*cost.paged_row_stats_cost(kv_valid, hkv, r, d, dv, bs, es=es,
                                                    v_is_key=v_is_key),
                         "bfloat16" if es == 2 else "float32")


def cold_pools(k_pool, v_pool) -> list:
    """(k_pool, v_pool) and copies that together exceed L2 twice: decode
    reads another layer's pools at each launch, so a timing that rotates
    over these finds every launch's pools cold."""
    pair = 2 * k_pool.numel() * k_pool.element_size()
    return [(k_pool, v_pool)] + [(k_pool.clone(), v_pool.clone())
                                 for _ in range(-(-2 * L2_BYTES // pair) - 1)]


def max_err(out, ref, where=None) -> tuple[float, float]:
    """(max-abs error, max-abs of the reference) over ``where``, in fp32 or
    wider."""
    import torch

    wide = torch.promote_types(torch.promote_types(out.dtype, ref.dtype), torch.float32)
    out, ref = out.to(wide), ref.to(wide)
    if where is not None:
        out, ref = out[where], ref[where]
    return float((out - ref).abs().max()), float(ref.abs().max())


def check(label: str, pairs) -> float:
    """Hold kernel outputs to their plain versions: max-abs error <=
    tol * max-abs of the reference, for each (name, out, ref, where), with
    tol from the output's dtype (KERNEL_TOL)."""
    worst = 0.0
    parts = []
    for name, out, ref, where in pairs:
        tol = KERNEL_TOL[str(out.dtype).split(".")[-1]]
        err, scale = max_err(out, ref, where)
        rel = err / max(scale, 1e-30)
        worst = max(worst, err)
        parts.append(f"{name} err={err:.3e} rel={rel:.2e} (tol {tol})")
        if not rel <= tol:
            raise AssertionError(f"{label}: {name} rel err {rel:.3e} > {tol}")
    log(f"check {label}: " + ", ".join(parts) + " of max-abs ok")
    return worst


def timed_entry(tag: str, e: dict) -> dict:
    """Time a held entry (``fn`` with its ``plain`` version and ``library``
    call): CUDA-event ms, profiler device ms, bound; logs one line and
    returns the fields of a ``kernels`` row."""
    ms, plain_ms = cuda_ms(e["fn"]), cuda_ms(e["plain"])
    bound_ms, bound_by = e["bound"]
    dev_ms = device_ms(e["fn"], floor=bound_ms)
    lib_ms = cuda_ms(e["library"]) if e["library"] is not None else None
    warm = f", warm L2 {cuda_ms(e['warm']):.4f} ms" if "warm" in e else ""
    label = getattr(e["library"], "label", "")
    if tag.startswith("paged_row_stats"):
        log(f"time {tag}: device us per kernel {device_us_by_kernel(e['fn'])}")
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
    by_dev = "" if dev_ms is None else f" ({100 * bound_ms / dev_ms:.1f}% by device time)"
    log(f"time {tag} [{e['shape']}]: kernel {ms:.4f} ms (device {dev})"
        f"{warm}, plain "
        f"{plain_ms:.4f} ms, library "
        f"{lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}"
        f"{f' ({label})' if label else ''}, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{100 * bound_ms / ms:.1f}% of bound{by_dev}, "
        f"{'no library' if lib_ms is None else f'{ms / lib_ms:.2f}x the library'}")
    return dict(max_abs_err=e["err"], ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def kernel_phase(torch, dev) -> list[dict]:
    from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,
                                                  paged_row_stats_plain)
    from repro_torch.kernels.ss_attention import (landmark_summary,
                                                  landmark_summary_plain,
                                                  query_side, query_side_plain)

    gen = torch.Generator(device=dev).manual_seed(1)
    b, c, d = 28, 64, 128
    scale = d**-0.5

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    entries = {}
    # ---- K1 landmark_summary ------------------------------------------------
    # The path launches K1 twice per layer per prompt > c: inside
    # ss_attention_fused (bf16 q/k/v, no stats) and in _seed_stream_stats
    # (fp32 landmark means against bf16 k/v, with stats). Both are timed.
    for n, kv_valid in ((352, 333), (512, None)):
        for q_dt, kv_dt in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.bfloat16)):
            q_l = randn(b, c, d, s=0.5, dtype=q_dt)
            k, v = randn(b, n, d, s=0.5, dtype=kv_dt), randn(b, n, d, dtype=kv_dt)
            out, m, l = landmark_summary(q_l, k, v, scale=scale,
                                         kv_valid=kv_valid, return_stats=True)
            end = n if kv_valid is None else kv_valid
            ref, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale,
                                                 kv_end=end, return_stats=True)
            err = check(f"K1 landmark_summary b={b} c={c} n={n} kv_valid={end} "
                        f"q={q_dt} kv={kv_dt}",
                        [("out", out, ref, None), ("m", m, rm, None),
                         ("l", l, rl, None)])
            if n != 352 or kv_dt != torch.bfloat16:
                continue
            stats = q_dt == torch.float32
            tag = "landmark_summary_stats" if stats else "landmark_summary"
            mask = torch.arange(n, device=dev)[None, :] < end
            entries[tag] = dict(
                fn=partial(landmark_summary, q_l, k, v, scale=scale,
                           kv_valid=kv_valid, return_stats=stats),
                plain=partial(landmark_summary_plain, q_l, k, v, scale=scale,
                              kv_end=end, return_stats=stats),
                library=None if stats else partial(
                    torch.nn.functional.scaled_dot_product_attention,
                    q_l[None], k[None], v[None], attn_mask=mask.expand(c, n),
                    scale=scale),
                err=err, bound=k1_bound(b, c, end, d, d, b * c * end,
                                        q_bytes=q_l.element_size(), stats=stats),
                shape=(f"b={b} c={c} n={n} kv_valid={end} d=dv={d} "
                       + ("fp32 q, bf16 k/v, with stats (seed)" if stats
                          else "bf16, no stats (ss_attention_fused)")))
    # the chunked tick's stats handoff (serve/prefill.py:_merge_chunk_stats):
    # fp32 landmark means against a bf16 chunk window of 128 keys, kv_valid =
    # the chunk's valid tokens (48 and 77: a prompt's only or ragged last
    # chunk), with stats
    n = 128
    q_l = randn(b, c, d, s=0.5)
    k, v = randn(b, n, d, s=0.5, dtype=torch.bfloat16), randn(b, n, d, dtype=torch.bfloat16)
    for kv_valid in (48, 77, 128):
        out, m, l = landmark_summary(q_l, k, v, scale=scale, kv_valid=kv_valid,
                                     return_stats=True)
        ref, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, kv_end=kv_valid,
                                             return_stats=True)
        err = check(f"K1 landmark_summary chunk site b={b} c={c} n={n} "
                    f"kv_valid={kv_valid} fp32 q, bf16 k/v",
                    [("out", out, ref, None), ("m", m, rm, None), ("l", l, rl, None)])
    # timed at kv_valid = n, the case of every chunk but a prompt's last
    entries["landmark_summary_chunk"] = dict(
        fn=partial(landmark_summary, q_l, k, v, scale=scale, kv_valid=n,
                   return_stats=True),
        plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, kv_end=n,
                      return_stats=True),
        library=None, err=err, bound=k1_bound(b, c, n, d, d, b * c * n, q_bytes=4, stats=True),
        shape=f"b={b} c={c} n={n} kv_valid={n} d=dv={d} fp32 q, bf16 k/v, with "
              f"stats (chunk site; no library call takes mixed dtypes)")
    # segment-causal variant (not on the serving path, held all the same)
    q_l, k, v = randn(b, c, d, s=0.5), randn(b, 512, d, s=0.5), randn(b, 512, d)
    check("K1 landmark_summary causal n=512 fp32",
          [("out", landmark_summary(q_l, k, v, scale=scale, causal=True),
            landmark_summary_plain(q_l, k, v, scale=scale, seg=8), None)])

    # ---- K2 query_side --------------------------------------------------------
    for n in (352, 512):
        for dt in (torch.float32, torch.bfloat16):
            q, k_l = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
            m_mat, v = randn(b, c, d, dtype=dt), randn(b, n, d, dtype=dt)
            delta = randn(b, 1, 1, s=0.1).abs()
            dname = str(dt).split(".")[-1]
            out = query_side(q, k_l, m_mat, v, delta, scale=scale)
            ref = query_side_plain(q, k_l, m_mat, v, delta, scale=scale)
            err = check(f"K2 query_side b={b} n={n} c={c} {dname}",
                        [("out", out, ref, None)])
            if (dt, n) == (torch.bfloat16, 352):
                entries["query_side"] = dict(
                    fn=partial(query_side, q, k_l, m_mat, v, delta, scale=scale),
                    plain=partial(query_side_plain, q, k_l, m_mat, v, delta, scale=scale),
                    library=partial(sdpa_query_side, q, k_l, m_mat, v, delta,
                                    scale=scale),
                    err=err, bound=k2_bound(b, n, c, d, d, b * n * c),
                    shape=f"b={b} n={n} c={c} d=dv={d} bf16")
    q, k_l = randn(b, 160, d, s=0.5), randn(b, c, d, s=0.5)
    m_mat, v, delta = randn(b, c, d), randn(b, 160, d), randn(b, 1, 1, s=0.1).abs()
    check("K2 query_side causal q_offset=37 fp32",
          [("out", query_side(q, k_l, m_mat, v, delta, scale=scale, causal=True,
                              seq_len_k=512, q_offset=37),
            query_side_plain(q, k_l, m_mat, v, delta, scale=scale, seg=8,
                             pos_offset=37), None)])

    # ---- K5 paged_row_stats ------------------------------------------------------
    lanes, hkv, r, bs, n_slots = 4, 4, 7, 16, 32
    nb = lanes * n_slots + 1
    kv_valid = torch.tensor([0, 17, 300, 512], dtype=torch.int32, device=dev)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(2)) + 1
    table = torch.zeros((lanes, n_slots), dtype=torch.int32)
    for ln, kvv in enumerate(kv_valid.tolist()):
        used = max(-(-kvv // bs), 1)   # kv_valid 0: one block allocated, none valid
        table[ln, :used] = perm[ln * n_slots: ln * n_slots + used]
    table = table.to(dev)
    for dt in (torch.float32, torch.bfloat16):
        q = randn(lanes, hkv, r, d, s=0.5, dtype=dt)
        k_pool, v_pool = randn(hkv, nb, bs, d, s=0.5, dtype=dt), randn(hkv, nb, bs, d, dtype=dt)
        m, l, acc = paged_row_stats_lanes(q, (k_pool,), v_pool, table, kv_valid,
                                          scale=scale, block_size=bs)
        rm, rl, racc = paged_row_stats_plain(q, (k_pool,), v_pool, table, kv_valid,
                                             scale=scale)
        dname = str(dt).split(".")[-1]
        live = rl[..., 0] > 0
        if not (torch.all(m[0] == -1e30) and torch.all(l[0] == 0)
                and torch.all(acc[0] == 0)):
            raise AssertionError("K5: a lane with kv_valid = 0 must return "
                                 "(m=-1e30, l=0, acc=0)")
        err = check(f"K5 paged_row_stats lanes={lanes} hkv={hkv} r={r} bs={bs} "
                    f"kv_valid={kv_valid.tolist()} {dname}",
                    [("m", m[..., 0], rm[..., 0], live), ("l", l, rl, None),
                     ("acc", acc, racc, None)])
        if dt == torch.float32:
            pools = cold_pools(k_pool, v_pool)
            entries["paged_row_stats"] = dict(
                fn=[partial(paged_row_stats_lanes, q, (kp,), vp, table, kv_valid,
                            scale=scale, block_size=bs) for kp, vp in pools],
                warm=partial(paged_row_stats_lanes, q, (k_pool,), v_pool, table,
                             kv_valid, scale=scale, block_size=bs),
                plain=[partial(paged_row_stats_plain, q, (kp,), vp, table,
                               kv_valid, scale=scale) for kp, vp in pools],
                library=None, err=err,
                bound=k5_bound(kv_valid.tolist(), hkv, r, d, d, bs),
                shape=f"lanes={lanes} hkv={hkv} r={r} bs={bs} slots={n_slots} "
                      f"kv_valid={kv_valid.tolist()} fp32, L2 cold "
                      f"({len(pools)} pool copies)")
    entries["paged_row_stats_long"] = long_horizon_entry(torch, dev)
    entries.update(granite_k5_entries(torch, dev))

    split_key_checks(torch, dev)
    query_tile_checks(torch, dev)
    slot_chunk_checks(torch, dev)
    granite_ss_checks(torch, dev)
    entries.update(train_kernel_entries(torch, dev))
    entries.update(mla_kernel_entries(torch, dev))
    entries["paged_row_stats_single_lane"] = tiling_checks(torch, dev)
    # paper-bert's training launches: 8 batch x 8 heads of d = 64
    entries.update({f"bert_{k}": e for k, e in train_kernel_entries(
        torch, dev, b=PAPER_BERT_BATCH * 8, d=64).items()})
    # Hymba-1.5B's training launches (2 batch x 25 heads of d = 64, the 5 kv
    # heads broadcast) and its decode launch (hkv 5, r 5, d = 64)
    entries.update({f"hymba_{k}": e for k, e in train_kernel_entries(
        torch, dev, b=HYMBA_TRAIN_BATCH * 25, d=64).items()})
    entries.update(hymba_k5_entries(torch, dev))
    # Whisper-base's decode launch (hkv 8, r 1, d 64) and its encoder's
    # training launches (bidirectional, b = 64, n = 1500, c = 32, d = 64);
    # LLaVA-NeXT-34B's prefill (b = 56) and decode (hkv 8, r 7) launches
    entries.update(whisper_k5_entries(torch, dev))
    entries.update(bidir_train_kernel_entries(torch, dev))
    entries.update(llava_k5_entries(torch, dev))
    entries.update(llava_ss_entries(torch, dev))
    # the context-parallel attention's launches: K1 / K3 at kv_offset, K2 / K4
    # at q_offset, every shard of each split
    entries.update(shard_kernel_entries(torch, dev))
    # tp_train's launches on a rank: paper-bert's 4 local rows x 4 local
    # query heads of d = 64 (TP 2 x FSDP 2), the whole 4096-token sequence
    entries.update({f"tp_{k}": e for k, e in train_kernel_entries(
        torch, dev, b=TP_RANK_BATCH_HEADS, d=64).items()})
    # past 64 landmarks: the serving and training shapes at c = 96, 128, 256
    entries.update(wide_c_entries(torch, dev))

    def timed(tag):
        return timed_entry(tag, entries[tag])

    results = []
    t_wide = 0.0
    for name, src, replaces in (
        ("landmark_summary", "src/repro_torch/csrc/landmark_summary.cu",
         "src/repro/kernels/ss_attention.py:195"),
        ("query_side", "src/repro_torch/csrc/query_side.cu",
         "src/repro/kernels/ss_attention.py:365"),
        ("paged_row_stats", "src/repro_torch/csrc/paged_row_stats.cu",
         "src/repro/kernels/paged_decode.py:162"),
        ("landmark_summary_bwd", "src/repro_torch/csrc/landmark_summary_bwd.cu",
         "src/repro/kernels/ss_attention_bwd.py:117"),
        ("query_side_bwd", "src/repro_torch/csrc/query_side_bwd.cu",
         "src/repro/kernels/ss_attention_bwd.py:267"),
    ):
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=0, **timed(name))
        if name == "landmark_summary":
            # the serving path's second K1 launch (same kernel and counter)
            row["seed_stats_launch"] = dict(shape=entries[
                "landmark_summary_stats"]["shape"], **timed("landmark_summary_stats"))
            # the chunked tick's stats handoff (same kernel and counter)
            row["chunk_site_launch"] = dict(shape=entries[
                "landmark_summary_chunk"]["shape"], **timed("landmark_summary_chunk"))
        if name in ("landmark_summary", "query_side"):
            # the training path's forward launch (same kernel and counter)
            row["train_launch"] = dict(shape=entries[f"{name}_train"]["shape"],
                                       **timed(f"{name}_train"))
        # paper-bert's training launch (d = 64; same kernel and counter)
        tag = f"bert_{name}_train" if f"bert_{name}_train" in entries else f"bert_{name}"
        if tag in entries:
            row["paper_bert_launch"] = dict(shape=entries[tag]["shape"], **timed(tag))
        # Hymba-1.5B's training launch (d = 64, b = 50; same kernel and counter)
        tag = f"hymba_{name}_train" if f"hymba_{name}_train" in entries else f"hymba_{name}"
        if tag in entries and name != "paged_row_stats":
            row["hymba_train_launch"] = dict(shape=entries[tag]["shape"], **timed(tag))
        # Whisper-base's encoder training launch (bidirectional, d = 64, n =
        # 1500, c = 32) and LLaVA-NeXT-34B's prefill launches (b = 56)
        tag = (f"whisper_{name}_train" if f"whisper_{name}_train" in entries
               else f"whisper_{name}")
        if tag in entries and name != "paged_row_stats":
            row["whisper_encoder_train_launch"] = dict(shape=entries[tag]["shape"],
                                                       **timed(tag))
        # a tensor-parallel rank's launches (tp_train: b = 16 local
        # batch-heads; same kernels and counters)
        tag = f"tp_{name}_train" if f"tp_{name}_train" in entries else f"tp_{name}"
        if tag in entries:
            row["tp_rank_launch"] = dict(shape=entries[tag]["shape"], **timed(tag))
        # past 64 landmarks (same kernels and counters): the serving shape
        # (K1, its seed launch, K2) and the training shapes of Qwen2-7B and
        # paper-bert
        t_rows = time.perf_counter()
        for c in WIDE_C_TIMED:
            for tag, key in ((f"c{c}_serve_{name}", f"c{c}_serve_launch"),
                             (f"c{c}_serve_{name}_stats", f"c{c}_seed_stats_launch"),
                             (f"c{c}_{name}_train", f"c{c}_train_launch"),
                             (f"c{c}_{name}", f"c{c}_train_launch"),
                             (f"c{c}_bert_{name}_train", f"c{c}_paper_bert_launch"),
                             (f"c{c}_bert_{name}", f"c{c}_paper_bert_launch")):
                if tag in entries and key not in row:
                    row[key] = dict(shape=entries[tag]["shape"], **timed(tag))
        t_wide += time.perf_counter() - t_rows
        # a sequence shard's launches (the last shard of each timed split;
        # same kernels and counters)
        if name in TRAIN_KERNELS:
            for case, key in SHARD_TIMED.items():
                row[key] = dict(shape=entries[f"{case}_{name}"]["shape"],
                                **timed(f"{case}_{name}"))
        for tag, key in {"landmark_summary": (("llava_landmark_summary", "llava_prefill_launch"),
                                              ("llava_landmark_summary_stats",
                                               "llava_seed_stats_launch")),
                         "query_side": (("llava_query_side", "llava_prefill_launch"),)
                         }.get(name, ()):
            row[key] = dict(shape=entries[tag]["shape"], **timed(tag))
        # DeepSeek-V2-Lite's launches (absorbed MLA: d = 576, dv = 512; the
        # same kernels, through their wide-head variants, and counters)
        for tag, key in {
                "landmark_summary": (("mla_landmark_summary", "mla_prefill_launch"),
                                     ("mla_landmark_summary_stats", "mla_seed_stats_launch"),
                                     ("mla_landmark_summary_chunk", "mla_chunk_site_launch")),
                "query_side": (("mla_query_side", "mla_prefill_launch"),),
                "paged_row_stats": (("mla_paged_row_stats", "mla_decode_launch"),
                                    ("mla_paged_row_stats_long",
                                     "mla_long_horizon_launch"))}.get(name, ()):
            row[key] = dict(shape=entries[tag]["shape"], **timed(tag))
        if name == "paged_row_stats":
            # the same decode launch at a 16k horizon
            row["long_horizon_launch"] = dict(
                shape=entries["paged_row_stats_long"]["shape"],
                **timed("paged_row_stats_long"))
            # granite-20b's decode launch (r = 48, bs 64) at 512 and 16k keys
            for tag, key in (("paged_row_stats_granite", "granite_launch"),
                             ("paged_row_stats_granite_long", "granite_long_horizon_launch"),
                             ("hymba_paged_row_stats", "hymba_decode_launch"),
                             ("hymba_paged_row_stats_long", "hymba_long_horizon_launch"),
                             ("whisper_paged_row_stats", "whisper_decode_launch"),
                             ("whisper_paged_row_stats_long", "whisper_dec_pos_horizon_launch"),
                             ("llava_paged_row_stats", "llava_decode_launch")):
                row[key] = dict(shape=entries[tag]["shape"], **timed(tag))
        results.append(row)
    log(f"wide c: the c = {list(WIDE_C_TIMED)} rows timed in {t_wide:.1f}s")
    # K5': the reference's single-lane entry, K5 launched with one lane (its
    # launches count in K5's wrapper; no driven path calls it: the engine
    # launches K5 once for every lane)
    results.append(dict(name="paged_row_stats_single_lane", route="cuda",
                        source="src/repro_torch/csrc/paged_row_stats.cu",
                        replaces="src/repro/kernels/paged_decode.py:267", launches=0,
                        **timed("paged_row_stats_single_lane")))
    return results


def sdpa_query_side(q, k_l, m_mat, v, delta, *, scale, attn_mask=None):
    """K2's function as one library call: softmax(Q K~^T) M by
    scaled_dot_product_attention, plus delta * V (timed beside K2, never
    used by the port)."""
    import torch

    out = torch.nn.functional.scaled_dot_product_attention(
        q[None], k_l[None], m_mat[None], attn_mask=attn_mask, scale=scale)[0]
    return out + delta.to(out.dtype) * v


def sdpa_4d(q, k, v, **kw):
    """scaled_dot_product_attention on (b, n, d) operands as one (1, b, n, d)
    batch: its fused backends take 4-D inputs only."""
    import torch

    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], **kw)[0]


def sdpa_backward(fn, inputs, g):
    """A callable that runs only the backward of ``fn(*inputs)`` for the
    cotangent ``g`` (the forward is taken once, here), by
    ``torch.autograd.grad``: the library yardstick of K3 and K4."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def library_with_stats(q_l, k, v, mask, *, scale):
    """K1's function with its stats as one library call, the yardstick of
    K1's training launch (timed beside it, never used by the port):
    memory-efficient attention with ``compute_log_sumexp`` returns BV and
    the log-sum-exp m + log l, under the additive form of ``mask``."""
    import torch

    # the kernel wants the bias's row stride a multiple of 8: pad the key
    # axis and take a view of the first n columns
    c, n = mask.shape
    bias = torch.zeros((c, -(-n // 8) * 8), dtype=q_l.dtype, device=q_l.device)[:, :n]
    bias = bias.masked_fill_(~mask, float("-inf"))[None, None].expand(
        1, q_l.shape[0], c, n)
    fn = partial(torch.ops.aten._scaled_dot_product_efficient_attention,
                 q_l[None], k[None], v[None], bias, True, scale=scale)
    fn.label = "efficient attention, additive mask, with log-sum-exp"
    return fn


def split_key_checks(torch, dev) -> None:
    """K1 and K3 where the split-key grid of their bf16 kernels has its
    edges, each in bf16 and in fp32 (the fp32 kernels take the same
    arguments), at the training shape (56 batch-heads, n 4096): c = 16 and
    32 under the causal mask (with d = 128, and the smaller head dims of
    whisper and the reduced configs); kv_valid inside the first key chunk
    (one chunk: the direct write), at a length that is not a multiple of
    the chunk, causal and not, and 0 (no chunk: out 0, m -1e30, l 0, all
    gradients 0); K1 and K3 at c = 128 (two row tiles). K3's dK and dV past
    kv_valid must be exact zeros and its three gradients bitwise identical
    over two launches."""
    from repro_torch.kernels.ss_attention import (chunk_plan, landmark_summary,
                                                  landmark_summary_plain)
    from repro_torch.kernels.ss_attention_bwd import (landmark_summary_bwd,
                                                      landmark_summary_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(5)
    b, n = 56, 4096

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    # (c, d, causal, kv_valid): Qwen2-7B's d = 128, whisper's c = 32 and
    # d = 64, the reduced configs' c = 16 and d = 32
    cases = ((16, 128, True, None), (32, 128, True, None), (64, 128, False, 40),
             (64, 128, False, 1000), (64, 128, True, 1000), (64, 128, False, 0),
             (128, 128, True, None), (32, 64, True, None), (16, 32, False, 333))
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for c, d, causal, kvv in cases:
            scale = d**-0.5
            seg = -(-n // c) if causal else 0
            end = n if kvv is None else kvv
            plan = chunk_plan(b, c, n, seg=seg, kv_end=end)
            label = (f"b={b} c={c} n={n} d={d} {'causal' if causal else 'bidir'} "
                     f"kv_valid={end} {dname} ({plan.chunks} chunks of "
                     f"{plan.chunk_keys} keys in bf16)")
            q_l, k, v = randn(b, c, d, s=0.5, dtype=dt), randn(b, n, d, s=0.5, dtype=dt), randn(b, n, d, dtype=dt)
            bv, m, l = landmark_summary(q_l, k, v, scale=scale, causal=causal,
                                        kv_valid=kvv, return_stats=True)
            rbv, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, seg=seg,
                                                 kv_end=end, return_stats=True)
            check(f"K1 split-key {label}",
                  [("out", bv, rbv, None), ("m", m, rm, None), ("l", l, rl, None)])
            g = randn(b, c, d, dtype=dt)
            out = landmark_summary_bwd(q_l, k, v, bv, m, l, g, scale=scale,
                                       causal=causal, kv_valid=kvv)
            dcoef = torch.sum(g.float() * bv.float(), dim=-1, keepdim=True)
            ref = landmark_summary_bwd_plain(q_l, k, v, g, m, l, dcoef, scale=scale,
                                             seg=seg, kv_end=end)
            check(f"K3 split-key {label}",
                  [(nm, o, r, None) for nm, o, r in zip(("dq_l", "dk", "dv"), out, ref)])
            if not (torch.all(out[1][:, end:] == 0) and torch.all(out[2][:, end:] == 0)):
                raise AssertionError(f"K3 {label}: dK/dV past kv_valid must be zeros")
            if end == 0 and not torch.all(out[0] == 0):
                raise AssertionError(f"K3 {label}: dQ~ with no valid key must be zeros")
            again = landmark_summary_bwd(q_l, k, v, bv, m, l, g, scale=scale,
                                         causal=causal, kv_valid=kvv)
            if not all(torch.equal(a, b_) for a, b_ in zip(out, again)):
                raise AssertionError(f"K3 {label}: two launches differ")
    log("split-key K1/K3: dK/dV past kv_valid exact zeros, K3 bitwise identical "
        "over two launches in every case")


def query_tile_checks(torch, dev) -> None:
    """K2 and K4 where the query-tile runs of their bf16 kernels have their
    edges, each in bf16 and in fp32 (the fp32 kernels take the same
    arguments), over 56 batch-heads: n = 1, 63, 65 (inside, at and past one
    64-row tile), 352 (the serving bucket) and 4000 (ragged runs); no mask
    and the segment-causal F-mask with q_offset 37 (K2) and 1000 (K4); c =
    16, 32 and 64 (the landmark axis padded in shared memory) with d = dv =
    128, and c = 64 with d = 128, dv = 64. Both kernels' outputs must be
    bitwise identical over two launches."""
    from repro_torch.kernels.ss_attention import (query_side, query_side_plain,
                                                  query_tile_plan)
    from repro_torch.kernels.ss_attention_bwd import (query_side_bwd,
                                                      query_side_bwd_plain,
                                                      query_side_bwd_plan)

    gen = torch.Generator(device=dev).manual_seed(6)
    b, d = 56, 128
    scale = d**-0.5

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    names = ("dq", "dk_l", "dm", "dv", "ddelta")
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for n in (1, 63, 65, 352, 4000):
            for c, dv in ((16, 128), (32, 128), (64, 128), (64, 64)):
                q, k_l = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
                m_mat, v = randn(b, c, dv, dtype=dt), randn(b, n, dv, dtype=dt)
                g, delta = randn(b, n, dv, dtype=dt), randn(b, 1, 1, s=0.1).abs()
                for causal, off in ((False, 0), (True, 37), (True, 1000)):
                    seq_len_k = 2 * n + off
                    seg = -(-seq_len_k // c) if causal else 0
                    kw = dict(scale=scale, causal=causal, seq_len_k=seq_len_k,
                              q_offset=off)
                    ref_kw = dict(scale=scale, seg=seg, pos_offset=off if causal else 0)
                    label = (f"b={b} n={n} c={c} d={d} dv={dv} "
                             f"{f'causal seg={seg} q_offset={off}' if causal else 'bidir'} "
                             f"{dname}")
                    if off != 1000:   # K2: no mask, and q_offset 37
                        plan = query_tile_plan(b, n)
                        out = query_side(q, k_l, m_mat, v, delta, **kw)
                        check(f"K2 query-tile {label} ({plan.runs} runs of "
                              f"{plan.run_rows} rows in bf16)",
                              [("out", out, query_side_plain(q, k_l, m_mat, v, delta,
                                                             **ref_kw), None)])
                        if not torch.equal(out, query_side(q, k_l, m_mat, v, delta, **kw)):
                            raise AssertionError(f"K2 {label}: two launches differ")
                    if off != 37:     # K4: no mask, and q_offset 1000
                        plan = query_side_bwd_plan(b, n)
                        out = query_side_bwd(q, k_l, m_mat, v, delta, g, **kw)
                        ref = query_side_bwd_plain(q, k_l, m_mat, v, delta, g, **ref_kw)
                        check(f"K4 query-tile {label} ({plan.runs} runs of "
                              f"{plan.run_rows} rows)",
                              [(nm, o, r, None) for nm, o, r in zip(names, out, ref)])
                        again = query_side_bwd(q, k_l, m_mat, v, delta, g, **kw)
                        if not all(torch.equal(a, b_) for a, b_ in zip(out, again)):
                            raise AssertionError(f"K4 {label}: two launches differ")
    log("query-tile K2/K4: every case within tolerance, both bitwise identical "
        "over two launches")


def paged_inputs(torch, dev, gen, kv_valid, *, hkv=4, r=7, d=128, dv=128, bs=16,
                 n_slots=32, dtype=None, poison=False):
    """K5's operands: q, K and V pools and a block table with distinct
    random blocks per lane (block 0, ZERO_BLOCK, fills the slots past each
    lane's allocation; a lane with kv_valid 0 holds one allocated block).
    With ``poison`` the pools come twice, the second copy with NaN in
    every row no valid key reads (ZERO_BLOCK, blocks no lane's valid keys
    reach, and the rows past kv_valid in a lane's last block), so a
    kernel that reads or weighs one of them shows it."""
    dtype = dtype or torch.float32
    lanes = len(kv_valid)
    used = [max(-(-k // bs), 1) for k in kv_valid]
    nb = sum(used) + 2    # ZERO_BLOCK and one block no table holds
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(2)) + 1
    table = torch.zeros((lanes, n_slots), dtype=torch.int32)
    at = 0
    for ln, u in enumerate(used):
        table[ln, :u] = perm[at:at + u]
        at += u
    q = (torch.randn((lanes, hkv, r, d), generator=gen, device=dev) * 0.5).to(dtype)
    k_pool = (torch.randn((hkv, nb, bs, d), generator=gen, device=dev) * 0.5).to(dtype)
    v_pool = torch.randn((hkv, nb, bs, dv), generator=gen, device=dev).to(dtype)
    kvv = torch.tensor(kv_valid, dtype=torch.int32)
    out = (q, k_pool, v_pool, table.to(dev), kvv.to(dev))
    if not poison:
        return out
    keep = torch.zeros((nb, bs), dtype=torch.bool)
    for ln, k in enumerate(kv_valid):
        for slot in range(-(-k // bs)):
            keep[int(table[ln, slot]), :min(bs, k - slot * bs)] = True
    keep = keep.to(dev)[None, :, :, None]
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    return out + (torch.where(keep, k_pool, nan), torch.where(keep, v_pool, nan))


def long_horizon_entry(torch, dev, kv_valid=(2048, 4096, 8192, 16384)) -> dict:
    """K5's decode launch at a 16k horizon (4 lanes, 4 kv heads, r 7, bs 16,
    a table of 1024 slots, fp32 pools), held against its plain version and
    set up for timing: the pools (126 MB of valid K and V) exceed L2, so
    every launch reads them from device memory."""
    from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,
                                                  paged_row_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(8)
    lanes, hkv, r, d, bs, n_slots = len(kv_valid), 4, 7, 128, 16, 1024
    q, k_pool, v_pool, table, kvv = paged_inputs(torch, dev, gen, list(kv_valid),
                                                 hkv=hkv, r=r, bs=bs, n_slots=n_slots)
    scale = d**-0.5
    m, l, acc = paged_row_stats_lanes(q, (k_pool,), v_pool, table, kvv, scale=scale,
                                      block_size=bs)
    rm, rl, racc = paged_row_stats_plain(q, (k_pool,), v_pool, table, kvv, scale=scale)
    err = check(f"K5 paged_row_stats long horizon lanes={lanes} hkv={hkv} r={r} "
                f"bs={bs} slots={n_slots} kv_valid={list(kv_valid)} fp32",
                [("m", m, rm, None), ("l", l, rl, None), ("acc", acc, racc, None)])
    pools = cold_pools(k_pool, v_pool)
    return dict(
        fn=[partial(paged_row_stats_lanes, q, (kp,), vp, table, kvv, scale=scale,
                    block_size=bs) for kp, vp in pools],
        plain=[partial(paged_row_stats_plain, q, (kp,), vp, table, kvv, scale=scale)
               for kp, vp in pools],
        library=None, err=err, bound=k5_bound(kv_valid, hkv, r, d, d, bs),
        shape=f"lanes={lanes} hkv={hkv} r={r} bs={bs} slots={n_slots} "
              f"kv_valid={list(kv_valid)} fp32, L2 cold ({len(pools)} pool copies)")


def slot_chunk_checks(torch, dev) -> None:
    """K5 where its split-slot grid has its edges, each in fp32 and bf16,
    against the plain version at KERNEL_TOL (all outputs fp32). At bs 16
    (hkv 4): kv_valid 0, 1, 15, 16 and 17 (inside, at and past one block),
    one short of, at and one past a chunk's edge, every slot valid; a table
    of 1 slot (one chunk, the direct write), of 32 (the serving table) and
    of 1024 (a 16k horizon); r = 1, 7 and 8 query rows per kv head; dv = 64.
    Then the block sizes 8, 32, 48, 64 and 128 at r = 7 (a 2048-key table;
    blocks past 32 keys run as 32-key slices: kv_valid 31, 32, 33 at a
    slice's edge inside a block, and at a block's and a chunk's edge +-1),
    and r = 9, 16, 48, 64 and 96 at bs 64 with one kv head (granite-20b's 48
    on 1; 96 takes two row groups) over 512- and 16k-key tables. The kernel
    runs on pools with NaN in every row it must not read or weigh (plain:
    clean pools); a lane with kv_valid 0 must return exactly the anchor (m
    -1e30, l 0, acc 0), and two launches the same bits."""
    from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,
                                                  paged_row_stats_plain,
                                                  slot_chunk_plan)

    gen = torch.Generator(device=dev).manual_seed(7)

    def edges(n_slots, bs, lanes, hkv):
        edge = slot_chunk_plan(lanes, hkv, n_slots, bs).chunk_slots * bs
        kv = {0, 1, 15, 16, 17, 31, 32, 33, bs - 1, bs, bs + 1, edge - 1, edge,
              edge + 1, 3 * edge + 5, n_slots * bs}
        return sorted(k for k in kv if 0 <= k <= n_slots * bs)

    cases = []   # (n_slots, kv_valid per lane, hkv, r, dv, bs)
    for n_slots in (32, 1024):
        edge = slot_chunk_plan(10, 4, n_slots, 16).chunk_slots * 16   # 10 lanes below
        kv = [0, 1, 15, 16, 17, edge - 1, edge, edge + 1, 3 * edge + 5, n_slots * 16]
        cases += [(n_slots, kv, 4, 7, 128, 16), (n_slots, kv, 4, 1, 128, 16),
                  (n_slots, kv, 4, 8, 128, 16), (n_slots, kv, 4, 7, 64, 16)]
    cases.append((1, [0, 1, 15, 16], 4, 7, 128, 16))
    for bs in (8, 32, 48, 64, 128):
        n_slots = -(-2048 // bs)
        cases.append((n_slots, edges(n_slots, bs, 16, 4), 4, 7, 128, bs))
    for r in (9, 16, 48, 64, 96):
        for n_slots in (8, 256):
            cases.append((n_slots, edges(n_slots, 64, 16, 1), 1, r, 128, 64))
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        for n_slots, kv, hkv, r, dv, bs in cases:
            q, kp, vp, table, kvv, kp_nan, vp_nan = paged_inputs(
                torch, dev, gen, kv, hkv=hkv, r=r, dv=dv, bs=bs, n_slots=n_slots,
                dtype=dt, poison=True)
            plan = slot_chunk_plan(len(kv), hkv, n_slots, bs)
            label = (f"lanes={len(kv)} hkv={hkv} r={r} d=128 dv={dv} bs={bs} "
                     f"slots={n_slots} kv_valid={kv} {dname} ({plan.chunks} chunks of "
                     f"{plan.chunk_slots} slots)")
            out = paged_row_stats_lanes(q, (kp_nan,), vp_nan, table, kvv, scale=128**-0.5,
                                        block_size=bs)
            rm, rl, racc = paged_row_stats_plain(q, (kp,), vp, table, kvv,
                                                 scale=128**-0.5)
            m, l, acc = out
            live = rl[..., 0] > 0
            check(f"K5 split-slot {label}",
                  [("m", m[..., 0], rm[..., 0], live), ("l", l, rl, None),
                   ("acc", acc, racc, None)])
            empty = [i for i, k in enumerate(kv) if k == 0]
            if not (torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0)
                    and torch.all(acc[empty] == 0)):
                raise AssertionError(f"K5 {label}: a lane with kv_valid 0 must "
                                     f"return exactly (m=-1e30, l=0, acc=0)")
            again = paged_row_stats_lanes(q, (kp_nan,), vp_nan, table, kvv,
                                          scale=128**-0.5, block_size=bs)
            if not all(torch.equal(a, b) for a, b in zip(out, again)):
                raise AssertionError(f"K5 {label}: two launches differ")
    log(f"split-slot K5: all {2 * len(cases)} cases within tolerance on NaN-poisoned "
        f"unread rows, kv_valid-0 lanes exactly the anchor, bitwise identical over "
        f"two launches")


def granite_k5_entries(torch, dev) -> dict:
    """K5 at granite-20b's decode shape (4 lanes, 1 kv head, r = 48 query
    rows, d = dv = 128, bs 64, fp32 pools as the engine stores them) at a
    512-key horizon (kv_valid 48/200/333/480, phase 4's prompts) and a 16k
    horizon (2k-16k keys), each held against its plain version and set up
    for timing with L2 cold. At r = 48 it is bound by operations: 24 flops
    per byte of fp32 K and V against the FMA ridge of about 20."""
    from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,
                                                  paged_row_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(9)
    hkv, r, d, bs = 1, 48, 128, 64
    out = {}
    for tag, kv, n_slots in (("paged_row_stats_granite", [48, 200, 333, 480], 8),
                             ("paged_row_stats_granite_long",
                              [2048, 4096, 8192, 16384], 256)):
        q, k_pool, v_pool, table, kvv = paged_inputs(torch, dev, gen, kv, hkv=hkv, r=r,
                                                     bs=bs, n_slots=n_slots)
        scale = d**-0.5
        m, l, acc = paged_row_stats_lanes(q, (k_pool,), v_pool, table, kvv, scale=scale,
                                          block_size=bs)
        rm, rl, racc = paged_row_stats_plain(q, (k_pool,), v_pool, table, kvv,
                                             scale=scale)
        shape = (f"granite-20b decode: lanes=4 hkv={hkv} r={r} d=dv={d} bs={bs} "
                 f"slots={n_slots} kv_valid={kv} fp32")
        err = check(f"K5 {shape}", [("m", m, rm, None), ("l", l, rl, None),
                                    ("acc", acc, racc, None)])
        pools = cold_pools(k_pool, v_pool)
        out[tag] = dict(
            fn=[partial(paged_row_stats_lanes, q, (kp,), vp, table, kvv, scale=scale,
                        block_size=bs) for kp, vp in pools],
            plain=[partial(paged_row_stats_plain, q, (kp,), vp, table, kvv, scale=scale)
                   for kp, vp in pools],
            library=None, err=err, bound=k5_bound(kv, hkv, r, d, d, bs),
            shape=f"{shape}, L2 cold ({len(pools)} pool copies)")
    return out


def granite_ss_checks(torch, dev) -> None:
    """K1 and K2 at granite-20b's prefill shapes on phase 4's path: one
    lane of 48 heads (b = 48 batch-heads: 1 kv head broadcast to 48), c =
    64, d = dv = 128; block 64 rounds the 32-token prefill bucket to 64, so
    phase 4's prompts of 200/333/480 tokens pad to n = 256/384/512 (the
    48-token prompt takes the exact-attention window, no kernel). K1 in
    bf16 without stats (ss_attention_fused) and with fp32 landmark means
    over bf16 k/v with stats (the stream-state seed), K2 in bf16, each held
    against its plain version at KERNEL_TOL."""
    from repro_torch.kernels.ss_attention import (landmark_summary,
                                                  landmark_summary_plain,
                                                  query_side, query_side_plain)

    gen = torch.Generator(device=dev).manual_seed(10)
    b, c, d = 48, 64, 128
    scale = d**-0.5
    bf16 = torch.bfloat16

    def randn(*shape, s=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    for n, kvv in ((256, 200), (384, 333), (512, 480)):
        k, v = randn(b, n, d, s=0.5), randn(b, n, d)
        for q_dt, stats in ((bf16, False), (torch.float32, True)):
            q_l = randn(b, c, d, s=0.5, dtype=q_dt)
            out = landmark_summary(q_l, k, v, scale=scale, kv_valid=kvv, return_stats=stats)
            ref = landmark_summary_plain(q_l, k, v, scale=scale, kv_end=kvv,
                                         return_stats=stats)
            names = ("out", "m", "l") if stats else ("out",)
            outs, refs = (out, ref) if stats else ((out,), (ref,))
            check(f"K1 granite-20b prefill b={b} c={c} n={n} kv_valid={kvv} q={q_dt} "
                  f"kv=bf16{' with stats' if stats else ''}",
                  [(nm, o, r_, None) for nm, o, r_ in zip(names, outs, refs)])
        q, k_l, m_mat = randn(b, n, d, s=0.5), randn(b, c, d, s=0.5), randn(b, c, d)
        delta = randn(b, 1, 1, s=0.1, dtype=torch.float32).abs()
        check(f"K2 granite-20b prefill b={b} n={n} c={c} bf16",
              [("out", query_side(q, k_l, m_mat, v, delta, scale=scale),
                query_side_plain(q, k_l, m_mat, v, delta, scale=scale), None)])


# DeepSeek-V2-Lite's attention (configs/deepseek_v2_lite_16b.py): 16 heads,
# absorbed MLA keys of kv_lora 512 + rope 64 = 576 columns, the 512-wide
# latents as values, scale (128 + 64) ** -0.5.
MLA_HEADS, MLA_LORA, MLA_ROPE, MLA_SCALE = 16, 512, 64, (128 + 64) ** -0.5


def mla_pools(torch, dev, gen, kv_valid, *, bs=16, n_slots=32, r=MLA_HEADS,
              dtype=None, poison=False):
    """K5's MLA operands: q (lanes, 1, r, 576), the latent pool (1, nb, bs,
    512) and the rope pool (1, nb, bs, 64) from ``paged_inputs`` (its K pool
    is the latent pool, which is also the value pool), and with ``poison``
    both pools again with NaN in every row no valid key reads."""
    out = paged_inputs(torch, dev, gen, kv_valid, hkv=1, r=r, d=MLA_LORA + MLA_ROPE,
                       dv=MLA_LORA, bs=bs, n_slots=n_slots, dtype=dtype, poison=poison)
    q, k_pool, _, table, kvv = out[:5]
    lat, rope = k_pool[..., :MLA_LORA].contiguous(), k_pool[..., MLA_LORA:].contiguous()
    res = (q, lat, rope, table, kvv)
    if poison:
        kp = out[5]
        res += (kp[..., :MLA_LORA].contiguous(), kp[..., MLA_LORA:].contiguous())
    return res


def mla_kernel_entries(torch, dev) -> dict:
    """K1, K2 and K5 at DeepSeek-V2-Lite's serving shapes (phase 4's
    ``serve_deepseek``), each against its plain version at KERNEL_TOL in
    fp32 and bf16, and set up for timing. Prefill runs one request of 16
    heads (b = 16 batch-heads, the latent+rope key stream broadcast to
    them), c = 64, d = 576, dv = 512; the 32-token bucket pads the 200 /
    333 / 480-token prompts to n = 224 / 352 / 480 (the 48-token prompt is
    the exact-attention window, no kernel). K1 in bf16 without stats
    (ss_attention_fused) and with fp32 landmark means over bf16 keys with
    stats (the seed), at the chunk site (a 128-key window, kv_valid 48 / 77
    / 128), and K2 in bf16; the fp32 kernels at the same shapes. K5 with
    two key pools (latent 512 + rope 64, the latent pool the value pool):
    4 lanes, 1 kv head, r = 16, block 16, kv_valid 0 / 17 / 300 / 512 and
    at a 16k horizon, in fp32 and bf16, the same keys in one concatenated
    576-wide pool with a separate value pool (the wide kernel without the
    alias), and its split-slot edges on NaN-poisoned pools at block 16 and
    at block 64 (16-key slices of a block)."""
    from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,
                                                  paged_row_stats_plain)
    from repro_torch.kernels.ss_attention import (landmark_summary,
                                                  landmark_summary_plain,
                                                  query_side, query_side_plain)

    gen = torch.Generator(device=dev).manual_seed(11)
    b, c, d, dv = MLA_HEADS, 64, MLA_LORA + MLA_ROPE, MLA_LORA
    scale = MLA_SCALE
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, s=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    entries = {}
    # ---- K1: prefill (bf16, no stats) and the seed (fp32 q~, bf16 k/v, stats)
    for n, kvv in ((224, 200), (352, 333), (480, 480)):
        for q_dt, kv_dt, stats in ((f32, f32, True), (bf16, bf16, False),
                                   (f32, bf16, True)):
            q_l = randn(b, c, d, s=0.5, dtype=q_dt)
            k, v = randn(b, n, d, s=0.5, dtype=kv_dt), randn(b, n, dv, dtype=kv_dt)
            out = landmark_summary(q_l, k, v, scale=scale, kv_valid=kvv,
                                   return_stats=stats)
            ref = landmark_summary_plain(q_l, k, v, scale=scale, kv_end=kvv,
                                         return_stats=stats)
            names = ("out", "m", "l") if stats else ("out",)
            outs, refs = (out, ref) if stats else ((out,), (ref,))
            err = check(f"K1 MLA prefill b={b} c={c} n={n} kv_valid={kvv} d={d} dv={dv} "
                        f"q={q_dt} kv={kv_dt}{' with stats' if stats else ''}",
                        [(nm, o, r_, None) for nm, o, r_ in zip(names, outs, refs)])
            if n != 352 or kv_dt != bf16:
                continue
            mask = torch.arange(n, device=dev)[None, :] < kvv
            entries["mla_landmark_summary_stats" if stats else "mla_landmark_summary"] = dict(
                fn=partial(landmark_summary, q_l, k, v, scale=scale, kv_valid=kvv,
                           return_stats=stats),
                plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, kv_end=kvv,
                              return_stats=stats),
                library=None if stats else partial(
                    torch.nn.functional.scaled_dot_product_attention, q_l[None], k[None],
                    v[None], attn_mask=mask.expand(c, n), scale=scale),
                err=err, bound=k1_bound(b, c, kvv, d, dv, b * c * kvv,
                                        q_bytes=q_l.element_size(), stats=stats),
                shape=(f"b={b} c={c} n={n} kv_valid={kvv} d={d} dv={dv} "
                       + ("fp32 q, bf16 k/v, with stats (MLA seed)" if stats
                          else "bf16, no stats (MLA ss_attention_fused)")))
    # the chunk site: fp32 landmark means against a bf16 window of 128 keys
    n = 128
    q_l = randn(b, c, d, s=0.5, dtype=f32)
    k, v = randn(b, n, d, s=0.5), randn(b, n, dv)
    for kvv in (48, 77, 128):
        out, m, l = landmark_summary(q_l, k, v, scale=scale, kv_valid=kvv,
                                     return_stats=True)
        ref, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, kv_end=kvv,
                                             return_stats=True)
        err = check(f"K1 MLA chunk site b={b} c={c} n={n} kv_valid={kvv} fp32 q, bf16 k/v",
                    [("out", out, ref, None), ("m", m, rm, None), ("l", l, rl, None)])
    entries["mla_landmark_summary_chunk"] = dict(
        fn=partial(landmark_summary, q_l, k, v, scale=scale, kv_valid=n, return_stats=True),
        plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, kv_end=n,
                      return_stats=True),
        library=None, err=err,
        bound=k1_bound(b, c, n, d, dv, b * c * n, q_bytes=4, stats=True),
        shape=f"b={b} c={c} n={n} kv_valid={n} d={d} dv={dv} fp32 q, bf16 k/v, with "
              f"stats (MLA chunk site; no library call takes mixed dtypes)")

    # ---- K2 ------------------------------------------------------------------
    for n in (224, 352, 480):
        for dt in (f32, bf16):
            q, k_l = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
            m_mat, v = randn(b, c, dv, dtype=dt), randn(b, n, dv, dtype=dt)
            delta = randn(b, 1, 1, s=0.1, dtype=f32).abs()
            err = check(f"K2 MLA prefill b={b} n={n} c={c} d={d} dv={dv} {dt}",
                        [("out", query_side(q, k_l, m_mat, v, delta, scale=scale),
                          query_side_plain(q, k_l, m_mat, v, delta, scale=scale), None)])
            if (n, dt) == (352, bf16):
                entries["mla_query_side"] = dict(
                    fn=partial(query_side, q, k_l, m_mat, v, delta, scale=scale),
                    plain=partial(query_side_plain, q, k_l, m_mat, v, delta, scale=scale),
                    library=partial(sdpa_query_side, q, k_l, m_mat, v, delta, scale=scale),
                    err=err, bound=k2_bound(b, n, c, d, dv, b * n * c),
                    shape=f"b={b} n={n} c={c} d={d} dv={dv} bf16 (MLA)")

    # ---- K5: two key pools, the latent pool also the value pool --------------
    def k5_case(label, kv_valid, dtype, bs=16, n_slots=32, poison=False):
        ops_ = mla_pools(torch, dev, gen, kv_valid, bs=bs, n_slots=n_slots, dtype=dtype,
                         poison=poison)
        q, lat, rope, table, kvv = ops_[:5]
        klat, krope = ops_[5:] if poison else (lat, rope)
        m, l, acc = paged_row_stats_lanes(q, (klat, krope), klat, table, kvv,
                                          scale=scale, block_size=bs)
        rm, rl, racc = paged_row_stats_plain(q, (lat, rope), lat, table, kvv, scale=scale)
        live = rl[..., 0] > 0
        empty = [i for i, x in enumerate(kv_valid) if x == 0]
        if empty and not (torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0)
                          and torch.all(acc[empty] == 0)):
            raise AssertionError(f"{label}: a lane with kv_valid = 0 must return the anchor")
        err = check(f"{label} lanes={len(kv_valid)} hkv=1 r={q.shape[2]} bs={bs} "
                    f"slots={n_slots} kv_valid={kv_valid} pools 512+64 {dtype}",
                    [("m", m[..., 0], rm[..., 0], live), ("l", l, rl, None),
                     ("acc", acc, racc, None)])
        return err, (q, lat, rope, table, kvv), (m, l, acc)

    serve_kv = [0, 17, 300, 512]
    for dt in (f32, bf16):
        err, (q, lat, rope, table, kvv), two = k5_case("K5 MLA two pools", serve_kv, dt)
        # the same keys in one 576-wide pool and the latents as a separate
        # value pool: the wide kernel without the alias
        one = paged_row_stats_lanes(q, (torch.cat([lat, rope], -1),), lat.clone(), table,
                                    kvv, scale=scale, block_size=16)
        check(f"K5 MLA one concatenated pool vs two pools {dt}",
              [(nm, o, t, None) for nm, o, t in zip(("m", "l", "acc"), one, two)])
        if dt == bf16:
            pools = cold_pools(lat, rope)
            entries["mla_paged_row_stats"] = dict(
                fn=[partial(paged_row_stats_lanes, q, (lp, rp), lp, table, kvv,
                            scale=scale, block_size=16) for lp, rp in pools],
                warm=partial(paged_row_stats_lanes, q, (lat, rope), lat, table, kvv,
                             scale=scale, block_size=16),
                plain=[partial(paged_row_stats_plain, q, (lp, rp), lp, table, kvv,
                               scale=scale) for lp, rp in pools],
                library=None, err=err,
                bound=k5_bound(serve_kv, 1, MLA_HEADS, d, dv, 16, es=2, v_is_key=True),
                shape=f"lanes=4 hkv=1 r={MLA_HEADS} bs=16 slots=32 kv_valid={serve_kv} "
                      f"pools 512+64 (latent = values) bf16, L2 cold ({len(pools)} copies)")
    long_kv = [2048, 4096, 8192, 16384]
    err, (q, lat, rope, table, kvv), _ = k5_case("K5 MLA long horizon", long_kv, bf16,
                                                 n_slots=1024)
    pools = cold_pools(lat, rope)
    entries["mla_paged_row_stats_long"] = dict(
        fn=[partial(paged_row_stats_lanes, q, (lp, rp), lp, table, kvv, scale=scale,
                    block_size=16) for lp, rp in pools],
        plain=[partial(paged_row_stats_plain, q, (lp, rp), lp, table, kvv, scale=scale)
               for lp, rp in pools],
        library=None, err=err,
        bound=k5_bound(long_kv, 1, MLA_HEADS, d, dv, 16, es=2, v_is_key=True),
        shape=f"lanes=4 hkv=1 r={MLA_HEADS} bs=16 slots=1024 kv_valid={long_kv} pools "
              f"512+64 (latent = values) bf16, L2 cold ({len(pools)} copies)")
    # split-slot edges on NaN-poisoned pools: whole blocks (bs 16) and 16-key
    # slices of a block (bs 64), one and several chunks
    for bs, n_slots, kvs in ((16, 32, [0, 1, 15, 16, 17, 31, 32, 33, 300, 512]),
                             (16, 1024, [1, 33, 5000, 16384]),
                             (64, 8, [0, 1, 15, 16, 17, 63, 64, 65, 200, 512])):
        for dt in (f32, bf16):
            k5_case("K5 MLA slot edges (poisoned)", kvs, dt, bs=bs, n_slots=n_slots,
                    poison=True)
    return entries


def train_kernel_entries(torch, dev, b: int = 56, d: int = 128, tile: int = 0,
                         c: int = 64, repeat: bool = False) -> dict:
    """Held and timed entries of the training path's kernel launches at its
    shapes (batch 2 x 28 heads, seq 4096, c 64, d 128, causal: seg 64; or
    ``b`` batch-heads of head dim ``d``, paper-bert's 64 x 64; or ``c``
    landmarks, seg ceil(4096 / c)): K1 with stats and K2 forward, K3 and K4
    backward, each against its plain version in fp32 (TF32 off) and bf16,
    plus K3 with kv_valid and K4 with a q_offset. ``tile`` > 0 launches
    every kernel at that tiling (a dispatch plan's ``block_n``: K1 / K3
    ``chunk_keys``, K2 / K4 ``run_rows``), which the fp32 kernels of K1-K3
    do not use. With ``repeat`` each backward launch is made twice and the
    two must be bitwise equal. Timing entries are the bf16 causal
    launches."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.ss_attention import (b_side_mask, landmark_summary,
                                                  landmark_summary_plain,
                                                  query_side, query_side_plain)
    from repro_torch.kernels.ss_attention_bwd import (landmark_summary_bwd,
                                                      landmark_summary_bwd_plain,
                                                      query_side_bwd,
                                                      query_side_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(4)
    n = 4096
    seg = -(-n // c)
    scale = d**-0.5
    k13, k24 = dict(chunk_keys=tile), dict(run_rows=tile)
    at = f" tile={tile}" if tile else ""

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    # attended (row, key) and (query, column) pairs under the causal masks,
    # the work the data needs
    pairs1 = b * cost.b_side_pairs(c, n, seg=seg)
    pairs2 = b * cost.f_side_pairs(n, c, seg=seg)
    fmask = torch.arange(c, device=dev)[None, :] <= (torch.arange(n, device=dev) // seg)[:, None]
    entries = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        es = 2 if dt == torch.bfloat16 else 4
        # ---- K1 with stats, causal ---------------------------------------
        q_l, k, v = randn(b, c, d, s=0.5, dtype=dt), randn(b, n, d, s=0.5, dtype=dt), randn(b, n, d, dtype=dt)
        bv, m, l = landmark_summary(q_l, k, v, scale=scale, causal=True, return_stats=True,
                                    **k13)
        rbv, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, seg=seg,
                                             return_stats=True)
        err1 = check(f"K1 landmark_summary train b={b} c={c} n={n} d={d} causal stats "
                     f"{dname}{at}",
                     [("out", bv, rbv, None), ("m", m, rm, None), ("l", l, rl, None)])
        # ---- K3 -------------------------------------------------------------
        g = randn(b, c, d, dtype=dt)
        dcoef = torch.sum(g.float() * bv.float(), dim=-1, keepdim=True)
        out = landmark_summary_bwd(q_l, k, v, bv, m, l, g, scale=scale, causal=True,
                                   **k13)
        ref = landmark_summary_bwd_plain(q_l, k, v, g, m, l, dcoef, scale=scale, seg=seg)
        err3 = check(f"K3 landmark_summary_bwd b={b} c={c} n={n} d={d} causal {dname}{at}",
                     [(nm, o, r, None) for nm, o, r in zip(("dq_l", "dk", "dv"), out, ref)])
        if repeat:
            again = landmark_summary_bwd(q_l, k, v, bv, m, l, g, scale=scale, causal=True,
                                         **k13)
            if not all(torch.equal(a, b_) for a, b_ in zip(out, again)):
                raise AssertionError(f"K3 b={b} c={c} d={d} {dname}: two launches differ")
        kvv = 3000
        bv2, m2, l2 = landmark_summary(q_l, k, v, scale=scale, kv_valid=kvv, return_stats=True,
                                       **k13)
        out = landmark_summary_bwd(q_l, k, v, bv2, m2, l2, g, scale=scale, kv_valid=kvv,
                                   **k13)
        dcoef2 = torch.sum(g.float() * bv2.float(), dim=-1, keepdim=True)
        ref = landmark_summary_bwd_plain(q_l, k, v, g, m2, l2, dcoef2, scale=scale, kv_end=kvv)
        check(f"K3 landmark_summary_bwd b={b} c={c} n={n} d={d} kv_valid={kvv} {dname}{at}",
              [(nm, o, r, None) for nm, o, r in zip(("dq_l", "dk", "dv"), out, ref)])
        if not (torch.all(out[1][:, kvv:] == 0) and torch.all(out[2][:, kvv:] == 0)):
            raise AssertionError("K3: keys at or past kv_valid must get zero dK/dV")
        if dt == torch.bfloat16:
            bmask = b_side_mask(c, n, seg=seg, device=dev)
            entries["landmark_summary_train"] = dict(
                fn=partial(landmark_summary, q_l, k, v, scale=scale, causal=True,
                           return_stats=True, **k13),
                plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, seg=seg,
                              return_stats=True),
                library=library_with_stats(q_l, k, v, bmask, scale=scale), err=err1,
                bound=k1_bound(b, c, n, d, d, pairs1, q_bytes=es, kv_bytes=es, out_bytes=es,
                               stats=True),
                shape=f"b={b} c={c} n={n} seg={seg} d=dv={d} bf16, causal, with "
                      f"stats (training forward){at}")
            entries["landmark_summary_bwd"] = dict(
                fn=partial(landmark_summary_bwd, q_l, k, v, bv, m, l, g, scale=scale,
                           causal=True, **k13),
                plain=partial(landmark_summary_bwd_plain, q_l, k, v, g, m, l, dcoef,
                              scale=scale, seg=seg),
                library=sdpa_backward(partial(sdpa_4d, attn_mask=bmask, scale=scale),
                                      (q_l, k, v), g),
                err=err3,
                bound=k3_bound(b, c, n, d, d, pairs1, es),
                shape=f"b={b} c={c} n={n} seg={seg} d=dv={d} bf16, causal{at}")
        # ---- K2 causal and K4 -------------------------------------------
        q, k_l = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
        m_mat, v = randn(b, c, d, dtype=dt), randn(b, n, d, dtype=dt)
        delta = randn(b, 1, 1, s=0.1).abs()
        err2 = check(f"K2 query_side train b={b} n={n} c={c} d={d} causal {dname}{at}",
                     [("out", query_side(q, k_l, m_mat, v, delta, scale=scale, causal=True,
                                         **k24),
                       query_side_plain(q, k_l, m_mat, v, delta, scale=scale, seg=seg), None)])
        g = randn(b, n, d, dtype=dt)
        names = ("dq", "dk_l", "dm", "dv", "ddelta")
        out = query_side_bwd(q, k_l, m_mat, v, delta, g, scale=scale, causal=True, **k24)
        ref = query_side_bwd_plain(q, k_l, m_mat, v, delta, g, scale=scale, seg=seg)
        err4 = check(f"K4 query_side_bwd b={b} n={n} c={c} d={d} causal {dname}{at}",
                     [(nm, o, r, None) for nm, o, r in zip(names, out, ref)])
        if repeat:
            again = query_side_bwd(q, k_l, m_mat, v, delta, g, scale=scale, causal=True,
                                   **k24)
            if not all(torch.equal(a, b_) for a, b_ in zip(out, again)):
                raise AssertionError(f"K4 b={b} c={c} d={d} {dname}: two launches differ")
        out = query_side_bwd(q, k_l, m_mat, v, delta, g, scale=scale, causal=True,
                             seq_len_k=2 * n, q_offset=1000, **k24)
        ref = query_side_bwd_plain(q, k_l, m_mat, v, delta, g, scale=scale,
                                   seg=-(-2 * n // c), pos_offset=1000)
        check(f"K4 query_side_bwd b={b} n={n} c={c} d={d} causal q_offset=1000 "
              f"seq_len_k={2 * n} {dname}{at}",
              [(nm, o, r, None) for nm, o, r in zip(names, out, ref)])
        if dt == torch.bfloat16:
            entries["query_side_train"] = dict(
                fn=partial(query_side, q, k_l, m_mat, v, delta, scale=scale, causal=True,
                           **k24),
                plain=partial(query_side_plain, q, k_l, m_mat, v, delta, scale=scale,
                              seg=seg),
                library=partial(sdpa_query_side, q, k_l, m_mat, v, delta, scale=scale,
                                attn_mask=fmask),
                err=err2,
                bound=k2_bound(b, n, c, d, d, pairs2, es),
                shape=f"b={b} n={n} c={c} seg={seg} d=dv={d} bf16, causal "
                      f"(training forward){at}")
            entries["query_side_bwd"] = dict(
                fn=partial(query_side_bwd, q, k_l, m_mat, v, delta, g, scale=scale,
                           causal=True, **k24),
                plain=partial(query_side_bwd_plain, q, k_l, m_mat, v, delta, g,
                              scale=scale, seg=seg),
                library=sdpa_backward(partial(sdpa_query_side, scale=scale,
                                              attn_mask=fmask),
                                      (q, k_l, m_mat, v, delta), g),
                err=err4,
                bound=k4_bound(b, n, c, d, d, pairs2, es),
                shape=f"b={b} n={n} c={c} seg={seg} d=dv={d} bf16, causal{at}")
    return entries


# Landmark counts past 64 held in phase 2 (c = 96: a partial last tile of
# 64 columns / rows) and the ones timed there.
WIDE_C = (96, 128, 256)
WIDE_C_TIMED = (128, 256)


def serve_wide_c_entries(torch, dev, c: int) -> dict:
    """K1 and K2 at the serving shape (28 batch-heads, n 352, kv_valid 333,
    d 128) with ``c`` landmarks, against their plain versions in fp32 and
    bf16: K1 bf16 without stats (``ss_attention_fused``'s launch) and fp32
    landmark means against bf16 keys with stats (the seed's), K2 on the
    padded bucket. Timing entries: the bf16 launches and the seed's."""
    from repro_torch.kernels.ss_attention import (landmark_summary,
                                                  landmark_summary_plain,
                                                  query_side, query_side_plain)

    gen = torch.Generator(device=dev).manual_seed(7)
    b, n, kv_valid, d = 28, 352, 333, 128
    scale = d**-0.5

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    entries = {}
    for q_dt, kv_dt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.bfloat16)):
        q_l = randn(b, c, d, s=0.5, dtype=q_dt)
        k, v = randn(b, n, d, s=0.5, dtype=kv_dt), randn(b, n, d, dtype=kv_dt)
        out, m, l = landmark_summary(q_l, k, v, scale=scale, kv_valid=kv_valid,
                                     return_stats=True)
        ref, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, kv_end=kv_valid,
                                             return_stats=True)
        err = check(f"K1 landmark_summary serve b={b} c={c} n={n} kv_valid={kv_valid} "
                    f"q={q_dt} kv={kv_dt}",
                    [("out", out, ref, None), ("m", m, rm, None), ("l", l, rl, None)])
        if kv_dt != torch.bfloat16:
            continue
        stats = q_dt == torch.float32
        mask = (torch.arange(n, device=dev)[None, :] < kv_valid).expand(c, n)
        entries[f"c{c}_serve_landmark_summary" + ("_stats" if stats else "")] = dict(
            fn=partial(landmark_summary, q_l, k, v, scale=scale, kv_valid=kv_valid,
                       return_stats=stats),
            plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, kv_end=kv_valid,
                          return_stats=stats),
            library=None if stats else partial(
                torch.nn.functional.scaled_dot_product_attention, q_l[None], k[None],
                v[None], attn_mask=mask, scale=scale),
            err=err, bound=k1_bound(b, c, kv_valid, d, d, b * c * kv_valid,
                                    q_bytes=q_l.element_size(), stats=stats),
            shape=(f"b={b} c={c} n={n} kv_valid={kv_valid} d=dv={d} "
                   + ("fp32 q, bf16 k/v, with stats (seed)" if stats
                      else "bf16, no stats (ss_attention_fused)")))
    for dt in (torch.float32, torch.bfloat16):
        q, k_l = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
        m_mat, v = randn(b, c, d, dtype=dt), randn(b, n, d, dtype=dt)
        delta = randn(b, 1, 1, s=0.1).abs()
        err = check(f"K2 query_side serve b={b} n={n} c={c} {str(dt).split('.')[-1]}",
                    [("out", query_side(q, k_l, m_mat, v, delta, scale=scale),
                      query_side_plain(q, k_l, m_mat, v, delta, scale=scale), None)])
        if dt == torch.bfloat16:
            entries[f"c{c}_serve_query_side"] = dict(
                fn=partial(query_side, q, k_l, m_mat, v, delta, scale=scale),
                plain=partial(query_side_plain, q, k_l, m_mat, v, delta, scale=scale),
                library=partial(sdpa_query_side, q, k_l, m_mat, v, delta, scale=scale),
                err=err, bound=k2_bound(b, n, c, d, d, b * n * c),
                shape=f"b={b} n={n} c={c} d=dv={d} bf16")
    return entries


def wide_c_entries(torch, dev) -> dict:
    """K1-K4 past 64 landmarks (WIDE_C), each against its plain version in
    fp32 and bf16, every backward launch repeated and held bitwise: the
    serving shape (``serve_wide_c_entries``) and the training shapes,
    Qwen2-7B's (b 56, d 128) and paper-bert's (b 64, d 64) at n 4096,
    causal (``train_kernel_entries``, K3 with kv_valid and K4 with a
    q_offset); and K2's wide-head variants (d = 576, dv = 512) at c = 128.
    The shard cases at c = 128 are SHARD_CASES'. Timing entries
    (``c{c}_...``) at WIDE_C_TIMED."""
    from repro_torch.kernels.ss_attention import query_side, query_side_plain

    t0 = time.perf_counter()
    # K2's wide-head variants past 64 columns (absorbed MLA's d = 576,
    # dv = 512; held, not timed)
    gen = torch.Generator(device=dev).manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        q, k_l, m_mat, v = (torch.randn(shape, generator=gen, device=dev).to(dt) * s_
                            for shape, s_ in (((16, 352, 576), 0.1), ((16, 128, 576), 0.1),
                                              ((16, 128, 512), 1.0), ((16, 352, 512), 1.0)))
        delta = torch.full((16, 1, 1), 0.05, device=dev)
        check(f"K2 query_side wide heads b=16 n=352 c=128 d=576 dv=512 "
              f"{str(dt).split('.')[-1]}",
              [("out", query_side(q, k_l, m_mat, v, delta, scale=576**-0.5),
                query_side_plain(q, k_l, m_mat, v, delta, scale=576**-0.5), None)])
    entries = {}
    for c in WIDE_C:
        found = {**serve_wide_c_entries(torch, dev, c),
                 **{f"c{c}_{k}": e for k, e in train_kernel_entries(
                     torch, dev, c=c, repeat=True).items()},
                 **{f"c{c}_bert_{k}": e for k, e in train_kernel_entries(
                     torch, dev, b=PAPER_BERT_BATCH * 8, d=64, c=c, repeat=True).items()}}
        if c in WIDE_C_TIMED:
            entries.update(found)
    log(f"wide c: K1-K4 at c = {list(WIDE_C)} within tolerance, K3 / K4 bitwise over "
        f"two launches; {time.perf_counter() - t0:.1f}s")
    return entries


# --------------------------------------------------------------------------
# phase 3: model parity, kernel route (card) vs plain route (CPU)
# --------------------------------------------------------------------------
def drive_model(torch, params, cfg, device, prompt_lens, feed=None, steps=4,
                block_size=16, decode_impl="paged", prefill="ss_fused",
                store_dtype=None, view_quantum: int = 0):
    """Prefill each prompt into its own lane, then ``steps`` decode steps
    for all lanes on ``decode_impl``'s route (``paged``: K5 over the pools;
    ``gather``: dense views). ``prefill``: "ss_fused" or "replay" (the
    whole prompt at once), or an int, the chunk of chunked prefill
    (``make_chunk_step`` with the ss_fused stats handoff: K1 at the chunk
    site). ``store_dtype``: every cache leaf is stored in this dtype
    instead of its own (the float64 witness of ``chunked_model_checks``).
    Under ``decode_streaming="frozen"`` each decode step is followed by the
    engine's boundary rebase (``make_rebase_step``) of the lanes whose
    written position starts a landmark segment. Returns (list of logits on
    the CPU, fed tokens, a dict: the cache's streaming stats (m, l, acc),
    each (layers, lanes, ...), after the prefills and after the decode
    steps, and the rebases, the cache, the block tables and the positions
    the next step would write). ``view_quantum``: the decode plan's, the
    tables cut as the engine cuts them (0 = whole tables); the kernels'
    tilings come from the caller's ``dispatch.use_tiling``."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.decode_state import make_rebase_fn
    from repro_torch.serve.paged import BlockAllocator, PagedKVCache
    from repro_torch.serve.prefill import batched_prefill, make_chunk_prefill_fn

    serve = ServeConfig(max_lanes=len(prompt_lens), max_seq=512, block_size=block_size,
                        prefill_impl="ss_fused", decode_impl=decode_impl)
    bs, seq_max = serve.block_size, serve.max_seq
    kv = PagedKVCache(cfg, serve, device)
    if store_dtype is not None:
        kv.storage = {k: t.to(store_dtype) for k, t in kv.storage.items()}
    alloc = BlockAllocator(serve.resolved_num_blocks, bs)
    rng = torch.Generator().manual_seed(3)
    lanes = len(prompt_lens)
    positions = torch.zeros(lanes, dtype=torch.int32)
    tokens = torch.zeros((lanes, 1), dtype=torch.long)
    outs, fed = [], []
    wide = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    if isinstance(prefill, int):
        chunk_step = kv.make_chunk_step(make_chunk_prefill_fn(
            params, cfg, seq_max=seq_max, stats_impl="ss_fused"), prefill)
    for lane, n in enumerate(prompt_lens):
        toks = torch.randint(3, cfg.vocab_size, (n,), generator=rng)
        alloc.alloc(lane, -(-n // bs))
        row = torch.zeros(seq_max // bs, dtype=torch.int32)
        row[:len(alloc.tables[lane])] = torch.tensor(alloc.tables[lane])
        if isinstance(prefill, int):
            lgs = []
            for start in range(0, n, prefill):
                cv = min(prefill, n - start)
                ctoks = torch.zeros((1, prefill), dtype=torch.long)
                ctoks[0, :cv] = toks[start:start + cv]
                lg = chunk_step(row.numpy(), ctoks.to(device), lane, start, cv)
                lgs.append(lg[0, :cv].to(wide).cpu())
            lg = torch.cat(lgs)[None]
        else:
            n_pad = n if n <= cfg.num_landmarks else -(-n // 32) * 32
            padded = torch.zeros((1, n_pad), dtype=torch.long)
            padded[0, :n] = toks
            lg, pc = batched_prefill(params, cfg, padded.to(device), n, seq_max=seq_max,
                                     prefill_impl=prefill)
            kv.write_prefill(lane, pc, row.numpy(), n_tokens=n)
        outs.append(lg[0, :n].to(wide).cpu())
        positions[lane] = n
        tokens[lane, 0] = int(lg[0, n - 1].argmax()) if feed is None else feed[0][lane]
    fed.append(tokens[:, 0].tolist())
    stat_names = ("bv_m", "bv_l", "bv_acc")
    stats = {"prefill": [kv.storage[name].cpu() for name in stat_names]}
    if decode_impl == "paged":
        paged_step = kv.make_paged_step(lambda c_, t_, tb: decode_step(
            params, cfg, c_, t_, seq_max=seq_max, paged_table=tb, block_size=bs))

        def step(tables, *rest):
            if view_quantum:   # the table cut as the engine cuts it
                tables = tables[:, :kv.view_blocks_needed(
                    positions.numpy(), list(range(lanes)), view_quantum)].contiguous()
            return paged_step(tables, *rest)
    else:
        fused = kv.make_fused_step(lambda c_, t_: decode_step(params, cfg, c_, t_,
                                                              seq_max=seq_max))
        step = lambda *a: fused(*a, kv.view_blocks_needed(  # noqa: E731
            positions.numpy(), list(range(lanes))))
    frozen = cfg.decode_streaming == "frozen"
    if frozen:
        rebase = kv.make_rebase_step(make_rebase_fn(cfg, seq_max))
        seg = -(-seq_max // cfg.num_landmarks)
    stats["rebases"] = 0
    for t in range(steps):
        tables = torch.zeros((lanes, seq_max // bs), dtype=torch.int32)
        for lane in range(lanes):
            if int(positions[lane]) // bs >= len(alloc.tables[lane]):
                alloc.alloc(lane, 1)
            tables[lane, :len(alloc.tables[lane])] = torch.tensor(alloc.tables[lane])
        lg = step(tables.to(device), tokens.to(device), positions.to(device),
                  torch.ones(lanes, dtype=torch.bool, device=device))
        outs.append(lg[:, 0].to(wide).cpu())
        hits = [i for i in range(lanes) if frozen and 0 < int(positions[i])
                and int(positions[i]) % seg == 0]
        if hits:
            rebase(tables.numpy(), positions.numpy(), hits,
                   kv.view_blocks_needed(positions.numpy(), hits))
            stats["rebases"] += len(hits)
        positions += 1
        nxt = lg[:, 0].argmax(-1).cpu() if feed is None else torch.tensor(feed[t + 1])
        tokens[:, 0] = nxt
        fed.append(nxt.tolist())
    stats["decode"] = [kv.storage[name].cpu() for name in stat_names]
    stats.update(kv=kv, tables=tables, positions=positions)
    return outs, fed, stats


def logit_errs(torch, label, a_runs, b_runs, prompt_lens) -> list:
    """Per-output logit error of ``a_runs`` against ``b_runs`` (prefill of
    each prompt, then each decode step), relative to b's max-abs; every
    logit of ``a_runs`` must be finite."""
    names = [f"prefill n={n}" for n in prompt_lens] + [
        f"decode step {i}" for i in range(len(a_runs) - len(prompt_lens))]
    errs = []
    for name, a, b in zip(names, a_runs, b_runs):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite logits at {name}")
        err, scale = max_err(a, b)
        errs.append(err / scale)
    return errs


@contextlib.contextmanager
def plain_route():
    """Run the port with every kernel replaced by its plain version, on the
    same card: each wrapper's CUDA launch function is swapped for the plain
    version (same arguments) while the block runs."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ss_attention as sa
    from repro_torch.kernels import ss_attention_bwd as sb

    saved = (sa._landmark_summary_cuda, sa._query_side_cuda,
             pd._paged_row_stats_cuda, sb._landmark_summary_bwd_cuda,
             sb._query_side_bwd_cuda)
    sa._landmark_summary_cuda = sa.landmark_summary_plain
    sa._query_side_cuda = sa.query_side_plain
    pd._paged_row_stats_cuda = pd.paged_row_stats_plain
    sb._landmark_summary_bwd_cuda = sb.landmark_summary_bwd_plain
    sb._query_side_bwd_cuda = sb.query_side_bwd_plain
    try:
        yield
    finally:
        (sa._landmark_summary_cuda, sa._query_side_cuda,
         pd._paged_row_stats_cuda, sb._landmark_summary_bwd_cuda,
         sb._query_side_bwd_cuda) = saved


@contextlib.contextmanager
def float64_everywhere(torch):
    """While the block runs, ``Tensor.float()`` and ``Tensor.to(torch.float32)``
    leave a float64 tensor float64, so a float64 model computes every
    operation in float64, the attention core and the streaming stats too
    (whose math is fp32 by design, as in the reference). For the float64
    witness of ``chunked_model_checks`` only."""
    to_float, to = torch.Tensor.float, torch.Tensor.to
    own = {name: name in vars(torch.Tensor) for name in ("float", "to")}

    def keep_float(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else to_float(self, *args, **kwargs)

    def keep_to(self, *args, **kwargs):
        if self.dtype == torch.float64:
            args = tuple(torch.float64 if a is torch.float32 else a for a in args)
            if kwargs.get("dtype") is torch.float32:
                kwargs["dtype"] = torch.float64
        return to(self, *args, **kwargs)

    torch.Tensor.float, torch.Tensor.to = keep_float, keep_to
    try:
        yield
    finally:
        for name, method in (("float", to_float), ("to", to)):
            if own[name]:
                setattr(torch.Tensor, name, method)
            else:
                delattr(torch.Tensor, name)   # inherited again


def model_phase(torch, dev) -> None:
    """Kernel route against the plain route on the card, 2 full-width fp32
    layers, prefill logits and 4 decode steps: qwen2-7b (block 16; the
    plain route on the CPU too, for the record) and granite-20b (48 query
    heads on 1 kv head: K5 at r = 48, block 64). Then, on qwen2-7b with
    ``decode_attention_impl="full"``, the paged route (K5 at r = 7) against
    the gather route (dense views, plain torch)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params
    from repro_torch.serve.engine import tree_to

    prompt_lens = (48, 333)
    for arch, bs in (("qwen2-7b", 16), ("granite-20b", 64), (LLAVA, 16)):
        cfg = dataclasses.replace(get_config(arch), num_layers=2, compute_dtype="float32")
        t0 = time.perf_counter()
        params = random_params(cfg, seed=0, device=dev)
        before = launch_counts()
        card, fed, _ = drive_model(torch, params, cfg, dev, prompt_lens, block_size=bs)
        after = launch_counts()
        if any(after[k] <= before[k] for k in SERVE_KERNELS):
            raise AssertionError(f"model parity {arch}: kernel route skipped a kernel: "
                                 f"{after}")
        with plain_route():
            plain, _, _ = drive_model(torch, params, cfg, dev, prompt_lens, feed=fed,
                                      block_size=bs)
        if launch_counts() != after:
            raise AssertionError(f"model parity {arch}: the plain route launched a kernel")
        cpu_note = ""
        if arch == "qwen2-7b":
            # For the record, not held: the plain route on the CPU differs
            # from the card by BLAS rounding alone, amplified by the
            # random-weight core.
            params_cpu = tree_to(params, "cpu")
            on_cpu, _, _ = drive_model(torch, params_cpu, cfg, torch.device("cpu"),
                                       prompt_lens, feed=fed, block_size=bs)
            cpu_err = max(e / s for e, s in (max_err(a, b) for a, b in zip(plain, on_cpu)))
            cpu_note = f"; plain route card vs CPU {cpu_err:.2e} (not held)"
        del params
        torch.cuda.empty_cache()
        errs = logit_errs(torch, f"model parity {arch}", card, plain, prompt_lens)
        log(f"model parity: {arch} full width (d_model={cfg.d_model}, heads="
            f"{cfg.num_heads}/{cfg.num_kv_heads}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}) "
            f"2 layers fp32, block {bs}, prompts {prompt_lens}, 4 paged decode steps, "
            f"kernel route vs plain route on the card: logit err of max-abs per output "
            f"{['%.2e' % e for e in errs]} (tol {MODEL_TOL}){cpu_note}; "
            f"{time.perf_counter() - t0:.1f}s")
        if not max(errs) <= MODEL_TOL:
            raise AssertionError(f"model parity {arch}: logit err {max(errs):.3e} > "
                                 f"{MODEL_TOL}")

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2,
                              compute_dtype="float32", decode_attention_impl="full")
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, device=dev)
    before = launch_counts()
    paged, fed, _ = drive_model(torch, params, cfg, dev, prompt_lens)
    if launch_counts()["paged_row_stats"] <= before["paged_row_stats"]:
        raise AssertionError("full decode attention: the paged route skipped K5")
    gather, _, _ = drive_model(torch, params, cfg, dev, prompt_lens, feed=fed,
                               decode_impl="gather")
    del params
    torch.cuda.empty_cache()
    errs = logit_errs(torch, "full decode attention", paged, gather, prompt_lens)
    log(f"model parity: qwen2-7b 2 layers fp32, decode_attention_impl='full', paged "
        f"route (K5, r = {cfg.num_heads // cfg.num_kv_heads}) vs gather route on the "
        f"card: logit err of max-abs per output {['%.2e' % e for e in errs]} (tol "
        f"{MODEL_TOL}); {time.perf_counter() - t0:.1f}s")
    if not max(errs) <= MODEL_TOL:
        raise AssertionError(f"full decode attention: logit err {max(errs):.3e} > "
                             f"{MODEL_TOL}")
    chunked_model_checks(torch, dev, prompt_lens)
    frozen_model_checks(torch, dev, prompt_lens)
    deepseek_model_checks(torch, dev)
    hymba_model_checks(torch, dev)
    whisper_model_checks(torch, dev)
    xlstm_model_checks(torch, dev)


def deepseek_model_checks(torch, dev) -> None:
    """DeepSeek-V2-Lite (absorbed MLA + MoE) at full width, 2 fp32 layers:
    prefill logits (prompts of 48 and 333 tokens: the exact window and K1 /
    K2 at d = 576, dv = 512) and 4 paged decode steps (K5 with the latent
    and rope pools), kernel route against the plain route on the card, and
    the streaming stats after the prefills and after the decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params

    prompt_lens = (48, 333)
    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=2, compute_dtype="float32")
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, device=dev)
    before = launch_counts()
    card, fed, card_stats = drive_model(torch, params, cfg, dev, prompt_lens)
    after = launch_counts()
    if any(after[k] <= before[k] for k in SERVE_KERNELS):
        raise AssertionError(f"model parity {DEEPSEEK}: kernel route skipped a kernel: "
                             f"{after}")
    with plain_route():
        plain, _, plain_stats = drive_model(torch, params, cfg, dev, prompt_lens, feed=fed)
    if launch_counts() != after:
        raise AssertionError(f"model parity {DEEPSEEK}: the plain route launched a kernel")
    del params
    torch.cuda.empty_cache()
    errs = logit_errs(torch, f"model parity {DEEPSEEK}", card, plain, prompt_lens)
    stat_errs = {when: [e / max(sc, 1e-30) for e, sc in (
        max_err(a, b) for a, b in zip(card_stats[when], plain_stats[when]))]
        for when in ("prefill", "decode")}
    log(f"model parity: {DEEPSEEK} full width (d_model={cfg.d_model}, {cfg.num_heads} "
        f"heads, MLA kv_lora {cfg.kv_lora_rank} + rope {cfg.rope_head_dim}, "
        f"{cfg.num_experts} experts top-{cfg.top_k} + {cfg.num_shared_experts} shared, "
        f"vocab={cfg.vocab_size}) 2 layers fp32, block 16, prompts {prompt_lens}, 4 paged "
        f"decode steps, kernel route vs plain route on the card: logit err of max-abs "
        f"per output {['%.2e' % e for e in errs]} (tol {MODEL_TOL}); stats (m, l, acc) "
        f"after the prefills {['%.2e' % e for e in stat_errs['prefill']]}, after the "
        f"decode steps {['%.2e' % e for e in stat_errs['decode']]} (tol {STATS_TOL}); "
        f"{time.perf_counter() - t0:.1f}s")
    if not max(errs) <= MODEL_TOL:
        raise AssertionError(f"model parity {DEEPSEEK}: logit err {max(errs):.3e} > "
                             f"{MODEL_TOL}")
    worst = max(max(v) for v in stat_errs.values())
    if not worst <= STATS_TOL:
        raise AssertionError(f"model parity {DEEPSEEK}: stats err {worst:.3e} > "
                             f"{STATS_TOL}")


def frozen_bv_errs(torch, st: dict, cfg) -> tuple:
    """Each lane's frozen landmark rows (below the active one) after
    ``drive_model``'s decode steps and rebases, against an exact recompute
    over the lane's keys (``recompute_stats`` on the gathered view) in the
    cache's dtype: (worst |err| - 2e-4 |ref|, the allclose excess over
    ``tests/test_paged_serve.py:608``'s atol = rtol = 2e-4; worst |err|;
    worst |err| of the active row, which drifts by design)."""
    from repro_torch.models.attention import _broadcast_kv
    from repro_torch.serve import decode_state as ds

    kv, seq_max = st["kv"], 512
    excess, worst, drift = -math.inf, 0.0, 0.0
    for lane, pos in enumerate(int(p) - 1 for p in st["positions"]):
        ids = st["tables"][lane:lane + 1, : pos // kv.block_size + 1].to(kv.storage["k"].device)
        pos_t = ids.new_tensor([pos])
        counts = ds.landmark_counts(pos_t, seq_max, cfg.num_landmarks)
        active = pos // ds.segment_len(seq_max, cfg.num_landmarks)
        for layer in range(cfg.num_layers):
            k, v = (_broadcast_kv(kv._gather_leaf(kv.storage[n], ids)[layer], cfg.num_heads)
                    for n in ("k", "v"))
            q_l = ds.landmark_means(kv.storage["q_lmk"][layer, lane:lane + 1], counts)
            _, l, acc = ds.recompute_stats(q_l, k, v, pos_t, cfg.resolved_head_dim ** -0.5)
            ref = acc / torch.clamp(l, min=1e-30)
            got = (kv.storage["bv_acc"][layer, lane:lane + 1]
                   / torch.clamp(kv.storage["bv_l"][layer, lane:lane + 1], min=1e-30))
            err = (got - ref).abs()
            excess = max(excess, float((err - 2e-4 * ref.abs())[:, :, :active].max()))
            worst = max(worst, float(err[:, :, :active].max()))
            drift = max(drift, float(err[:, :, active].max()))
    return excess, worst, drift


def frozen_model_checks(torch, dev, prompt_lens, steps: int = 20) -> None:
    """``decode_streaming="frozen"`` on full-width Qwen2-7B, 2 layers,
    ss_fused prefill then ``steps`` paged decode steps with the engine's
    boundary rebases (seg 8: at least two per lane):

    * fp32, the kernel route (K1 and K2 in the prefill; no K5: a frozen
      tick reads no pool) against the plain route on the card: logits
      within MODEL_TOL of max-abs;
    * every frozen landmark row's BV (rows below the active one) against
      an exact recompute over the lane's keys at 2e-4 absolute and
      relative (the reference's tolerance,
      ``tests/test_paged_serve.py:608``), on the 2 layers computed wholly
      in float64 (plain route, ``float64_everywhere``, whole-prompt
      replay prefill as the float64 witness of ``chunked_model_checks``
      runs it: the ss_fused prefill keeps fp32 one-hot sums). In fp32 at full
      width the scores are large and their rounding alone moves a streamed
      BV by some 5e-3 (exact streaming as much as frozen; PERF.md), so the
      fp32 figures of both modes are printed beside it, not held."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2, compute_dtype="float32",
                              decode_streaming="frozen")
    params = random_params(cfg, seed=0, device=dev)
    before = launch_counts()
    card, fed, st = drive_model(torch, params, cfg, dev, prompt_lens, steps=steps)
    after = launch_counts()
    ran = {k: after[k] - before[k] for k in SERVE_KERNELS}
    if ran["landmark_summary"] <= 0 or ran["query_side"] <= 0 or ran["paged_row_stats"]:
        raise AssertionError(f"frozen model: launches {ran}: K1 and K2 must run, K5 not")
    rebases = st["rebases"]
    if rebases < 2 * len(prompt_lens):
        raise AssertionError(f"frozen model: {rebases} rebases, want two a lane at least")
    fp32_frozen = frozen_bv_errs(torch, st, cfg)
    with plain_route():
        plain, _, _ = drive_model(torch, params, cfg, dev, prompt_lens, feed=fed, steps=steps)
    _, _, st_exact = drive_model(torch, params, dataclasses.replace(cfg, decode_streaming="exact"),
                                 dev, prompt_lens, feed=fed, steps=steps)
    fp32_exact = frozen_bv_errs(torch, st_exact, cfg)
    del params, st, st_exact
    torch.cuda.empty_cache()
    errs = logit_errs(torch, "frozen model", card, plain, prompt_lens)

    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    params = random_params(cfg64, seed=0, device=dev)
    with plain_route(), float64_everywhere(torch):
        _, _, st64 = drive_model(torch, params, cfg64, dev, prompt_lens, steps=steps,
                                 prefill="replay", store_dtype=torch.float64)
        f64 = frozen_bv_errs(torch, st64, cfg64)
    del params, st64
    torch.cuda.empty_cache()
    log(f"model parity: qwen2-7b frozen streaming, 2 layers, prompts {prompt_lens}, "
        f"{steps} paged decode steps, {rebases} lane rebases; launches K1 "
        f"{ran['landmark_summary']} K2 {ran['query_side']} K5 {ran['paged_row_stats']}; "
        f"fp32 kernel route vs plain route on the card: logit err of max-abs worst "
        f"{max(errs):.2e} (tol {MODEL_TOL}); frozen rows' BV vs an exact recompute over "
        f"the lane's keys, wholly in float64: |err| - 2e-4 |ref| worst {f64[0]:.2e} (tol "
        f"2e-4), max |err| {f64[1]:.2e}, the drifting active row {f64[2]:.2e}; in fp32 "
        f"(not held): frozen max |err| {fp32_frozen[1]:.2e} (excess {fp32_frozen[0]:.2e}, "
        f"active row {fp32_frozen[2]:.2e}), exact streaming's streamed rows max |err| "
        f"{fp32_exact[1]:.2e} (excess {fp32_exact[0]:.2e}); "
        f"{time.perf_counter() - t0:.1f}s")
    if not max(errs) <= MODEL_TOL:
        raise AssertionError(f"frozen model: logit err {max(errs):.3e} > {MODEL_TOL}")
    if not f64[0] <= 2e-4:
        raise AssertionError(f"frozen model: frozen rows' BV off the exact recompute by "
                             f"{f64[0]:.3e} > 2e-4 (float64)")


def position_errs(torch, a_runs, b_runs, seg: int) -> tuple:
    """Worst logit error of ``a_runs`` against ``b_runs`` (one prompt's
    logits each, (n, vocab)) relative to b's max-abs, over the positions
    whose context fills at most 4 landmark rows (ROADMAP P2) and over the
    others, apart."""
    few, rest = 0.0, 0.0
    for a, b in zip(a_runs, b_runs):
        pos_err = (a - b).abs().amax(-1) / b.abs().max()
        p2 = torch.arange(len(pos_err)) // seg < 4
        few = max(few, float(pos_err[p2].max()))
        rest = max(rest, float(pos_err[~p2].max()) if (~p2).any() else 0.0)
    return few, rest


def chunked_model_checks(torch, dev, prompt_lens, chunk: int = 128) -> None:
    """Chunked prefill (chunks of 128 > c = 64: K1 at the chunk site) then 4
    paged decode steps of full-width Qwen2-7B on the card.

    * 2 fp32 layers, the kernel route against the plain route: logits of
      every prefill position and decode step, and the streaming stats left
      by the prefill, within MODEL_TOL of max-abs; the stats after the
      decode steps (K5's partials merged into the carry) within MODEL_TOL
      at layer 0, whose inputs are the same on both routes, and within
      STATS_TOL at layer 1, whose inputs carry layer 0's rounding.
    * Against whole-prompt ``replay`` prefill (the chunk attention is the
      replay math). The two prefills multiply the same values in products
      of other shapes (a chunk attends over the committed keys plus its
      own, whole replay over the padded prompt), so they round
      differently, and the random-weight spectral-shift core amplifies
      that rounding: at positions whose context fills 2-4 landmark rows
      (ROADMAP P2) within a layer, at every position from one layer to
      the next (P1). So: at 1 fp32 layer the logits the engine samples
      (each prompt's last position, every decode step) within MODEL_TOL and
      every prompt position within P2_TOL; at 2 fp32 layers the errors are
      printed, not held; at 2 layers computed wholly in float64 (plain
      route, every cache leaf stored in float64, ``float64_everywhere``),
      where rounding is some 1e-9 of fp32's, every prompt position and
      decode step within MODEL_TOL."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params

    t0 = time.perf_counter()
    n_p = len(prompt_lens)
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2, compute_dtype="float32")
    seg = -(-512 // cfg.num_landmarks)   # drive_model's max_seq
    params = random_params(cfg, seed=0, device=dev)
    before = launch_counts()
    card, fed, card_stats = drive_model(torch, params, cfg, dev, prompt_lens, prefill=chunk)
    after = launch_counts()
    ran = {k: after[k] - before[k] for k in SERVE_KERNELS}
    if ran["landmark_summary"] <= 0 or ran["paged_row_stats"] <= 0 or ran["query_side"]:
        raise AssertionError(f"chunked model: launches {ran}: K1 and K5 must run, K2 not")
    with plain_route():
        plain, _, plain_stats = drive_model(torch, params, cfg, dev, prompt_lens,
                                            feed=fed, prefill=chunk)
    if launch_counts() != after:
        raise AssertionError("chunked model: the plain route launched a kernel")
    errs = logit_errs(torch, "chunked model", card, plain, prompt_lens)

    def stat_errs(when, layer=slice(None)):
        return [e / max(sc, 1e-30) for e, sc in (
            max_err(a[layer], b[layer])
            for a, b in zip(card_stats[when], plain_stats[when]))]

    prefill_stats = stat_errs("prefill")
    decode_stats = [stat_errs("decode", 0), stat_errs("decode", 1)]
    # the same prompts through whole-prompt replay at 2 fp32 layers: printed
    replay2, _, _ = drive_model(torch, params, cfg, dev, prompt_lens, feed=fed,
                                prefill="replay")
    del params
    torch.cuda.empty_cache()
    fp32_2 = position_errs(torch, card[:n_p], replay2[:n_p], seg)
    fp32_2_decode = logit_errs(torch, "chunked vs replay", card[n_p:], replay2[n_p:], ())

    cfg1 = dataclasses.replace(cfg, num_layers=1)
    params = random_params(cfg1, seed=0, device=dev)
    chunked, fed1, _ = drive_model(torch, params, cfg1, dev, prompt_lens, prefill=chunk)
    replay, _, _ = drive_model(torch, params, cfg1, dev, prompt_lens, feed=fed1,
                               prefill="replay")
    del params
    torch.cuda.empty_cache()
    all_errs = logit_errs(torch, "chunked vs replay", chunked, replay, prompt_lens)
    few, rest = position_errs(torch, chunked[:n_p], replay[:n_p], seg)
    sampled = [e / sc for e, sc in ([max_err(a[-1], b[-1]) for a, b in
                                     zip(chunked[:n_p], replay[:n_p])]
                                    + [max_err(a, b) for a, b in
                                       zip(chunked[n_p:], replay[n_p:])])]

    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    params = random_params(cfg64, seed=0, device=dev)
    with plain_route(), float64_everywhere(torch):
        chunked64, fed64, _ = drive_model(torch, params, cfg64, dev, prompt_lens,
                                          prefill=chunk, store_dtype=torch.float64)
        replay64, _, _ = drive_model(torch, params, cfg64, dev, prompt_lens, feed=fed64,
                                     prefill="replay", store_dtype=torch.float64)
    del params
    torch.cuda.empty_cache()
    f64_errs = logit_errs(torch, "chunked vs replay float64", chunked64, replay64,
                          prompt_lens)

    def fmt(xs):
        return ["%.2e" % e for e in xs]

    log(f"model parity: qwen2-7b, chunked prefill (chunk {chunk}, ss_fused stats "
        f"handoff: K1 {ran['landmark_summary']}, K5 {ran['paged_row_stats']} launches) + 4 "
        f"paged decode steps; 2 fp32 layers, kernel route vs plain route on the card: "
        f"logit err of max-abs per output {fmt(errs)}, stats (m, l, acc) after the prefill "
        f"{fmt(prefill_stats)} (tol {MODEL_TOL}), after the decode steps layer 0 "
        f"{fmt(decode_stats[0])} (tol {MODEL_TOL}) layer 1 {fmt(decode_stats[1])} (tol "
        f"{STATS_TOL})")
    log(f"model parity: qwen2-7b, chunked (chunk {chunk}) vs whole-prompt replay prefill "
        f"+ 4 paged decode steps, logit err of max-abs: 1 fp32 layer: sampled logits (each "
        f"prompt's last position, then each decode step) {fmt(sampled)} (tol {MODEL_TOL}), "
        f"every position {fmt(all_errs)} (tol {P2_TOL}; positions with at most 4 live "
        f"landmark rows {few:.2e}, the others {rest:.2e}); 2 fp32 layers (not held): "
        f"prompt positions with at most 4 live landmark rows {fp32_2[0]:.2e}, the others "
        f"{fp32_2[1]:.2e}, decode steps {fmt(fp32_2_decode)}; 2 layers wholly in float64 "
        f"(plain route): every prompt position, then each decode step {fmt(f64_errs)} "
        f"(tol {MODEL_TOL}); {time.perf_counter() - t0:.1f}s")
    worst = max(errs + prefill_stats + decode_stats[0] + sampled + f64_errs)
    if not worst <= MODEL_TOL:
        raise AssertionError(f"chunked model: err {worst:.3e} > {MODEL_TOL}")
    if not max(all_errs) <= P2_TOL:
        raise AssertionError(f"chunked model: 1-layer replay identity {max(all_errs):.3e} "
                             f"> {P2_TOL}")
    if not max(decode_stats[1]) <= STATS_TOL:
        raise AssertionError(f"chunked model: layer-1 stats after decode "
                             f"{max(decode_stats[1]):.3e} > {STATS_TOL}")


def grad_phase(torch, dev) -> None:
    """One grad step (``make_grad_step``) of the full-width 2-layer fp32
    model with ``attention_impl="spectral_shift_fused"``, seq 512, batch 1:
    kernel route (K1/K2 forward, K3/K4 backward) against the plain route,
    both on the card. Holds the loss and every gradient leaf."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import make_grad_step

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2,
                              compute_dtype="float32", remat="none",
                              attention_impl="spectral_shift_fused")
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, device=dev)
    batch = to_device(SyntheticLM(cfg.vocab_size, 512, 1, seed=0).batch(0), dev)
    step = make_grad_step(cfg)
    before = launch_counts()
    loss, grads = step(params, batch)
    after = launch_counts()
    if any(after[k] <= before[k] for k in TRAIN_KERNELS):
        raise AssertionError(f"grad parity: kernel route skipped a kernel: {after}")
    with plain_route():
        ploss, pgrads = step(params, batch)
    if launch_counts() != after:
        raise AssertionError("grad parity: the plain route launched a kernel")
    loss_err = abs(float(loss) - float(ploss)) / abs(float(ploss))
    errs = grad_errs(torch, grads, pgrads)
    worst = max(errs, key=errs.get)
    log(f"grad parity: qwen2-7b full width 2 layers fp32 seq 512, kernel route vs "
        f"plain route on the card: loss {float(loss):.6f} vs {float(ploss):.6f} "
        f"(rel {loss_err:.2e}, tol {GRAD_TOL}), grad err of max-abs per leaf "
        f"{json.dumps({k: float('%.2e' % v) for k, v in errs.items()})} (worst "
        f"{worst}, tol {GRAD_TOL}); {time.perf_counter() - t0:.1f}s")
    if not (loss_err <= GRAD_TOL and errs[worst] <= GRAD_TOL):
        raise AssertionError(f"grad parity: loss err {loss_err:.3e} or grad err "
                             f"{errs[worst]:.3e} ({worst}) > {GRAD_TOL}")

    # The selective-checkpoint policies against remat="none": the same
    # kernels on the same inputs, recomputed, so bitwise is expected.
    for remat in ("ss_stats", "dots"):
        t0 = time.perf_counter()
        before = launch_counts()
        rloss, rgrads = make_grad_step(dataclasses.replace(cfg, remat=remat))(params, batch)
        counts = {k: launch_counts()[k] - before[k] for k in TRAIN_KERNELS}
        bitwise = float(rloss) == float(loss) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(rgrads), tree_leaves(grads)))
        rerr = max(max_err(a, b)[0] / max(max_err(a, b)[1], 1e-30)
                   for a, b in zip(tree_leaves(rgrads), tree_leaves(grads)))
        lerr = abs(float(rloss) - float(loss)) / abs(float(loss))
        log(f"grad parity: remat={remat} vs none, same kernel route: loss {float(rloss):.6f} "
            f"(rel {lerr:.2e}), worst grad err of max-abs {rerr:.2e} (tol {REMAT_TOL}), "
            f"bitwise {bitwise}, launches {counts}; {time.perf_counter() - t0:.1f}s")
        if not (lerr <= REMAT_TOL and rerr <= REMAT_TOL):
            raise AssertionError(f"grad parity: remat={remat} differs from none by "
                                 f"{max(lerr, rerr):.3e} > {REMAT_TOL}")
        want_k1 = cfg.num_layers * (1 if remat == "ss_stats" else 2)
        if counts["landmark_summary"] != want_k1:
            raise AssertionError(f"grad parity: remat={remat} launched K1 "
                                 f"{counts['landmark_summary']} times, want {want_k1}")


WIDE_C_MODEL = 128   # the landmark count phase 3's and the c = 128 paths' runs set


def wide_c_model_checks(torch, dev) -> None:
    """Past 64 landmarks, kernel route against the plain route on the card:
    full-width Qwen2-7B at ``num_landmarks`` = WIDE_C_MODEL, prefill logits
    and 4 paged decode steps of 2 fp32 layers (prompts of 48 and 333 tokens:
    the n <= c route and K1 / K2 at c = 128, seg 4), held to MODEL_TOL; then
    one grad step of 1 fp32 layer at seq 512 (K1-K4 at c = 128), the loss
    and every gradient leaf held to GRAD_TOL."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params
    from repro_torch.train.train_step import make_grad_step

    prompt_lens = (48, 333)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2, compute_dtype="float32",
                              num_landmarks=WIDE_C_MODEL)
    params = random_params(cfg, seed=0, device=dev)
    before = launch_counts()
    card, fed, _ = drive_model(torch, params, cfg, dev, prompt_lens)
    after = launch_counts()
    if any(after[k] <= before[k] for k in SERVE_KERNELS):
        raise AssertionError(f"model parity c={WIDE_C_MODEL}: kernel route skipped a "
                             f"kernel: {after}")
    with plain_route():
        plain, _, _ = drive_model(torch, params, cfg, dev, prompt_lens, feed=fed)
    if launch_counts() != after:
        raise AssertionError(f"model parity c={WIDE_C_MODEL}: the plain route launched "
                             f"a kernel")
    errs = logit_errs(torch, f"model parity c={WIDE_C_MODEL}", card, plain, prompt_lens)
    log(f"model parity: qwen2-7b full width num_landmarks={WIDE_C_MODEL} 2 layers fp32, "
        f"prompts {prompt_lens}, 4 paged decode steps, kernel route vs plain route on the "
        f"card: logit err of max-abs per output {['%.2e' % e for e in errs]} (tol "
        f"{MODEL_TOL}); {time.perf_counter() - t0:.1f}s")
    if not max(errs) <= MODEL_TOL:
        raise AssertionError(f"model parity c={WIDE_C_MODEL}: logit err {max(errs):.3e} "
                             f"> {MODEL_TOL}")
    t0 = time.perf_counter()
    gcfg = dataclasses.replace(cfg, num_layers=1, remat="none",
                               attention_impl="spectral_shift_fused")
    gparams = first_layers(params, 1)
    batch = to_device(SyntheticLM(gcfg.vocab_size, 512, 1, seed=0).batch(0), dev)
    step = make_grad_step(gcfg)
    before = launch_counts()
    loss, grads = step(gparams, batch)
    after = launch_counts()
    if any(after[k] <= before[k] for k in TRAIN_KERNELS):
        raise AssertionError(f"grad parity c={WIDE_C_MODEL}: kernel route skipped a "
                             f"kernel: {after}")
    with plain_route():
        ploss, pgrads = step(gparams, batch)
    if launch_counts() != after:
        raise AssertionError(f"grad parity c={WIDE_C_MODEL}: the plain route launched "
                             f"a kernel")
    del params, gparams
    torch.cuda.empty_cache()
    loss_err = abs(float(loss) - float(ploss)) / abs(float(ploss))
    gerrs = grad_errs(torch, grads, pgrads)
    worst = max(gerrs, key=gerrs.get)
    log(f"grad parity: qwen2-7b full width num_landmarks={WIDE_C_MODEL} 1 layer fp32 seq "
        f"512, kernel route vs plain route on the card: loss {float(loss):.6f} vs "
        f"{float(ploss):.6f} (rel {loss_err:.2e}), worst grad err of max-abs "
        f"{gerrs[worst]:.2e} ({worst}), tol {GRAD_TOL}; {time.perf_counter() - t0:.1f}s")
    if not (loss_err <= GRAD_TOL and gerrs[worst] <= GRAD_TOL):
        raise AssertionError(f"grad parity c={WIDE_C_MODEL}: loss err {loss_err:.3e} or "
                             f"grad err {gerrs[worst]:.3e} ({worst}) > {GRAD_TOL}")


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------
SERVE_LENS = [48, 200, 333, 480]
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_FROZEN_LAYERS = 4   # depth cut of the frozen chunked prefix-cache run
GRANITE_LAYERS = 8   # of 52: about 9.7 GB of bf16 weights (embedding included)


def serve_params(torch, dev, arch: str, layers: int, label: str):
    """Full-width ``arch`` cut to ``layers`` layers, bf16 random weights
    (seed 0) on the card: (cfg, params)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import random_params

    cfg = get_config(arch)
    if layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve {label}: {arch} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers="
        f"{cfg.num_layers} bf16 random weights drawn in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB allocated")
    return cfg, params


def check_served(torch, engine, out: dict, label: str, n_requests: int) -> None:
    """Every request finished with tokens in the vocabulary, every cache
    leaf finite, no training kernel launched; without ``autotune`` the
    engine's plans are the heuristic's (the kernels' own tilings)."""
    vocab = engine.cfg.vocab_size
    plans = [p for p in (engine.decode_plan, engine.prefill_plan) if p is not None]
    if not engine.cfg.autotune and any(p.source != "heuristic" for p in plans):
        raise AssertionError(f"serve {label}: autotune off, yet the plans {plans} are "
                             f"not the heuristic's")
    if out["finished"] != n_requests:
        raise AssertionError(f"serve {label}: not every request finished")
    for uid, toks in out["outputs"].items():
        if not toks or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"serve {label}: request {uid} produced {toks}")
    for name, t in engine.kv.storage.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"serve {label}: non-finite values in cache leaf {name}")
    if any(v for k, v in out["launches"].items() if k not in SERVE_KERNELS):
        raise AssertionError(f"serve {label}: a training kernel launched: "
                             f"{out['launches']}")


def log_served(torch, dev, out: dict, serve, label: str) -> None:
    from repro_torch.launch.serve import tick_summary

    ttft = out["ttft_s"]
    log(f"serve {label}: route {out['mode']} / {out['decode_impl']} decode "
        f"(prefill_impl={serve.prefill_impl}, block {serve.block_size}), "
        f"{out['finished']}/{out['requests']} requests finished, "
        f"{out['tokens']} tokens in {out['seconds']:.3f}s ({out['tok_per_s']:.1f} tok/s), "
        f"TTFT mean {1e3 * sum(ttft) / len(ttft):.1f} ms max {1e3 * max(ttft):.1f} ms, "
        f"{tick_summary(out)}"
        + ("" if out["mode"].endswith("chunked-prefill") else
           f" ({1e3 * out['decode_s'] / max(out['decode_ticks'], 1):.1f} ms per tick)")
        + f", preemptions {out['preemptions']}, launches {out['launches']}, "
        f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")


def serve_run(torch, dev, arch: str, layers: int, serve, label: str, params=None,
              max_new: int = 16, lens=SERVE_LENS, warm_len: int = 200) -> dict:
    """One serving run of full-width ``arch`` cut to ``layers`` layers under
    ``serve`` (weights drawn here unless ``params`` (cfg, params) is
    given): a warm-up engine on one prompt of ``warm_len`` tokens, then
    prompts of ``lens`` tokens, ``max_new`` new tokens each, launch counts
    reset just before and read just after, checked by ``check_served``;
    returns the launcher's summary."""
    from repro_torch.launch.serve import serve_requests
    from repro_torch.serve.engine import ServeEngine

    cfg, weights = params if params is not None else serve_params(torch, dev, arch,
                                                                  layers, label)
    torch.cuda.reset_peak_memory_stats(dev)   # the peak below is this run's
    # warm-up (library handles, allocator) on an engine of its own
    serve_requests(ServeEngine(cfg, weights, serve=serve, device=dev), [warm_len], 2,
                   seed=1)
    engine = ServeEngine(cfg, weights, serve=serve, device=dev)
    out = serve_requests(engine, lens, max_new, seed=0)
    out["stats"] = engine.stats()
    out["snapshot"] = engine.telemetry.metrics.snapshot()
    log_served(torch, dev, out, serve, label)
    check_served(torch, engine, out, label, len(lens))
    del engine
    if params is None:
        del weights
    gc.collect()  # the engine's reference cycles hold the serving weights
    torch.cuda.empty_cache()
    return out


def serve_wide_c(torch, dev, weights, main_serve, layers: int) -> dict:
    """``serve_c128``: the main path's model, weights and settings (4 lanes,
    max_seq 512, ss_fused + paged, the standard prompts, 16 new tokens) at
    ``num_landmarks`` = WIDE_C_MODEL (landmarks carry no parameters): seg
    4, the 48-token prompt on the n <= c route, the three longer ones
    through K1 (``ss_attention_fused`` and the seed's stats launch) and K2
    at c = 128 in every layer, then K5 decode. Returns its launch counts."""
    cfg, params = weights
    wcfg = dataclasses.replace(cfg, num_landmarks=WIDE_C_MODEL)
    label = f"serve_c{WIDE_C_MODEL}"
    t0 = time.perf_counter()
    out = serve_run(torch, dev, "qwen2-7b", layers, main_serve, label, params=(wcfg, params))
    log(f"serve {label}: {time.perf_counter() - t0:.1f}s with its warm-up engine")
    long = sum(n > WIDE_C_MODEL for n in SERVE_LENS)
    want = dict(landmark_summary=2 * long * layers, query_side=long * layers)
    got = {k: out["launches"][k] for k in want}
    if got != want or out["launches"]["paged_row_stats"] <= 0:
        raise AssertionError(f"serve {label}: launches {out['launches']}, want {want} "
                             f"and K5 > 0")
    return out["launches"]


def serve_phase(torch, dev, layers: int) -> dict:
    """Phase 4: the main path (qwen2-7b, ss_fused prefill, paged decode),
    then the reference's default route (``ServeConfig(seed=0)``: replay
    prefill, gather decode; no kernel may launch), then granite-20b (48
    query heads on 1 kv head, block 64) on the kernel route. Returns each
    path's launch counts."""
    from repro_torch.configs.base import ServeConfig

    weights = serve_params(torch, dev, "qwen2-7b", layers, "main path")
    main_serve = ServeConfig(max_lanes=4, max_seq=512, prefill_impl="ss_fused",
                             decode_impl="paged", seed=0)
    main = serve_run(torch, dev, "qwen2-7b", layers, main_serve, "main path", params=weights)
    missing = [k for k in SERVE_KERNELS if main["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the main path: {missing}")
    wide = serve_wide_c(torch, dev, weights, main_serve, layers)
    telemetry = serve_telemetry_phase(torch, dev, weights, main_serve, main)
    tuned, decode_plan, _ = serve_autotune_phase(torch, dev, weights, main_serve, main)
    default = serve_run(torch, dev, "qwen2-7b", layers, ServeConfig(seed=0),
                        "default route", params=weights)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    if any(default["launches"].values()) or default["decode_impl"] != "gather":
        raise AssertionError(f"serve default route: a port kernel launched or the "
                             f"route is not gather: {default['launches']}, "
                             f"{default['decode_impl']}")
    granite = serve_run(torch, dev, "granite-20b", GRANITE_LAYERS,
                        ServeConfig(max_lanes=4, max_seq=512, block_size=64,
                                    prefill_impl="ss_fused", decode_impl="paged", seed=0),
                        "granite-20b")
    missing = [k for k in SERVE_KERNELS if granite["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"serve granite-20b: kernels never launched: {missing}")
    return {"serve": main["launches"], f"serve_c{WIDE_C_MODEL}": wide, **telemetry,
            "serve_autotune": tuned,
            "_decode_plan": decode_plan, "serve_default_route": default["launches"],
            "serve_granite_20b": granite["launches"], **serve_chunked_phase(torch, dev, layers),
            **serve_frozen_phase(torch, dev, layers), **serve_deepseek_phase(torch, dev),
            **serve_hymba_phase(torch, dev),
            **serve_replay_phase(torch, dev, WHISPER, "serve_whisper", WHISPER_LENS),
            **serve_llava_phase(torch, dev),
            **serve_replay_phase(torch, dev, XLSTM, "serve_xlstm", XLSTM_LENS,
                                 frozen_twin=False)}


# The reference's core metric families (``tests/test_telemetry.py:308``);
# the exact main path has no rebase, so the two frozen families are
# checked on ``serve_frozen_telemetry``.
CORE_FAMILIES = ("serve_ttft_ticks", "serve_latency_ticks", "serve_ttft_seconds",
                 "serve_itl_seconds", "serve_admitted_total", "serve_tokens_total",
                 "serve_ticks_total", "span_seconds", "pool_utilization",
                 "pool_fragmentation", "autotune_plan_resolutions_total",
                 "spectrum_mass_top1_ema")
FROZEN_FAMILIES = ("serve_rebases_total", "drift_rebase_residual")
TICK_SPANS = ("serve_tick", "admit", "prefill", "decode_dispatch", "device_sync",
              "sample_emit")


def span_means_ms(snapshot: dict) -> dict:
    """Mean host ms of each span name in a registry snapshot."""
    return {k.split("=", 1)[1]: 1e3 * v["sum"] / v["count"]
            for k, v in snapshot.get("span_seconds", {}).items() if v["count"]}


def check_trace(telemetry, label: str, kinds=()) -> None:
    """The telemetry's Chrome trace validates; ``kinds`` all appear among
    its lifeline events."""
    from repro_torch.telemetry import chrome_trace, validate_trace

    trace = chrome_trace(telemetry)
    errors = validate_trace(trace)
    if errors:
        raise AssertionError(f"{label}: the Chrome trace does not validate: {errors[:5]}")
    seen = {k for line in telemetry.flight.lifelines() for k in line.kinds()}
    if set(kinds) - seen:
        raise AssertionError(f"{label}: lifelines lack {set(kinds) - seen}")
    log(f"serve {label}: Chrome trace of {len(trace['traceEvents'])} events validates"
        + (f", lifelines hold {sorted(kinds)}" if kinds else ""))


def serve_telemetry_phase(torch, dev, weights, main_serve, main: dict) -> dict:
    """The main path with telemetry on, on the main path's weights:

    * ``serve_telemetry``: ``telemetry=True``, ``numerics_probe_every=4``;
      tokens and launch counts identical to the telemetry-off ``main`` run;
      the JSONL dump parses and holds CORE_FAMILIES, the Chrome trace
      validates, the numerics probe ran and saw no non-finite value, and
      ``program_shapes`` stays flat when the same prompts run again; prints
      the mean ms of each tick span and tok/s with telemetry on and off;
    * ``serve_telemetry_annotated``: the main path with
      ``Telemetry(annotate=True)`` under ``profile_session``: every span
      name of the run is among the profiler's events.

    Returns each path's launch counts."""
    import numpy as np

    from repro_torch import telemetry as tel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_requests
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, params = weights
    serve = dataclasses.replace(main_serve, telemetry=True, numerics_probe_every=4)
    engine = ServeEngine(cfg, params, serve=serve, device=dev)
    out = serve_requests(engine, SERVE_LENS, 16, seed=0)
    check_served(torch, engine, out, "serve_telemetry", len(SERVE_LENS))
    if out["outputs"] != main["outputs"] or out["launches"] != main["launches"]:
        raise AssertionError(f"serve_telemetry: tokens or launches differ from the "
                             f"telemetry-off main path: {out['launches']} vs "
                             f"{main['launches']}")
    snap = engine.telemetry.metrics.snapshot()
    shapes = engine.stats()["program_shapes"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_telemetry_") as tmp:
        path = os.path.join(tmp, "telemetry.jsonl")
        n = engine.telemetry.dump_jsonl(path, meta={"path": "serve_telemetry"})
        with open(path) as fh:
            lines = [json.loads(x) for x in fh]
    names = {x["name"] for x in lines if x["kind"] == "metric"}
    if len(lines) != n or lines[0]["kind"] != "meta" or set(CORE_FAMILIES) - names:
        raise AssertionError(f"serve_telemetry: JSONL of {len(lines)} lines (wrote {n}) "
                             f"lacks {set(CORE_FAMILIES) - names}")
    check_trace(engine.telemetry, "serve_telemetry")
    nonfinite = sum(v["value"] for v in snap.get("numerics_nonfinite_total", {}).values())
    checks = snap.get("numerics_checks_total", {}).get("value", 0)
    if nonfinite or not checks:
        raise AssertionError(f"serve_telemetry: numerics probe {checks} checks, "
                             f"{nonfinite} non-finite values")
    means = span_means_ms(snap)
    # the same prompts again, new uids: every argument signature was seen
    rng = np.random.default_rng(0)
    for uid, n_tok in enumerate(SERVE_LENS):
        engine.submit(Request(100 + uid, rng.integers(3, cfg.vocab_size, n_tok).tolist(),
                              max_new_tokens=16))
    engine.run()
    again = engine.stats()["program_shapes"]
    if again != shapes:
        raise AssertionError(f"serve_telemetry: program_shapes grew on a second pass of "
                             f"the same prompts: {shapes} -> {again}")
    log(f"serve serve_telemetry: tokens and launches identical to the telemetry-off main "
        f"path ({out['launches']}); JSONL {n} lines; numerics checks {int(checks)}, "
        f"non-finite 0; program_shapes {shapes}, flat over a second pass; span mean ms "
        + ", ".join(f"{k} {means[k]:.3f}" for k in TICK_SPANS if k in means)
        + f" over {snap['serve_ticks_total']['value']:.0f} ticks; tok/s telemetry on "
        f"{out['tok_per_s']:.1f}, off {main['tok_per_s']:.1f}; TTFT mean ms on "
        f"{1e3 * sum(out['ttft_s']) / len(out['ttft_s']):.1f}, off "
        f"{1e3 * sum(main['ttft_s']) / len(main['ttft_s']):.1f}")
    del engine
    gc.collect()

    t = tel.Telemetry(annotate=True)
    engine = ServeEngine(cfg, params, serve=main_serve, device=dev, telemetry=t)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with tel.profile_session(None) as prof:  # the profiler's own trace is not written
        rng = np.random.default_rng(0)
        for uid, n_tok in enumerate(SERVE_LENS):
            engine.submit(Request(uid, rng.integers(3, cfg.vocab_size, n_tok).tolist(),
                                  max_new_tokens=16))
        outputs = engine.run()
    annotated = launch_counts()
    seconds = time.perf_counter() - t0
    averages = prof.key_averages()
    keys = {e.key for e in averages}
    spans = {e["name"] for e in t.tracer.events}
    if set(TICK_SPANS) - spans or spans - keys:
        raise AssertionError(f"serve_telemetry_annotated: spans {sorted(spans)}; missing "
                             f"from the profiler's events: {sorted(spans - keys)}")
    if outputs != main["outputs"]:
        raise AssertionError("serve_telemetry_annotated: tokens differ from the main path")
    device_us = sum(e.self_device_time_total for e in averages
                    if e.key not in spans and e.self_device_time_total > 0)
    log(f"serve serve_telemetry_annotated: {sorted(spans)} all among the profiler's "
        f"{len(keys)} event names; profiled run {seconds:.3f}s, device busy "
        f"{device_us / 1e3:.1f} ms, launches {annotated}")
    del engine, prof, averages
    gc.collect()
    return {"serve_telemetry": out["launches"], "serve_telemetry_annotated": annotated}


def serve_deepseek_phase(torch, dev) -> dict:
    """DeepSeek-V2-Lite on the card (bf16 random weights, seed 0):
    ``serve_deepseek``, every one of its 27 layers at full width on the
    main path (``ss_fused`` prefill, ``paged`` decode, block 16, 4 lanes,
    max_seq 512, prompts of 48/200/333/480 tokens, 16 new tokens each: K1,
    K2 and K5 must launch), then ``serve_deepseek_chunked_frozen``, its
    first DEEPSEEK_FROZEN_LAYERS layers under frozen streaming with chunks
    of 128 and the prefix cache over the A A B C C sequence one request at
    a time (hits 3, misses 2), tokens identical to a cold frozen chunked
    engine (K1 at the chunk site; K5 never on a frozen path)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config

    cfg, params = serve_params(torch, dev, DEEPSEEK, get_config(DEEPSEEK).num_layers,
                               "serve_deepseek")
    main_serve = ServeConfig(max_lanes=4, max_seq=512, prefill_impl="ss_fused",
                             decode_impl="paged", seed=0)
    main = serve_run(torch, dev, DEEPSEEK, cfg.num_layers, main_serve, "serve_deepseek",
                     params=(cfg, params))
    missing = [k for k in SERVE_KERNELS if main["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"serve_deepseek: kernels never launched: {missing}")
    n = DEEPSEEK_FROZEN_LAYERS
    frozen = dataclasses.replace(cfg, num_layers=n, decode_streaming="frozen")
    chunked = dataclasses.replace(main_serve, chunked_prefill=True, prefill_chunk_tokens=128)
    prefix, cold = prefix_runs(torch, dev, frozen, first_layers(params, n), chunked,
                               "serve_deepseek_chunked_frozen")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pst = prefix["stats"]
    if (pst["prefix"]["hits"], pst["prefix"]["misses"]) != (3, 2):
        raise AssertionError(f"serve_deepseek_chunked_frozen: prefix {pst['prefix']}: "
                             f"want hits 3, misses 2")
    if prefix["outputs"] != cold["outputs"]:
        raise AssertionError(f"serve_deepseek_chunked_frozen: tokens differ from the cold "
                             f"frozen chunked run: {prefix['outputs']} vs {cold['outputs']}")
    ran = prefix["launches"]
    if ran["landmark_summary"] <= 0 or ran["paged_row_stats"] or cold["launches"][
            "paged_row_stats"]:
        raise AssertionError(f"serve_deepseek_chunked_frozen: launches {ran}: K1 must run "
                             f"at the chunk site, K5 never")
    log("serve serve_deepseek_chunked_frozen: greedy tokens identical to the cold frozen "
        "chunked run")
    return {"serve_deepseek": main["launches"],
            "serve_deepseek_chunked_frozen": prefix["launches"]}


TIGHT_BLOCKS = 32     # the least pool a 512-token lane allows (32 blocks of 16)
TIGHT_NEW = 64        # enough decode growth to run the pool dry
TIGHT_LAYERS = 8      # depth cut of the tight-pool run, to keep it short


def first_layers(tree, n: int):
    """A parameter tree's first ``n`` layers (views of the stacked axis)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]
    return dict(tree, layers=take(tree["layers"]))


def serve_chunked_phase(torch, dev, layers: int) -> dict:
    """Phase 4's continuous-batching paths on full-width qwen2-7b (one draw
    of weights for all three), each with its launch counts reset just
    before and read just after:

    * ``serve_chunked``: ``chunked_prefill=True``, chunks of 128 > c = 64
      under ``prefill_impl="ss_fused"`` (K1 in every chunk's stats
      handoff), paged decode (K5); K2 never runs;
    * ``serve_chunked_tight``: the same settings on a pool of TIGHT_BLOCKS
      blocks, TIGHT_NEW new tokens, depth cut to TIGHT_LAYERS: decode growth
      runs the pool dry, so requests are preempted (victims caught
      mid-prefill are parked) and resume;
    * ``serve_prefix_cache``: the same settings at TIGHT_LAYERS layers with
      ``prefix_cache=True``, one request at a time to completion: A (384 tokens, cold), A (an
      aligned full hit), B = A's first 256 tokens + 77 of its own (a
      partial hit resuming at 256), C (333, cold), C (an unaligned full hit:
      copy-on-write); hits 3, misses 2, cow_copies >= 1, and greedy tokens
      identical to a cold chunked engine fed the same sequence."""
    from repro_torch.configs.base import ServeConfig

    cfg, params = serve_params(torch, dev, "qwen2-7b", layers, "chunked paths")
    chunked = ServeConfig(max_lanes=4, max_seq=512, prefill_impl="ss_fused",
                          decode_impl="paged", chunked_prefill=True,
                          prefill_chunk_tokens=128, seed=0)
    main = serve_run(torch, dev, "qwen2-7b", layers, chunked, "serve_chunked",
                     params=(cfg, params))
    ran = main["launches"]
    if ran["landmark_summary"] <= 0 or ran["paged_row_stats"] <= 0 or ran["query_side"]:
        raise AssertionError(f"serve_chunked: launches {ran}: K1 and K5 must run, K2 not")

    tight_cfg = dataclasses.replace(cfg, num_layers=min(TIGHT_LAYERS, layers))
    tight = serve_run(torch, dev, "qwen2-7b", tight_cfg.num_layers,
                      dataclasses.replace(chunked, num_blocks=TIGHT_BLOCKS),
                      "serve_chunked_tight",
                      params=(tight_cfg, first_layers(params, tight_cfg.num_layers)),
                      max_new=TIGHT_NEW)
    st = tight["stats"]
    log(f"serve serve_chunked_tight: preemptions {st['preemptions']}, parks "
        f"{st['parks']}, parked resumes {st['parked_resumes']}, resume TTFT p50 "
        f"{st['resume_ttft_s_p50']} s, {st['chunks']} chunks")
    if st["preemptions"] < 1 or st["parks"] < 1 or st["resume_ttft_s_p50"] is None:
        raise AssertionError(f"serve_chunked_tight: no preemption, park or resume: {st}")
    park = park_resume_run(torch, dev, tight_cfg, first_layers(params, tight_cfg.num_layers),
                           chunked)

    prefix, cold = prefix_runs(torch, dev, tight_cfg, first_layers(params, tight_cfg.num_layers),
                               chunked, "serve_prefix_cache")
    st = prefix["stats"]
    if (st["prefix"]["hits"], st["prefix"]["misses"]) != (3, 2) or st["cow_copies"] < 1:
        raise AssertionError(f"serve_prefix_cache: prefix {st['prefix']}, cow_copies "
                             f"{st['cow_copies']}: want hits 3, misses 2, a copy")
    if prefix["outputs"] != cold["outputs"]:
        raise AssertionError(f"serve_prefix_cache: tokens differ from the cold chunked "
                             f"run: {prefix['outputs']} vs {cold['outputs']}")
    log("serve serve_prefix_cache: greedy tokens identical to the cold chunked run")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve_chunked": main["launches"], "serve_chunked_tight": tight["launches"],
            "serve_park_resume": park, "serve_prefix_cache": prefix["launches"]}


def prefix_runs(torch, dev, cfg, params, chunked, label: str,
                telemetry: bool = False) -> tuple:
    """The prefix path's sequence, one request at a time to completion, on
    an engine with ``prefix_cache=True`` over ``chunked``'s settings and on
    a cold ``chunked`` engine: A (384 tokens), A, B (A's first 256 + 77),
    C (333), C, 16 new tokens each, launch counts reset just before each
    engine. With ``telemetry`` the prefix engine runs with it on: its
    lifelines must hold ``prefix_attach`` and ``cow`` and its trace must
    validate. Returns (prefix run, cold run), each checked by
    ``check_served``."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(0)
    a = rng.integers(3, cfg.vocab_size, 384).tolist()
    b = a[:256] + rng.integers(3, cfg.vocab_size, 77).tolist()
    c = rng.integers(3, cfg.vocab_size, 333).tolist()
    runs = {}
    for name, serve in (("prefix", dataclasses.replace(chunked, prefix_cache=True,
                                                       telemetry=telemetry)),
                        ("cold", chunked)):
        engine = ServeEngine(cfg, params, serve=serve, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        outputs, ttft = {}, []
        for uid, prompt in enumerate((a, a, b, c, c)):
            engine.submit(Request(uid, list(prompt), max_new_tokens=16))
            outputs.update(engine.run())
            ttft.append(engine.sched.timing[uid].ttft_s)
        seconds = time.perf_counter() - t0
        out = runs[name] = dict(outputs=outputs, ttft=ttft, launches=launch_counts(),
                                stats=engine.stats(), seconds=seconds,
                                finished=len(outputs))
        out["tokens"] = sum(len(v) for v in outputs.values())
        st = out["stats"]
        log(f"serve {label} ({name}): {cfg.num_layers} layers, "
            f"decode_streaming={cfg.decode_streaming}, A A B C C one at a time, "
            f"{out['tokens']} tokens in {seconds:.3f}s, TTFT ms per request "
            f"{['%.1f' % (1e3 * t) for t in ttft]}, {st['chunks']} chunks, "
            f"prefix {st.get('prefix')}, cow_copies {st['cow_copies']}"
            + (f", rebases {st['rebases']}" if "rebases" in st else "")
            + f", launches {out['launches']}, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
        check_served(torch, engine, out, f"{label} ({name})", 5)
        if engine.telemetry.enabled:
            check_trace(engine.telemetry, f"{label} ({name})",
                        kinds=("prefix_attach", "cow", "prefill_chunk", "rebase"
                               if cfg.decode_streaming == "frozen" else "decode"))
        del engine
        gc.collect()
    torch.cuda.empty_cache()
    return runs["prefix"], runs["cold"]


def park_resume_run(torch, dev, cfg, params, serve) -> dict:
    """The parked-resume branch of the chunked tick. On a tight pool the
    growth loop and the deadlock breaker reclaim a just-parked victim's
    blocks at once (the reference's policy), so a parked snapshot is
    restored only when a lane is preempted while the pool has room, as
    the reference's chaos ``drop_sample`` does. Here: each SERVE_LENS
    prompt alone, first cold, then preempted (``sched.preempt``) after its
    first chunk whenever it has more than one; the parked runs restore the
    host snapshot and resume at the chunk boundary. Greedy tokens and the
    launch counts (no chunk is recomputed) must equal the cold run's.
    Returns the parked run's launch counts."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in SERVE_LENS]
    runs = {}
    for name in ("cold", "parked"):
        engine = ServeEngine(cfg, params, serve=serve, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outputs = {}
        for uid, prompt in enumerate(prompts):
            engine.submit(Request(uid, list(prompt), max_new_tokens=16))
            if name == "parked" and len(prompt) > serve.prefill_chunk_tokens:
                engine.tick()
                engine.sched.preempt(engine.sched.lane_uid.index(uid))
            outputs.update(engine.run())
        out = dict(outputs=outputs, launches=launch_counts(), stats=engine.stats(),
                   finished=len(outputs))
        st = out["stats"]
        log(f"serve serve_park_resume ({name}): qwen2-7b {cfg.num_layers} layers, prompts "
            f"{SERVE_LENS} one at a time, {sum(len(v) for v in outputs.values())} tokens in "
            f"{time.perf_counter() - t0:.3f}s, preemptions {st['preemptions']}, parks "
            f"{st['parks']}, parked resumes {st['parked_resumes']}, {st['chunks']} chunks, "
            f"launches {out['launches']}")
        check_served(torch, engine, out, f"serve_park_resume ({name})", len(prompts))
        runs[name] = out
        del engine
        gc.collect()
    cold, parked = runs["cold"], runs["parked"]
    if parked["launches"]["landmark_summary"] <= 0 or parked["launches"]["paged_row_stats"] <= 0:
        raise AssertionError(f"serve_park_resume: K1 and K5 must run: {parked['launches']}")
    want = sum(n > serve.prefill_chunk_tokens for n in SERVE_LENS)
    st = parked["stats"]
    if (st["preemptions"], st["parks"], st["parked_resumes"]) != (want, want, want):
        raise AssertionError(f"serve_park_resume: preemptions {st['preemptions']}, parks "
                             f"{st['parks']}, parked resumes {st['parked_resumes']}: want "
                             f"{want} each")
    if parked["outputs"] != cold["outputs"] or parked["launches"] != cold["launches"]:
        raise AssertionError(f"serve_park_resume: tokens or launches differ from the cold "
                             f"run: {parked['outputs']} vs {cold['outputs']}, "
                             f"{parked['launches']} vs {cold['launches']}")
    log("serve serve_park_resume: greedy tokens and launches identical to the cold run")
    return parked["launches"]


CHAOS_LAYERS = 8      # depth cut of the chaos, guard and frozen prefix runs
# The chaos soak's four plans (``tests/test_chaos.py:416``), at seed 0.
CHAOS_PLANS = {
    "alloc": (("alloc_fail", dict(rate=0.15)), ("fragment", dict(rate=0.5))),
    "stall": (("admission_stall", dict(start_tick=3, end_tick=10)),
              ("tick_delay", dict(rate=0.2, param=1e-4))),
    "drop": (("drop_sample", dict(rate=0.1)),),
    "cache": (("hash_collision", dict(rate=0.5)),
              ("evict_storm", dict(rate=0.25, param=2))),
}


def assert_no_leaks(engine, label: str) -> None:
    """After drain the free list and the referenced blocks partition the
    pool, no table is left, and every surviving reference is a
    prefix-cache retention (``tests/test_chaos.py:_assert_no_leaks``)."""
    alloc = engine.sched.allocator
    free, refed = alloc._free, set(alloc.refcounts)
    cache_refs = engine.prefix._cache_refs if engine.prefix is not None else {}
    if (alloc.tables or len(free) != len(set(free)) or not refed.isdisjoint(free)
            or refed | set(free) != set(range(1, alloc.num_blocks))
            or any(alloc.refcounts[b] != cache_refs.get(b, 0) for b in refed)):
        raise AssertionError(f"{label}: leaked blocks: tables {alloc.tables}, "
                             f"refcounts {alloc.refcounts}, free {len(free)}")


def traced_run(torch, dev, cfg, params, serve, trace, label: str, plan=None) -> dict:
    """``trace`` through ``replay_trace`` on a fresh engine (chaos ``plan``
    if given), launch counts reset just before; the engine must drain with
    every uid ``finished`` and no block leaked. With ``serve.telemetry`` and
    a plan, ``chaos_injections_total`` must equal the injector's count."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.workload import replay_trace

    engine = ServeEngine(cfg, params, serve=serve, device=dev, chaos=plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    replay_trace(engine, trace, max_ticks=4000)
    seconds = time.perf_counter() - t0
    st = engine.stats()
    out = dict(outputs=dict(engine.finished), launches=launch_counts(), stats=st,
               seconds=seconds, finished=len(engine.finished))
    out["tokens"] = sum(len(v) for v in out["outputs"].values())
    ttft = st["ttft_s"]
    log(f"serve {label}: {cfg.num_layers} layers, {len(trace)} requests, "
        f"{out['tokens']} tokens in {seconds:.3f}s ({out['tokens'] / seconds:.1f} tok/s), "
        f"TTFT mean {1e3 * sum(ttft) / max(len(ttft), 1):.1f} ms, {st['ticks']} ticks "
        f"({1e3 * seconds / max(st['ticks'], 1):.1f} ms per tick), injections "
        f"{st.get('chaos_injections')}, preemptions {st['preemptions']}, parks "
        f"{st['parks']}, watchdog fires {st['watchdog_fires']}, launches "
        f"{out['launches']}, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    if not engine.sched.idle:
        raise AssertionError(f"{label}: the engine did not drain")
    bad = {it.uid: engine.outcomes.get(it.uid) for it in trace
           if engine.outcomes.get(it.uid) != "finished"}
    if bad:
        raise AssertionError(f"{label}: outcomes other than finished: {bad}")
    assert_no_leaks(engine, label)
    check_served(torch, engine, out, label, len(trace))
    if engine.telemetry.enabled and plan is not None:
        counted = engine.telemetry.metrics.snapshot().get("chaos_injections_total", {})
        total = sum(v["value"] for v in counted.values())
        if total != st["chaos_injections"]:
            raise AssertionError(f"{label}: chaos_injections_total {counted} != "
                                 f"{st['chaos_injections']} injections")
        log(f"serve {label}: chaos_injections_total {int(total)} = stats()"
            f"['chaos_injections'], by site {dict(sorted(counted.items()))}")
    del engine
    gc.collect()
    return out


def serve_frozen_phase(torch, dev, layers: int) -> dict:
    """Phase 4's frozen-streaming and chaos paths on full-width qwen2-7b
    (one draw of weights), each with its launch counts reset just before:

    * ``serve_frozen``: the main path's model, depth and settings with
      ``decode_streaming="frozen"``: K1 and K2 launch, K5 never (a frozen
      tick reads no pool); boundary rebases and their ms;
    * ``serve_frozen_telemetry``: the same with telemetry on: tokens and
      launches of ``serve_frozen``, one drift residual per lane rebase
      (p50 / p99 printed), the core and frozen metric families;
    * ``serve_frozen_chunked_prefix`` (CHAOS_LAYERS layers): frozen with
      ``chunked_prefill`` (chunks of 128) and ``prefix_cache`` over the
      prefix path's A A B C C: hits 3, misses 2, tokens identical to a
      cold frozen chunked engine, K5 never; the prefix engine runs with
      telemetry (``prefix_attach`` and ``cow`` lifeline events, a valid
      trace);
    * ``serve_chaos`` (CHAOS_LAYERS layers, exact streaming,
      ``chunked_prefill`` + ``prefix_cache`` + ``watchdog_ticks=16``): a
      seeded Poisson trace, fault-free and then under each of the chaos
      soak's four plans at seed 0: every run drains, every uid finishes,
      no block leaks, at least one injection, tokens identical to the
      fault-free run's; the plans run with telemetry, and
      ``chaos_injections_total`` equals the injector's count;
    * ``serve_guard`` (CHAOS_LAYERS layers, frozen, ``numerics_guard``): a
      ``nan_stats`` rule on lane 0 at ticks 3-4 walks the ladder
      (quarantines 2, demotions 1); the demoted lane runs the exact program
      through K5, so K5 > 0; the other requests' tokens identical to the
      fault-free run's."""
    import numpy as np

    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import chaos
    from repro_torch.serve.workload import TraceItem, poisson_trace

    cfg, params = serve_params(torch, dev, "qwen2-7b", layers, "frozen paths")
    frozen_cfg = dataclasses.replace(cfg, decode_streaming="frozen")
    main_serve = ServeConfig(max_lanes=4, max_seq=512, prefill_impl="ss_fused",
                             decode_impl="paged", seed=0)
    frozen = serve_run(torch, dev, "qwen2-7b", layers, main_serve, "serve_frozen",
                       params=(frozen_cfg, params))
    st, ran = frozen["stats"], frozen["launches"]
    log(f"serve serve_frozen: {st['rebases']} lane rebases, "
        f"{1e3 * st['rebase_s'] / max(st['rebases'], 1):.2f} ms each (rebase wall "
        f"{1e3 * st['rebase_s']:.1f} ms), "
        f"{1e3 * st['decode_s'] / max(st['decode_ticks'], 1):.1f} ms per decode tick")
    if ran["landmark_summary"] <= 0 or ran["query_side"] <= 0 or ran["paged_row_stats"]:
        raise AssertionError(f"serve_frozen: launches {ran}: K1 and K2 must run, K5 not")
    if st["rebases"] <= 0:
        raise AssertionError("serve_frozen: no boundary rebase ran")
    frozen_tel = serve_run(torch, dev, "qwen2-7b", layers,
                           dataclasses.replace(main_serve, telemetry=True),
                           "serve_frozen_telemetry", params=(frozen_cfg, params))
    tst, drift = frozen_tel["stats"], frozen_tel["snapshot"].get("drift_rebase_residual", {})
    missing = set(CORE_FAMILIES + FROZEN_FAMILIES) - set(frozen_tel["snapshot"])
    if (frozen_tel["outputs"] != frozen["outputs"] or frozen_tel["launches"] != ran
            or drift.get("count") != tst["rebases"] or missing):
        raise AssertionError(f"serve_frozen_telemetry: tokens or launches differ from "
                             f"serve_frozen, or drift residuals {drift} against "
                             f"{tst['rebases']} rebases, or families {missing} missing")
    log(f"serve serve_frozen_telemetry: tokens and launches identical to serve_frozen; "
        f"{drift['count']} drift residuals for {tst['rebases']} lane rebases, p50 "
        f"{drift['p50']:.4g}, p99 {drift['p99']:.4g} (bucket bounds), mean "
        f"{drift['sum'] / drift['count']:.4g}, last "
        f"{frozen_tel['snapshot']['drift_rebase_residual_last']['value']:.4g}; spectrum "
        f"top-1 share EMA {frozen_tel['snapshot']['spectrum_mass_top1_ema']['value']:.4g}; "
        f"span mean ms {json.dumps({k: round(v, 3) for k, v in span_means_ms(frozen_tel['snapshot']).items()})}")

    n = min(CHAOS_LAYERS, layers)
    cfg8, frozen8, params8 = (dataclasses.replace(cfg, num_layers=n),
                              dataclasses.replace(frozen_cfg, num_layers=n),
                              first_layers(params, n))
    chunked = dataclasses.replace(main_serve, chunked_prefill=True, prefill_chunk_tokens=128)
    prefix, cold = prefix_runs(torch, dev, frozen8, params8, chunked,
                               "serve_frozen_chunked_prefix", telemetry=True)
    pst = prefix["stats"]
    if (pst["prefix"]["hits"], pst["prefix"]["misses"]) != (3, 2):
        raise AssertionError(f"serve_frozen_chunked_prefix: prefix {pst['prefix']}: "
                             f"want hits 3, misses 2")
    if prefix["outputs"] != cold["outputs"]:
        raise AssertionError(f"serve_frozen_chunked_prefix: tokens differ from the cold "
                             f"frozen chunked run: {prefix['outputs']} vs {cold['outputs']}")
    if prefix["launches"]["paged_row_stats"] or cold["launches"]["paged_row_stats"]:
        raise AssertionError("serve_frozen_chunked_prefix: K5 launched on a frozen path")
    log("serve serve_frozen_chunked_prefix: greedy tokens identical to the cold frozen "
        "chunked run")

    soak = dataclasses.replace(chunked, prefix_cache=True, watchdog_ticks=16)
    trace = poisson_trace(seed=0, n_requests=6, mean_interarrival_ticks=2,
                          prompt_lens=tuple(SERVE_LENS[:3]), vocab_size=cfg.vocab_size,
                          max_new_tokens=16)
    clean = traced_run(torch, dev, cfg8, params8, soak, trace, "serve_chaos (fault-free)")
    chaos_launches = {}
    for name, rules in CHAOS_PLANS.items():
        plan = chaos.FaultPlan(seed=0, rules=tuple(chaos.FaultRule(site, **kw)
                                                   for site, kw in rules))
        out = traced_run(torch, dev, cfg8, params8,
                         dataclasses.replace(soak, telemetry=True), trace,
                         f"serve_chaos ({name})", plan=plan)
        if out["stats"]["chaos_injections"] <= 0:
            raise AssertionError(f"serve_chaos ({name}): no fault was injected")
        if out["outputs"] != clean["outputs"]:
            raise AssertionError(f"serve_chaos ({name}): tokens differ from the "
                                 f"fault-free run: {out['outputs']} vs {clean['outputs']}")
        for k, v in out["launches"].items():
            chaos_launches[k] = chaos_launches.get(k, 0) + v
    log("serve serve_chaos: every plan drained with every request finished, no leaked "
        "block, tokens identical to the fault-free run")

    guard_serve = dataclasses.replace(main_serve, numerics_guard=True)
    rng = np.random.default_rng(0)
    guard_trace = [TraceItem(uid, 0, tuple(rng.integers(3, cfg.vocab_size, n).tolist()), 16)
                   for uid, n in enumerate(SERVE_LENS)]
    fault_free = traced_run(torch, dev, frozen8, params8, guard_serve, guard_trace,
                            "serve_guard (fault-free)")
    plan = chaos.FaultPlan(rules=(chaos.FaultRule("nan_stats", lane=0, start_tick=3,
                                                  end_tick=4),))
    guard = traced_run(torch, dev, frozen8, params8, guard_serve, guard_trace,
                       "serve_guard", plan=plan)
    gst = guard["stats"]
    log(f"serve serve_guard: quarantines {gst['quarantines']}, demotions "
        f"{gst['demotions']}, K5 launches {guard['launches']['paged_row_stats']} (the "
        f"fault-free frozen run: {fault_free['launches']['paged_row_stats']})")
    if gst["quarantines"] < 1 or gst["demotions"] != 1:
        raise AssertionError(f"serve_guard: quarantines {gst['quarantines']}, demotions "
                             f"{gst['demotions']}: want >= 1 and 1")
    if guard["launches"]["paged_row_stats"] <= 0 or fault_free["launches"]["paged_row_stats"]:
        raise AssertionError("serve_guard: K5 must run for the demoted lane only")
    demoted = {uid for uid in guard["outputs"]
               if guard["outputs"][uid] != fault_free["outputs"][uid]}
    if len(demoted) > 1:
        raise AssertionError(f"serve_guard: requests {sorted(demoted)} differ from the "
                             f"fault-free run; only the demoted one may")
    del params, params8
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve_frozen": ran, "serve_frozen_telemetry": frozen_tel["launches"],
            "serve_frozen_chunked_prefix": prefix["launches"],
            "serve_chaos": chaos_launches, "serve_guard": guard["launches"]}


# --------------------------------------------------------------------------
# phase 5: training
# --------------------------------------------------------------------------
def check_heuristic_plan(cfg, shape, dev, label: str) -> None:
    """Without ``autotune``, a ``spectral_shift_fused`` model's train key
    resolves to the heuristic's plan (the kernels' own tilings): no plan
    a registry or an earlier cache file holds steers the run."""
    from repro_torch.kernels import dispatch

    if cfg.attention_impl != "spectral_shift_fused" or cfg.autotune:
        return
    key = dispatch.make_key(shape.seq_len, cfg.num_landmarks, cfg.resolved_head_dim,
                            cfg.compute_dtype, cfg.is_decoder_only, backend=dev.type)
    plan = dispatch.get_plan(key)
    if plan.source != "heuristic":
        raise AssertionError(f"{label}: autotune off, yet {key.encode()} resolves {plan}")


def train_phase(torch, dev, layers: int, steps: int, remat: str = "full",
                round_trip: bool = True, telemetry: bool = False) -> tuple:
    """The single-device ``Trainer`` on full-width Qwen2-7B cut to ``layers``
    layers: bf16 compute, fp32 master weights and AdamW state, ``remat``,
    ``attention_impl="spectral_shift_fused"``, seq 4096, batch TRAIN_BATCH,
    SyntheticLM seed 0. Each step's kernel launches are counted on their
    own and must be K1 2 / K2 2 / K3 1 / K4 1 per layer under "full" and
    "dots" (forward plus the remat recompute; backward once), and K1 1
    under "auto" (on the card: "ss_stats", which keeps K1's outputs). With
    ``round_trip`` a checkpoint round trip of the parameters on the card
    must then be bit-identical. With ``telemetry`` the trainer holds a
    ``Telemetry``: ``train_step_seconds`` and the ``train_step`` spans must
    count every step, the gauges hold the last step's metrics. Returns
    (summed launch counts, mean ms per step after the first, peak GiB, the
    losses)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import ShapeConfig, TrainConfig, resolve_remat
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.params import tree_leaves
    from repro_torch.telemetry import Telemetry
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=layers,
                              attention_impl="spectral_shift_fused", remat=remat)
    resolved = resolve_remat(remat, "gpu")
    if resolved not in ("full", "ss_stats", "dots"):
        raise AssertionError(f"train: remat={remat} resolves to {resolved} on the card")
    shape = ShapeConfig("train_4k", 4096, TRAIN_BATCH, "train")
    tokens = shape.seq_len * shape.global_batch
    expected = dict(landmark_summary=(1 if resolved == "ss_stats" else 2) * layers,
                    query_side=2 * layers,
                    paged_row_stats=0, landmark_summary_bwd=layers,
                    query_side_bwd=layers)
    totals = dict.fromkeys(expected, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0,
                           checkpoint_dir=os.path.join(ckpt_dir, "trainer"))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, tcfg, shape, device=dev,
                          telemetry=Telemetry() if telemetry else None)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(trainer.params))
        log(f"train remat={remat} ({resolved}): qwen2-7b d_model={cfg.d_model} layers="
            f"{layers} seq {shape.seq_len} batch {shape.global_batch}, {n_params / 1e9:.3f} B "
            f"fp32 master params + AdamW state initialized in "
            f"{time.perf_counter() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(steps):
            reset_launch_counts()
            h = trainer.run(1)[-1]
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            log(f"train remat={remat} step {i}: loss {h['loss']:.4f} grad_norm "
                f"{h['grad_norm']:.3f} lr {h['lr']:.3e}, {1e3 * h['step_time_s']:.1f} ms, "
                f"{tokens / h['step_time_s']:.0f} tokens/s, peak "
                f"{peak:.2f} GiB, launches {counts}")
            if not math.isfinite(h["loss"]):
                raise AssertionError(f"train: non-finite loss at step {i}")
            if counts != expected:
                raise AssertionError(f"train: launches per step {counts} != {expected}")
            for k in totals:
                totals[k] += counts[k]
        later = [h["step_time_s"] for h in trainer.metrics_history[1:]]
        mean_s = sum(later) / len(later)
        log(f"train remat={remat}: {steps} steps, loss "
            f"{trainer.metrics_history[0]['loss']:.4f} -> "
            f"{trainer.metrics_history[-1]['loss']:.4f}, mean step after the first "
            f"{1e3 * mean_s:.1f} ms ({tokens / mean_s:.0f} tokens/s), peak device "
            f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [h["loss"] for h in trainer.metrics_history]
        if telemetry:
            snap = trainer.telemetry.metrics.snapshot()
            step_s = snap["train_step_seconds"]
            gauges = {k: snap[f"train_{k}"]["value"] for k in ("loss", "grad_norm", "lr")}
            last = trainer.metrics_history[-1]
            if (step_s["count"] != steps
                    or snap["span_seconds"]["span=train_step"]["count"] != steps
                    or any(gauges[k] != last[k] for k in gauges)):
                raise AssertionError(f"train telemetry: train_step_seconds {step_s}, gauges "
                                     f"{gauges} against {steps} steps and {last}")
            log(f"train remat={remat} with telemetry: train_step_seconds count "
                f"{step_s['count']}, mean {1e3 * step_s['sum'] / step_s['count']:.1f} ms; "
                f"gauges {gauges}; program_shapes "
                f"{snap['program_shapes_total']['program=train_step']['value']:.0f}")
        check_heuristic_plan(cfg, shape, dev, f"train remat={remat}")
        if not round_trip:
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            return totals, 1e3 * mean_s, peak_gib, losses
        t0 = time.perf_counter()
        ckpt = Checkpointer(os.path.join(ckpt_dir, "round_trip"), keep=1)
        ckpt.save(trainer.step, {"params": trainer.params}, blocking=True)
        restored = ckpt.restore(trainer.step, {"params": trainer.params}, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves({"params": trainer.params})))
        log(f"train: checkpoint round trip of {n_params / 1e9:.3f} B parameters "
            f"through {ckpt.directory}: bit-identical {same}, "
            f"{time.perf_counter() - t0:.1f}s")
        if not same:
            raise AssertionError("train: restored parameters differ from the saved ones")
        del trainer, restored
    gc.collect()
    torch.cuda.empty_cache()
    return totals, 1e3 * mean_s, peak_gib, losses


# --------------------------------------------------------------------------
# dispatch: the tilings a measured sweep can choose, and the autotuned paths
# --------------------------------------------------------------------------
TILINGS = (256, 512, 1024)       # dispatch.autotune's block_n candidates
SERVE_TILINGS = (256, 512)       # the same at the serving key (n bucket 512)
SLOT_CHUNKS = (4, 8, 16)         # dispatch.autotune_decode's chunk_slots
PAPER_BERT_BATCH = 8             # train_4k's global batch of 256 cut to 8
# paper-bert's losses, K1-K4 (spectral_shift_fused) against the plain-torch
# spectral_shift, relative: two bf16 routes of one function through 12
# random-weight layers, where the Newton-Schulz core amplifies rounding
# (ROADMAP Queue 3, P1). On the card (H100 80GB HBM3, 700 W) the sound
# runs read 2.4e-3, 1.6e-3 and 3.8e-3 at steps 0-2
PAPER_BERT_TOL = 2e-2
# train_autotune's losses against the heuristic plan's, relative: step 0
# (a forward pass on the same weights) at 5e-3, later steps at 2e-2. Another
# key chunk reorders K1's fp32 merge, which moves bf16 roundings of BV that
# the random-weight core amplifies through 4 bf16 layers (P1), and AdamW
# turns rounding-level gradient differences into lr-sized steps (P3): on
# the card chunks of 1024 keys against the own plan's 448 read 1.4e-3 at
# step 0, 3.8e-3 and 6.2e-3 at steps 1-2
TUNE_LOSS_TOL = (5e-3, 2e-2)
# Both loss bounds are sanity checks, not parity checks: a random-weight
# loss barely moves with attention (K1's output zeroed moves step 0 by
# 9.4e-4 on Qwen2-7B, 3.3e-3 on paper-bert; the steps after it by 0.13-0.29).
# Of the broken-K1 controls (broken_k1) the bounds must catch "zero_bv"
# (K1's output zeroed); "drop_chunk" (the values of the last CONTROL_KEYS
# keys zeroed, about one key chunk of K1's own plan) stays within them, as a
# sound tiling's rounding does, and is only read (PERF.md §6). The kernels'
# parity at every tiling is held in phase 2, the model's in phase 3.
CONTROLS = {"zero_bv": True, "drop_chunk": False}   # kind: must a bound catch it
CONTROL_KEYS = 512
# attention_backend="jnp" runs the very function spectral_shift runs: its
# step-0 loss (one forward on the same weights) equal up to float rounding;
# later steps are read only (an AdamW step turns run-to-run rounding into
# lr-sized moves, P3)
JNP_BACKEND_TOL = 1e-6


def tiling_checks(torch, dev) -> dict:
    """Every tiling the measured sweeps can choose, held against the plain
    versions in fp32 and bf16: K1-K4 at the training shape at each of
    TILINGS (``train_kernel_entries(tile=...)``: K1 / K3 ``chunk_keys``,
    K2 / K4 ``run_rows``), K1 / K2 at the serving shape at SERVE_TILINGS,
    K5 at each of SLOT_CHUNKS and K5' (``paged_row_stats``: one lane, K5
    launched with one lane) on every lane of the serving shape; K1, K2 and
    K5 under ``dispatch.use_tiling`` (the engine's route to a plan's tiling)
    bitwise equal to their launches at that tiling. Overrides the kernels
    cannot take raise ValueError before any launch. Returns
    K5''s timing entry."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.dispatch import use_tiling
    from repro_torch.kernels.paged_decode import (paged_row_stats,
                                                  paged_row_stats_lanes,
                                                  paged_row_stats_plain)
    from repro_torch.kernels.ss_attention import (landmark_summary,
                                                  landmark_summary_plain,
                                                  query_side, query_side_plain)
    from repro_torch.kernels.ss_attention_bwd import query_side_bwd

    for tile in TILINGS:
        train_kernel_entries(torch, dev, tile=tile)
    gen = torch.Generator(device=dev).manual_seed(6)
    b, c, d, n, kvv = 28, 64, 128, 352, 333
    scale = d**-0.5

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q_l, k, v = randn(b, c, d, s=0.5, dtype=dt), randn(b, n, d, s=0.5, dtype=dt), randn(b, n, d, dtype=dt)
        q, k_l, m_mat = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt), randn(b, c, d, dtype=dt)
        delta = randn(b, 1, 1, s=0.1).abs()
        ref1 = landmark_summary_plain(q_l, k, v, scale=scale, kv_end=kvv)
        ref2 = query_side_plain(q, k_l, m_mat, v, delta, scale=scale)
        for tile in SERVE_TILINGS:
            out1 = landmark_summary(q_l, k, v, scale=scale, kv_valid=kvv, chunk_keys=tile)
            out2 = query_side(q, k_l, m_mat, v, delta, scale=scale, run_rows=tile)
            check(f"K1 landmark_summary serving b={b} n={n} kv_valid={kvv} {dname} "
                  f"chunk_keys={tile}", [("out", out1, ref1, None)])
            check(f"K2 query_side serving b={b} n={n} {dname} run_rows={tile}",
                  [("out", out2, ref2, None)])
            with use_tiling(tile):   # the engine's route to the tiling: the same launch
                if not (torch.equal(out1, landmark_summary(q_l, k, v, scale=scale,
                                                           kv_valid=kvv))
                        and torch.equal(out2, query_side(q, k_l, m_mat, v, delta,
                                                         scale=scale))):
                    raise AssertionError(f"tiling: K1 / K2 under use_tiling({tile}) differ "
                                         f"from their launch at that tiling")
    kv_valid = [0, 17, 300, 512]
    bs = 16
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q, k_pool, v_pool, table, kvt = paged_inputs(torch, dev, gen, kv_valid, dtype=dt)
        rm, rl, racc = paged_row_stats_plain(q, (k_pool,), v_pool, table, kvt, scale=scale)
        live = rl[..., 0] > 0
        for cs in SLOT_CHUNKS:
            m, l, acc = paged_row_stats_lanes(q, (k_pool,), v_pool, table, kvt, scale=scale,
                                              block_size=bs, chunk_slots=cs)
            check(f"K5 paged_row_stats kv_valid={kv_valid} {dname} chunk_slots={cs}",
                  [("m", m[..., 0], rm[..., 0], live), ("l", l, rl, None),
                   ("acc", acc, racc, None)])
            with use_tiling(chunk_slots=cs):
                ctx = paged_row_stats_lanes(q, (k_pool,), v_pool, table, kvt, scale=scale,
                                            block_size=bs)
            if not all(torch.equal(a, b_) for a, b_ in zip(ctx, (m, l, acc))):
                raise AssertionError(f"tiling: K5 under use_tiling(chunk_slots={cs}) "
                                     f"differs from its launch at that chunk")
        for cs in (0, SLOT_CHUNKS[0]):
            for ln, kv in enumerate(kv_valid):
                m, l, acc = paged_row_stats(q[ln], (k_pool,), v_pool, table[ln], kv,
                                            scale=scale, block_size=bs, chunk_slots=cs)
                if not kv:   # no valid key: exactly the anchor
                    if not (torch.all(m == -1e30) and torch.all(l == 0)
                            and torch.all(acc == 0)):
                        raise AssertionError("K5': kv_valid 0 must return the anchor")
                    continue
                check(f"K5' paged_row_stats one lane kv_valid={kv} {dname} "
                      f"chunk_slots={cs}",
                      [("m", m[..., 0], rm[ln, ..., 0], live[ln]), ("l", l, rl[ln], None),
                       ("acc", acc, racc[ln], None)])
    before = launch_counts()
    q, k_pool, v_pool, table, kvt = paged_inputs(torch, dev, gen, kv_valid)
    bad = [("chunk_keys=96", lambda: landmark_summary(
                randn(b, c, d, dtype=torch.bfloat16), randn(b, n, d, dtype=torch.bfloat16),
                randn(b, n, d, dtype=torch.bfloat16), scale=scale, chunk_keys=96)),
           ("run_rows=96", lambda: query_side(
               *(randn(*s_, dtype=torch.bfloat16) for s_ in ((b, n, d), (b, c, d), (b, c, d),
                                                             (b, n, d))),
               randn(b, 1, 1), scale=scale, run_rows=96)),
           ("K4 run_rows=64", lambda: query_side_bwd(
               *(randn(*s_, dtype=torch.bfloat16) for s_ in ((b, n, d), (b, c, d), (b, c, d),
                                                             (b, n, d))),
               randn(b, 1, 1), randn(b, n, d, dtype=torch.bfloat16), scale=scale,
               run_rows=64)),
           ("chunk_slots=3", lambda: paged_row_stats_lanes(
               q, (k_pool,), v_pool, table, kvt, scale=scale, block_size=bs,
               chunk_slots=3))]
    for name, call in bad:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"tiling: the override {name} did not raise")
    torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError("tiling: a refused override launched a kernel")
    log(f"tilings: K1-K4 at {TILINGS} (training shape), K1 / K2 at {SERVE_TILINGS} "
        f"(serving shape), K5 at chunk_slots {SLOT_CHUNKS}, K5' on every lane, fp32 and "
        f"bf16, ok; under use_tiling bitwise equal; overrides {[nm for nm, _ in bad]} refused before any launch")
    # K5' timed: one lane of the serving shape at kv_valid 512, pools warm
    q, k_pool, v_pool, table, kvt = paged_inputs(torch, dev, gen, [512])
    err = check("K5' paged_row_stats one lane kv_valid=512 fp32 (timed)", [
        (nm, o, r, None) for nm, o, r in zip(
            ("m", "l", "acc"),
            paged_row_stats(q[0], (k_pool,), v_pool, table[0], 512, scale=scale,
                            block_size=bs),
            (x[0] for x in paged_row_stats_plain(q, (k_pool,), v_pool, table, kvt,
                                                 scale=scale)))])
    return dict(
        fn=[partial(paged_row_stats, q[0], (k_pool,), v_pool, table[0], 512, scale=scale,
                    block_size=bs)],
        plain=partial(paged_row_stats_plain, q, (k_pool,), v_pool, table, kvt, scale=scale),
        library=None, err=err, bound=k5_bound([512], 4, 7, d, d, bs),
        shape=f"one lane, hkv=4 r=7 bs={bs} slots=32 kv_valid=512 fp32, L2 warm")


@contextlib.contextmanager
def broken_k1(kind: str):
    """A deliberately wrong attention route, the control of a training
    loss bound: ``ss_attention_fused``'s K1 call with the values of its last
    CONTROL_KEYS keys zeroed (``"drop_chunk"``: what a split-key merge that
    lost one chunk's partial would give, near enough) or with its output
    zeroed (``"zero_bv"``). Every kernel still launches as before."""
    import torch
    from repro_torch.kernels import ops

    orig = ops.landmark_summary_op

    def wrong(q_l, k, v, **kw):
        if kind == "zero_bv":
            return orig(q_l, k, v, **kw) * 0
        keep = v.shape[1] - CONTROL_KEYS
        return orig(q_l, k, torch.cat([v[:, :keep], torch.zeros_like(v[:, keep:])], 1),
                    **kw)

    ops.landmark_summary_op = wrong
    try:
        yield
    finally:
        ops.landmark_summary_op = orig


def rel_diffs(losses, ref) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(losses, ref)]


def controls(torch, dev, cfg, shape, ref: list, tols: list, label: str) -> dict:
    """Each broken-K1 control (``broken_k1``) for 3 steps of ``cfg``, its
    losses' relative distance from ``ref`` read against each step's bound in
    ``tols``: a control CONTROLS marks must pass a bound at some step, or
    the bound could not tell that broken route from a sound one. Returns
    each control's distances."""
    out = {}
    for kind, must in CONTROLS.items():
        with broken_k1(kind):
            run = train_steps(torch, dev, cfg, shape, len(tols), f"{label} control {kind}")
        out[kind] = rel_diffs(run["losses"], ref)
        caught = any(r > t for r, t in zip(out[kind], tols))
        log(f"{label} control {kind}: rel diff from the sound reference "
            f"{['%.2e' % x for x in out[kind]]} (bounds {tols}): "
            f"{'caught' if caught else 'within the bounds'}")
        if must and not caught:
            raise AssertionError(f"{label}: the control {kind} stays within the bounds "
                                 f"{tols} ({out[kind]}): the bound cannot catch it")
    return out


def train_autotune_phase(torch, dev, layers: int, ref_losses: list) -> tuple:
    """``train_autotune``: the phase-5 trainer (full-width Qwen2-7B cut to
    ``layers`` layers, train_4k at batch TRAIN_BATCH, spectral_shift_fused,
    remat full) with ``autotune=True``, the cache in a temporary directory
    (``REPRO_AUTOTUNE_CACHE``). Its warm-up times K1-K4, forward and
    backward, at each tiling the kernels take at the train shape on the
    device, registers and saves the fastest (each candidate's ms printed);
    the plan must be a kernel plan. 3 steps follow, with the phase-5
    launches per step (K1 2 / K2 2 / K3 1 / K4 1 a layer) and losses
    within TUNE_LOSS_TOL of the heuristic plan's (``ref_losses``); the
    broken-K1 controls must pass that bound. A second ``Trainer`` with a
    new registry (as a new process) resolves from disk: ``outcome="disk"``
    1, no sweep. Returns (launch counts of the 3 steps, the plan)."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
    from repro_torch.telemetry import Telemetry
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=layers,
                              attention_impl="spectral_shift_fused", remat="full",
                              autotune=True)
    shape = ShapeConfig("train_4k", 4096, TRAIN_BATCH, "train")
    steps = 3
    tols = [TUNE_LOSS_TOL[min(i, 1)] for i in range(steps)]
    run_cache = os.environ["REPRO_AUTOTUNE_CACHE"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "ss_autotune.json")
        dispatch.clear_registry()
        try:
            tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0,
                               checkpoint_dir=os.path.join(tmp, "a"))
            tel = Telemetry()
            t0 = time.perf_counter()
            trainer = Trainer(cfg, tcfg, shape, device=dev, telemetry=tel)
            plan = trainer.plan
            key = dispatch.make_key(shape.seq_len, cfg.num_landmarks, cfg.resolved_head_dim,
                                    cfg.compute_dtype, True, backend=dev.type)
            sweep = dispatch.SWEEPS[key.encode()]
            snap = tel.metrics.snapshot()
            log(f"train_autotune: sweep at b={shape.global_batch * cfg.num_heads} n="
                f"{shape.seq_len} c={cfg.num_landmarks} d={cfg.resolved_head_dim} bf16 causal "
                f"(key {key.encode()}), device ms of K1+K2+K3+K4: "
                + ", ".join(f"{p.impl}/b{p.block_n} {1e3 * t:.4f}" for p, t in sweep)
                + f"; winner {plan.impl}/b{plan.block_n} ({plan.source}); sweep launches "
                f"(counted apart) {dispatch.SWEEP_LAUNCHES}; resolutions "
                f"{snap['autotune_plan_resolutions_total']}, sweeps "
                f"{snap['autotune_sweeps_total']}; trainer ready in "
                f"{time.perf_counter() - t0:.1f}s")
            if (plan.source != "autotuned" or plan.impl != "fused"
                    or snap["autotune_sweeps_total"] != {"family=self": {"value": 1.0}}):
                raise AssertionError(f"train_autotune: the warm-up did not sweep the "
                                     f"kernels once: {plan}, {snap}")
            expected = dict(landmark_summary=2 * layers, query_side=2 * layers,
                            paged_row_stats=0, landmark_summary_bwd=layers,
                            query_side_bwd=layers)
            totals = dict.fromkeys(expected, 0)
            for i in range(steps):
                reset_launch_counts()
                trainer.run(1)
                counts = launch_counts()
                if counts != expected:
                    raise AssertionError(f"train_autotune: launches {counts} != {expected}")
                for k_ in totals:
                    totals[k_] += counts[k_]
            losses = [h["loss"] for h in trainer.metrics_history]
            later = [h["step_time_s"] for h in trainer.metrics_history[1:]]
            rel = rel_diffs(losses, ref_losses)
            log(f"train_autotune: {steps} steps under {plan.impl}/b{plan.block_n}: losses "
                f"{['%.4f' % x for x in losses]} vs the heuristic plan's "
                f"{['%.4f' % x for x in ref_losses[:steps]]}, rel diff "
                f"{['%.2e' % x for x in rel]} (tol {tols}); "
                f"{1e3 * sum(later) / len(later):.1f} ms per step after the first, "
                f"launches per step {expected}")
            if any(r > t for r, t in zip(rel, tols)):
                raise AssertionError(f"train_autotune: losses {losses} differ from "
                                     f"{ref_losses}: rel {rel} past {tols}")
            repeats = []   # the sweep again, unsaved: is its winner stable?
            for _ in range(2):
                rerun = dispatch.autotune(shape.seq_len, cfg.num_landmarks,
                                          cfg.resolved_head_dim, dtype=cfg.compute_dtype,
                                          causal=True, batch=shape.global_batch * cfg.num_heads,
                                          backward=True, save=False)
                repeats.append(f"winner b{rerun.block_n}: " + ", ".join(
                    f"b{p.block_n} {1e3 * t:.4f}" for p, t in dispatch.SWEEPS[key.encode()]))
            log(f"train_autotune: the sweep repeated twice (device ms of K1-K4): "
                + "; ".join(repeats))
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            dispatch.clear_registry()   # a new process: the plan comes from disk
            tel2 = Telemetry()
            again = Trainer(cfg, dataclasses.replace(
                tcfg, checkpoint_dir=os.path.join(tmp, "b")), shape, device=dev,
                telemetry=tel2)
            snap2 = tel2.metrics.snapshot()
            log(f"train_autotune: a second Trainer (new registry) resolves "
                f"{again.plan.impl}/b{again.plan.block_n} ({again.plan.source}); "
                f"resolutions {snap2['autotune_plan_resolutions_total']}, sweeps "
                f"{snap2.get('autotune_sweeps_total', {})}, plan_resolution spans "
                f"{snap2['span_seconds']['span=plan_resolution']['count']}")
            if (snap2["autotune_plan_resolutions_total"] != {"outcome=disk": {"value": 1.0}}
                    or "autotune_sweeps_total" in snap2
                    or (again.plan.impl, again.plan.block_n) != (plan.impl, plan.block_n)):
                raise AssertionError(f"train_autotune: the second trainer did not resolve "
                                     f"from disk: {again.plan}, {snap2}")
            del again
        finally:
            os.environ["REPRO_AUTOTUNE_CACHE"] = run_cache
            dispatch.clear_registry()
    gc.collect()
    torch.cuda.empty_cache()
    controls(torch, dev, dataclasses.replace(cfg, autotune=False), shape, ref_losses[:steps],
             tols, "train_autotune")
    return totals, plan


def serve_autotune_phase(torch, dev, weights, main_serve, main: dict) -> tuple:
    """``serve_autotune``: the main path's model, weights and settings with
    ``autotune=True``: the engine's warm-up times K5 on the device across
    the view quanta and slot chunks at block 16 and this deployment's lanes
    and heads (a "paged" plan: the gather route is plain PyTorch and no
    candidate on the card), and resolves the prefill plan. K1, K2 and K5
    must launch. Then the chosen tilings' logits against the kernels'
    own at 2 full-width fp32 layers (``drive_model(plans=...)``): within
    MODEL_TOL of max-abs. Returns (launch counts, decode plan, prefill
    plan)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import random_params

    cfg, params = weights
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as tmp:
        acfg = dataclasses.replace(cfg, autotune=True,
                                   autotune_cache=os.path.join(tmp, "ss_autotune.json"))
        dispatch.clear_registry()
        try:
            out = serve_run(torch, dev, "qwen2-7b", cfg.num_layers, main_serve,
                            "serve_autotune", params=(acfg, params))
            dkey = dispatch.make_key(main_serve.max_seq, cfg.num_landmarks,
                                     cfg.resolved_head_dim, cfg.compute_dtype, True,
                                     backend=dev.type, family="decode")
            pkey = dispatch.make_key(main_serve.max_seq, cfg.num_landmarks,
                                     cfg.resolved_head_dim, cfg.compute_dtype, False,
                                     backend=dev.type)
            dplan, pplan = dispatch.get_plan(dkey), dispatch.get_plan(pkey)
            sweep = dispatch.SWEEPS[dkey.encode()]
        finally:
            dispatch.clear_registry()
    same = sum(out["outputs"][u] == main["outputs"][u] for u in main["outputs"])
    log(f"serve_autotune: decode sweep at block {main_serve.block_size} ({dkey.encode()}): "
        + ", ".join(f"{p.impl}/b{p.block_n}/t{p.block_table} {1e3 * t:.4f} ms"
                    for p, t in sweep)
        + f"; decode plan {out['stats']['decode_plan']}, prefill plan "
        f"{pplan.impl}/b{pplan.block_n} ({pplan.source}); {same}/{len(main['outputs'])} "
        f"requests' tokens identical to the autotune-off main path")
    missing = [k for k in SERVE_KERNELS if out["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"serve_autotune: kernels never launched: {missing}")
    if dplan.source != "autotuned" or dplan.impl != "paged":
        raise AssertionError(f"serve_autotune: the decode key was not swept over K5: "
                             f"{dplan}")
    plans = (pplan.block_n, dplan.block_n, dplan.block_table)
    mcfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2, compute_dtype="float32")
    mparams = random_params(mcfg, seed=0, device=dev)
    prompt_lens = (48, 333)
    own, fed, _ = drive_model(torch, mparams, mcfg, dev, prompt_lens)
    with dispatch.use_tiling(pplan.block_n, dplan.block_n):
        tuned, _, _ = drive_model(torch, mparams, mcfg, dev, prompt_lens, feed=fed,
                                  view_quantum=dplan.block_table)
    del mparams
    torch.cuda.empty_cache()
    errs = logit_errs(torch, "serve_autotune", tuned, own, prompt_lens)
    log(f"serve_autotune: 2 fp32 layers, prompts {prompt_lens}, 4 paged decode steps at "
        f"the chosen tilings (prefill block_n, K5 chunk_slots, view quantum) = {plans} vs "
        f"the kernels' own: logit err of max-abs per output "
        f"{['%.2e' % e for e in errs]} (tol {MODEL_TOL})")
    if not max(errs) <= MODEL_TOL:
        raise AssertionError(f"serve_autotune: logit err {max(errs):.3e} > {MODEL_TOL}")
    return out["launches"], dplan, pplan


def train_steps(torch, dev, cfg, shape, steps: int, label: str, data=None) -> dict:
    """``steps`` steps of a fresh ``Trainer`` (seed 0; ``data``: its batch
    source, ``SyntheticLM`` by default): losses, mean ms per step after the
    first, peak GiB and the launches summed over the steps."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0,
                           checkpoint_dir=tmp)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, tcfg, shape, device=dev, data=data)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check_heuristic_plan(cfg, shape, dev, label)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        hist = trainer.run(steps)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    later = [h["step_time_s"] for h in hist[1:]]
    ms = 1e3 * sum(later) / len(later)
    tokens = shape.seq_len * shape.global_batch
    impl = cfg.attention_impl + (f" (encoder {cfg.encoder_attention_impl})"
                                 if cfg.family == "audio" else "")
    log(f"{label}: {cfg.name} {impl} layers={cfg.num_layers} d_model="
        f"{cfg.d_model} heads={cfg.num_heads} seq {shape.seq_len} batch "
        f"{shape.global_batch}: losses {['%.4f' % x for x in losses]}, {ms:.1f} ms per "
        f"step after the first ({tokens / ms * 1e3:.0f} tokens/s), peak {peak:.2f} GiB, "
        f"launches {counts}, init {init_s:.1f}s")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    return dict(losses=losses, ms=ms, peak=peak, launches=counts)


def train_paper_bert_phase(torch, dev) -> dict:
    """``train_paper_bert``: the paper's own config at its full size (12
    layers, d_model 512, 8 heads of 64, c = 64, vocab 30522), train_4k's
    seq 4096 at batch PAPER_BERT_BATCH, 3 steps each under
    ``spectral_shift`` (plain torch: no kernel may launch), ``nystrom`` (no
    kernel), ``spectral_shift_fused`` (K1-K4 through dispatch at d = 64:
    K1 2 / K2 2 / K3 1 / K4 1 per layer and step under remat full) and
    ``spectral_shift_fused`` with ``attention_backend="jnp"`` (``jnp_backend``:
    dispatch's plain route, no kernel may launch, the step-0 loss within
    JNP_BACKEND_TOL of spectral_shift's); the fused losses within PAPER_BERT_TOL (relative) of
    spectral_shift's, and the broken-K1 controls past it. Returns each run's
    launch counts by path name."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config

    shape = ShapeConfig("train_4k", 4096, PAPER_BERT_BATCH, "train")
    runs = {}
    variants = {"spectral_shift": {}, "nystrom": {}, "spectral_shift_fused": {},
                "jnp_backend": dict(attention_impl="spectral_shift_fused",
                                    attention_backend="jnp")}
    for name, kw in variants.items():
        cfg = dataclasses.replace(get_config("paper-bert"),
                                  **(kw or dict(attention_impl=name)))
        runs[name] = train_steps(torch, dev, cfg, shape, 3, f"train_paper_bert {name}")
        layers = cfg.num_layers
        want = (dict(landmark_summary=6 * layers, query_side=6 * layers, paged_row_stats=0,
                     landmark_summary_bwd=3 * layers, query_side_bwd=3 * layers)
                if name == "spectral_shift_fused" else dict.fromkeys(runs[name]["launches"], 0))
        if runs[name]["launches"] != want:
            raise AssertionError(f"train_paper_bert {name}: launches "
                                 f"{runs[name]['launches']} != {want}")
    ref, fused = runs["spectral_shift"]["losses"], runs["spectral_shift_fused"]["losses"]
    jnp_rel = rel_diffs(runs["jnp_backend"]["losses"], ref)
    if not jnp_rel[0] <= JNP_BACKEND_TOL:
        raise AssertionError(f"train_paper_bert: attention_backend='jnp' step-0 loss "
                             f"{runs['jnp_backend']['losses'][0]} differs from "
                             f"spectral_shift's {ref[0]}")
    rel = rel_diffs(fused, ref)
    log(f"train_paper_bert: ms per step spectral_shift {runs['spectral_shift']['ms']:.1f}, "
        f"nystrom {runs['nystrom']['ms']:.1f}, spectral_shift_fused "
        f"{runs['spectral_shift_fused']['ms']:.1f}; fused losses vs spectral_shift's rel "
        f"diff {['%.2e' % x for x in rel]} (tol {PAPER_BERT_TOL})")
    if not max(rel) <= PAPER_BERT_TOL:
        raise AssertionError(f"train_paper_bert: fused losses {fused} differ from "
                             f"spectral_shift's {ref} by {max(rel):.3e} > {PAPER_BERT_TOL}")
    log(f"train_paper_bert: nystrom's losses vs spectral_shift's rel diff "
        f"{['%.2e' % x for x in rel_diffs(runs['nystrom']['losses'], ref)]}; "
        f"attention_backend='jnp' launched no kernel, losses vs spectral_shift's rel diff "
        f"{['%.2e' % x for x in jnp_rel]} (step 0 tol {JNP_BACKEND_TOL}), "
        f"{runs['jnp_backend']['ms']:.1f} ms per step")
    controls(torch, dev, dataclasses.replace(get_config("paper-bert"),
                                             attention_impl="spectral_shift_fused"),
             shape, ref, [PAPER_BERT_TOL] * len(ref), "train_paper_bert")
    # past 64 landmarks: the same run at c = 128 (seg 32), K1-K4 in every layer
    label = f"train_paper_bert_c{WIDE_C_MODEL}"
    cfg = dataclasses.replace(get_config("paper-bert"), attention_impl="spectral_shift_fused",
                              num_landmarks=WIDE_C_MODEL)
    t0 = time.perf_counter()
    wide = train_steps(torch, dev, cfg, shape, 3, label)
    log(f"{label}: {time.perf_counter() - t0:.1f}s with the Trainer's set-up")
    if wide["launches"] != runs["spectral_shift_fused"]["launches"]:
        raise AssertionError(f"{label}: launches {wide['launches']} != the c = 64 run's "
                             f"{runs['spectral_shift_fused']['launches']}")
    losses = wide["losses"]
    log(f"{label}: losses {['%.4f' % x for x in losses]} vs the c = 64 run's "
        f"{['%.4f' % x for x in fused]} (rel diff "
        f"{['%.2e' % x for x in rel_diffs(losses, fused)]}), "
        f"{wide['ms']:.1f} ms per step vs {runs['spectral_shift_fused']['ms']:.1f}")
    # a sanity bound: at random weights paper-bert's losses sit near ln(vocab)
    # and drift by a few 1e-3 over 3 steps at either c (the c = 64 run's rose
    # 10.8216 -> 10.8353 on an H100), so "decreasing or flat" is
    # held as no step above step 0 by more than PAPER_BERT_TOL, and each step
    # within PAPER_BERT_TOL of the c = 64 run's
    if not (max(losses) <= losses[0] * (1 + PAPER_BERT_TOL)
            and max(rel_diffs(losses, fused)) <= PAPER_BERT_TOL):
        raise AssertionError(f"{label}: losses {losses} rose past step 0 or left the "
                             f"c = 64 run's {fused} by more than {PAPER_BERT_TOL}")
    return {**{f"train_paper_bert_{impl}": r["launches"] for impl, r in runs.items()},
            label: wide["launches"]}


def train_chunked_phase(torch, dev, layers: int) -> dict:
    """``train_chunked``: full-width Qwen2-7B with its own config's
    ``attention_impl="chunked"`` (exact attention over key blocks of 1024,
    plain torch), ``layers`` layers, train_4k's seq 4096 at batch
    TRAIN_BATCH, 3 steps, beside the same under ``"full"``: no kernel may
    launch; step time and peak memory of each. Returns their launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config

    shape = ShapeConfig("train_4k", 4096, TRAIN_BATCH, "train")
    out = {}
    for impl in ("chunked", "full"):
        cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=layers,
                                  attention_impl=impl)
        run = train_steps(torch, dev, cfg, shape, 3, f"train_{impl}")
        if any(run["launches"].values()):
            raise AssertionError(f"train_{impl}: a kernel launched: {run['launches']}")
        out[f"train_{impl}"] = run
    log(f"train_chunked: {out['train_chunked']['ms']:.1f} ms per step, peak "
        f"{out['train_chunked']['peak']:.2f} GiB; full {out['train_full']['ms']:.1f} ms per "
        f"step, peak {out['train_full']['peak']:.2f} GiB")
    return {k: v["launches"] for k, v in out.items()}


def autotuned_rows(torch, dev, kernels: list, train_plan, decode_plan) -> None:
    """Time each kernel at the tiling the sweeps chose, at the shape of its
    heuristic row (K1-K4 at the training shape, K5 at the serving shape),
    as a nested ``autotuned_launch`` entry of its ``kernels`` row."""
    rows = {k["name"]: k for k in kernels}
    tile = train_plan.block_n
    if tile:
        entries = train_kernel_entries(torch, dev, tile=tile)
        for name, tag in (("landmark_summary", "landmark_summary_train"),
                          ("query_side", "query_side_train"),
                          ("landmark_summary_bwd", "landmark_summary_bwd"),
                          ("query_side_bwd", "query_side_bwd")):
            rows[name]["autotuned_launch"] = dict(
                plan=f"{train_plan.impl}/b{tile}", shape=entries[tag]["shape"],
                **timed_entry(f"{tag} autotuned", entries[tag]))
    else:
        log("autotuned rows: the training sweep chose the kernels' own tilings: "
            "the heuristic rows are its rows")
    cs = decode_plan.block_n
    if cs:
        from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,
                                                      paged_row_stats_plain)

        gen = torch.Generator(device=dev).manual_seed(7)
        kv_valid = [0, 17, 300, 512]
        q, k_pool, v_pool, table, kvt = paged_inputs(torch, dev, gen, kv_valid)
        pools = cold_pools(k_pool, v_pool)
        scale = 128 ** -0.5
        out = paged_row_stats_lanes(q, (k_pool,), v_pool, table, kvt, scale=scale,
                                    block_size=16, chunk_slots=cs)
        ref = paged_row_stats_plain(q, (k_pool,), v_pool, table, kvt, scale=scale)
        live = ref[1][..., 0] > 0
        err = check(f"K5 paged_row_stats chunk_slots={cs} (autotuned)",
                    [("m", out[0][..., 0], ref[0][..., 0], live), ("l", out[1], ref[1], None),
                     ("acc", out[2], ref[2], None)])
        rows["paged_row_stats"]["autotuned_launch"] = dict(
            plan=f"paged/b{cs}/t{decode_plan.block_table}",
            **timed_entry("paged_row_stats autotuned", dict(
                fn=[partial(paged_row_stats_lanes, q, (kp,), vp, table, kvt, scale=scale,
                            block_size=16, chunk_slots=cs) for kp, vp in pools],
                plain=[partial(paged_row_stats_plain, q, (kp,), vp, table, kvt,
                               scale=scale) for kp, vp in pools],
                library=None, err=err, bound=k5_bound(kv_valid, 4, 7, 128, 128, 16),
                shape=f"lanes=4 hkv=4 r=7 bs=16 slots=32 kv_valid={kv_valid} fp32, "
                      f"L2 cold ({len(pools)} pool copies), chunk_slots={cs}")))
    else:
        log("autotuned rows: the decode sweep chose K5's own slot chunk: its "
            "heuristic rows are its rows")


# --------------------------------------------------------------------------
# Hymba-1.5B (hybrid: GQA + mamba) and DeepSeek-V2-Lite training
# --------------------------------------------------------------------------
HYMBA = "hymba-1.5b"
HYMBA_LENS = [16, 40, 64, 100]   # token replay costs a tick per prompt token
HYMBA_TRAIN_BATCH = 2            # train_4k's global batch of 256 cut to 2
HYMBA_LAYERS = 8                 # served and trained (of 32): chip time for ep_train / pp_train
DEEPSEEK_TRAIN_LAYERS = 4        # of 27: 16 B a parameter of masters and AdamW state
DEEPSEEK_TRAIN_BATCH = 1


def k5_model_entries(torch, dev, model: str, prefix: str, *, hkv: int, r: int, d: int,
                     cases, bs: int = 16, seed: int = 10) -> dict:
    """K5 at one model's decode shape: 4 lanes, ``hkv`` kv heads, ``r``
    query rows each, d = dv = ``d``, block ``bs``; each case (tag suffix,
    kv_valid per lane, table slots) in fp32 pools as the engine stores
    them and in bf16, held against its plain version (a kv_valid-0 lane
    exactly (m=-1e30, l=0, acc=0)) and set up for timing in fp32 with L2
    cold."""
    from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,
                                                  paged_row_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = d**-0.5
    out = {}
    for suffix, kv, n_slots in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, k_pool, v_pool, table, kvv = paged_inputs(
                torch, dev, gen, kv, hkv=hkv, r=r, d=d, dv=d, bs=bs, n_slots=n_slots,
                dtype=dt)
            m, l, acc = paged_row_stats_lanes(q, (k_pool,), v_pool, table, kvv,
                                              scale=scale, block_size=bs)
            rm, rl, racc = paged_row_stats_plain(q, (k_pool,), v_pool, table, kvv,
                                                 scale=scale)
            shape = (f"{model} decode: lanes=4 hkv={hkv} r={r} d=dv={d} bs={bs} "
                     f"slots={n_slots} kv_valid={kv} {str(dt).split('.')[-1]}")
            empty = [i for i, k in enumerate(kv) if k == 0]
            if empty and not (torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0)
                              and torch.all(acc[empty] == 0)):
                raise AssertionError(f"K5 at {model}'s shape: a lane with kv_valid = 0 "
                                     f"must return (m=-1e30, l=0, acc=0)")
            live = rl[..., 0] > 0
            err = check(f"K5 {shape}", [("m", m[..., 0], rm[..., 0], live),
                                        ("l", l, rl, None), ("acc", acc, racc, None)])
        # timed in fp32, the pools' type on the path
        pools = cold_pools(k_pool, v_pool)
        out[f"{prefix}_paged_row_stats{suffix}"] = dict(
            fn=[partial(paged_row_stats_lanes, q, (kp,), vp, table, kvv, scale=scale,
                        block_size=bs) for kp, vp in pools],
            plain=[partial(paged_row_stats_plain, q, (kp,), vp, table, kvv, scale=scale)
                   for kp, vp in pools],
            library=None, err=err, bound=k5_bound(kv, hkv, r, d, d, bs),
            shape=f"{shape}, L2 cold ({len(pools)} pool copies)")
    return out


def hymba_k5_entries(torch, dev) -> dict:
    """K5 at Hymba-1.5B's decode shape (5 kv heads, r = 5, d = 64; kv_valid
    0 / 17 / 60 / 116, the first replay tick's empty lane among them) and
    at a 16k horizon (2k-16k keys, 1024 slots)."""
    return k5_model_entries(torch, dev, "hymba-1.5b", "hymba", hkv=5, r=5, d=64, cases=(
        ("", [0, 17, 60, 116], 32), ("_long", [2048, 4096, 8192, 16384], 1024)))


def drive_replay(torch, params, cfg, device, prompt_lens, feed=None, steps: int = 4,
                 block_size: int = 16) -> tuple:
    """Serving of a family without batched prefill (Hymba) as the engine
    runs it: every lane fed its prompt one token a tick through the paged
    decode step (K5 over the pools) from zeroed lane state, the first tick
    at kv_valid 0, then greedy tokens; a lane whose prompt has ended
    decodes while the others replay; ``steps`` ticks past the longest
    prompt. ``feed``: the tokens to feed each tick instead (another run's).
    Returns (per-tick logits (lanes, V) on the CPU, fed tokens per tick,
    ticks)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.paged import BlockAllocator, PagedKVCache

    serve = ServeConfig(max_lanes=len(prompt_lens), max_seq=512, block_size=block_size,
                        decode_impl="paged")
    bs, seq_max = serve.block_size, serve.max_seq
    kv = PagedKVCache(cfg, serve, device)
    alloc = BlockAllocator(serve.resolved_num_blocks, bs)
    step = kv.make_paged_step(lambda c_, t_, tb: decode_step(
        params, cfg, c_, t_, seq_max=seq_max, paged_table=tb, block_size=bs))
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in prompt_lens]
    lanes = len(prompts)
    positions = torch.zeros(lanes, dtype=torch.int32)
    nxt = [p[0] for p in prompts]
    outs, fed = [], []
    ticks = max(prompt_lens) + steps
    for t in range(ticks):
        tables = torch.zeros((lanes, seq_max // bs), dtype=torch.int32)
        for lane in range(lanes):
            if int(positions[lane]) // bs >= len(alloc.tables.get(lane, [])):
                alloc.alloc(lane, 1)
            tables[lane, :len(alloc.tables[lane])] = torch.tensor(alloc.tables[lane])
        toks = feed[t] if feed is not None else nxt
        fed.append(list(toks))
        lg = step(tables.to(device), torch.tensor(toks)[:, None].to(device),
                  positions.to(device), torch.ones(lanes, dtype=torch.bool, device=device))
        outs.append(lg[:, 0].float().cpu())
        positions += 1
        greedy = lg[:, 0].argmax(-1).cpu().tolist()
        nxt = [p[t + 1] if t + 1 < len(p) else g for p, g in zip(prompts, greedy)]
    return outs, fed, ticks


def grad_errs(torch, grads, pgrads) -> dict:
    """Each gradient leaf's max-abs error against ``pgrads``, relative to
    its max-abs; every leaf must be finite."""
    from repro_torch.models.params import flatten_with_paths, tree_leaves

    errs = {}
    for (path, g), pg in zip(flatten_with_paths(grads).items(), tree_leaves(pgrads)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite gradient in {path}")
        err, scale = max_err(g, pg)
        errs[path] = err / max(scale, 1e-30)
    return errs


def hymba_model_checks(torch, dev) -> None:
    """Hymba-1.5B at full width, fp32, kernel route against the plain route
    on the card: token-replay serving logits (``drive_replay``, prompts of
    16 and 40 tokens and 4 greedy ticks past the longer: K5 once a layer a
    tick at hkv 5, r 5, d 64, from kv_valid 0) at 1 layer, every tick at
    MODEL_TOL, and at 2 layers printed: replay runs every position through
    the first 2-4 landmark segments, where the second layer amplifies
    delta's rounding (ROADMAP P2; measured up to 5.3e-3 there, 2.4e-4
    past); at 2 layers the loss and every gradient leaf of one grad step under
    ``spectral_shift_fused`` (seq 512, batch 1: K1-K4 at d = 64 beside the
    mamba scan) at GRAD_TOL; and remat "ss_stats" (the selective
    checkpoint meeting the mamba ops: K1's outputs kept, the rest, the scan
    included, recomputed) against "none" at REMAT_TOL. Then one fp32 grad
    step of DeepSeek-V2-Lite at full width, 2 layers, seq 512 (MLA + MoE,
    no kernel): ``chunked`` attention against ``full``, at GRAD_TOL."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import make_grad_step

    worst = {}
    for layers in (1, 2):
        cfg = dataclasses.replace(get_config(HYMBA), num_layers=layers,
                                  compute_dtype="float32")
        t0 = time.perf_counter()
        params = random_params(cfg, seed=0, device=dev)
        before = launch_counts()
        card, fed, ticks = drive_replay(torch, params, cfg, dev, (16, 40))
        after = launch_counts()
        k5 = after["paged_row_stats"] - before["paged_row_stats"]
        if (k5 != ticks * cfg.num_layers
                or any(after[k] != before[k] for k in TRAIN_KERNELS)):
            raise AssertionError(f"model parity {HYMBA}: K5 launched {k5} times, want "
                                 f"{ticks * cfg.num_layers}; launches {after}")
        with plain_route():
            plain, _, _ = drive_replay(torch, params, cfg, dev, (16, 40), feed=fed)
        if launch_counts() != after:
            raise AssertionError(f"model parity {HYMBA}: the plain route launched a kernel")
        errs = []
        for a, b in zip(card, plain):
            if not torch.isfinite(a).all():
                raise AssertionError(f"model parity {HYMBA}: non-finite logits")
            err, scale = max_err(a, b)
            errs.append(err / scale)
        worst[layers] = max(errs)
        # positions 8-31 are the first 2-4 landmark segments (seg 8): P2
        log(f"model parity: {HYMBA} full width (d_model={cfg.d_model}, heads="
            f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.resolved_head_dim}, ssm state "
            f"{cfg.ssm_state}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}) {layers} fp32 "
            f"layer(s), token replay of prompts (16, 40) + 4 ticks through the paged "
            f"decode step ({ticks} ticks, K5 {k5}), kernel route vs plain route on the "
            f"card: worst logit err of max-abs {max(errs):.2e} (positions 8-31: "
            f"{max(errs[8:32]):.2e}, past them {max(errs[32:]):.2e}) "
            + (f"(tol {MODEL_TOL})" if layers == 1 else "(printed: P1, P2)")
            + f"; {time.perf_counter() - t0:.1f}s")
        if layers == 1:
            del params
    if not worst[1] <= MODEL_TOL:
        raise AssertionError(f"model parity {HYMBA}: 1-layer logit err {worst[1]:.3e} > "
                             f"{MODEL_TOL}")

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, remat="none", attention_impl="spectral_shift_fused")
    batch = to_device(SyntheticLM(cfg.vocab_size, 512, 1, seed=0).batch(0), dev)
    step = make_grad_step(cfg)
    before = launch_counts()
    loss, grads = step(params, batch)
    after = launch_counts()
    if any(after[k] <= before[k] for k in TRAIN_KERNELS):
        raise AssertionError(f"grad parity {HYMBA}: kernel route skipped a kernel: {after}")
    with plain_route():
        ploss, pgrads = step(params, batch)
    if launch_counts() != after:
        raise AssertionError(f"grad parity {HYMBA}: the plain route launched a kernel")
    loss_err = abs(float(loss) - float(ploss)) / abs(float(ploss))
    errs = grad_errs(torch, grads, pgrads)
    worst = max(errs, key=errs.get)
    before = launch_counts()
    rloss, rgrads = make_grad_step(dataclasses.replace(cfg, remat="ss_stats"))(params, batch)
    k1 = launch_counts()["landmark_summary"] - before["landmark_summary"]
    rerr = max(grad_errs(torch, rgrads, grads).values())
    lerr = abs(float(rloss) - float(loss)) / abs(float(loss))
    bitwise = float(rloss) == float(loss) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(rgrads), tree_leaves(grads)))
    log(f"grad parity: {HYMBA} full width 2 layers fp32 seq 512, kernel route vs plain "
        f"route on the card: loss {float(loss):.6f} vs {float(ploss):.6f} (rel "
        f"{loss_err:.2e}, tol {GRAD_TOL}), worst grad err of max-abs {errs[worst]:.2e} "
        f"({worst}, tol {GRAD_TOL}); remat ss_stats vs none: loss rel {lerr:.2e}, worst "
        f"grad err {rerr:.2e} (tol {REMAT_TOL}), bitwise {bitwise}, K1 launches {k1} "
        f"(want {cfg.num_layers}); {time.perf_counter() - t0:.1f}s")
    if not (loss_err <= GRAD_TOL and errs[worst] <= GRAD_TOL):
        raise AssertionError(f"grad parity {HYMBA}: loss err {loss_err:.3e} or grad err "
                             f"{errs[worst]:.3e} ({worst}) > {GRAD_TOL}")
    if not (lerr <= REMAT_TOL and rerr <= REMAT_TOL and k1 == cfg.num_layers):
        raise AssertionError(f"grad parity {HYMBA}: remat ss_stats differs from none by "
                             f"{max(lerr, rerr):.3e} (tol {REMAT_TOL}) or launched K1 {k1} "
                             f"times")
    del params, grads, pgrads, rgrads
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=2, compute_dtype="float32",
                              remat="none")
    params = random_params(cfg, seed=0, device=dev)
    batch = to_device(SyntheticLM(cfg.vocab_size, 512, 1, seed=0).batch(0), dev)
    before = launch_counts()
    out = {impl: make_grad_step(dataclasses.replace(cfg, attention_impl=impl))(params, batch)
           for impl in ("chunked", "full")}
    if launch_counts() != before:
        raise AssertionError(f"grad parity {DEEPSEEK}: a kernel launched")
    (loss, grads), (floss, fgrads) = out["chunked"], out["full"]
    loss_err = abs(float(loss) - float(floss)) / abs(float(floss))
    errs = grad_errs(torch, grads, fgrads)
    worst = max(errs, key=errs.get)
    log(f"grad parity: {DEEPSEEK} full width 2 layers fp32 seq 512 (MLA + MoE, capacity "
        f"{cfg.capacity_factor}), chunked vs full attention on the card: loss "
        f"{float(loss):.6f} vs {float(floss):.6f} (rel {loss_err:.2e}, tol {GRAD_TOL}), "
        f"worst grad err of max-abs {errs[worst]:.2e} ({worst}, tol {GRAD_TOL}); "
        f"{time.perf_counter() - t0:.1f}s")
    if not (loss_err <= GRAD_TOL and errs[worst] <= GRAD_TOL):
        raise AssertionError(f"grad parity {DEEPSEEK}: loss err {loss_err:.3e} or grad err "
                             f"{errs[worst]:.3e} ({worst}) > {GRAD_TOL}")
    del params, out, grads, fgrads
    gc.collect()
    torch.cuda.empty_cache()


def serve_replay_phase(torch, dev, arch: str, label: str, lens, frozen_twin: bool = True,
                       layers: int = 0) -> dict:
    """``label``: full-width ``arch`` (all its layers, or ``layers``), bf16
    random weights (seed 0), 4 lanes, max_seq 512, block 16, ``ss_fused`` +
    ``paged``, prompts of ``lens`` tokens, 16 new tokens each. The family
    prefills by token replay whatever the route, as in the reference: K1
    and K2 never launch; K5 once a layer a tick for all lanes when the
    model has paged attention leaves (``paged+replay-prefill``), never when
    it has none (xLSTM: ``dense+replay-prefill``, no ``"kv"``). With
    ``frozen_twin``, ``{label}_frozen``: the same under frozen streaming (K5
    never; boundary rebases). Returns each path's launch counts."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config

    cfg, params = serve_params(torch, dev, arch, layers or get_config(arch).num_layers,
                               label)
    serve = ServeConfig(max_lanes=4, max_seq=512, block_size=16, prefill_impl="ss_fused",
                        decode_impl="paged", seed=0)
    runs = {}
    twins = [(label, cfg)]
    if frozen_twin:
        twins.append((f"{label}_frozen", dataclasses.replace(cfg, decode_streaming="frozen")))
    for name, c in twins:
        out = serve_run(torch, dev, arch, cfg.num_layers, serve, name, params=(c, params),
                        lens=lens, warm_len=16)
        ticks, ran = out["decode_ticks"], out["launches"]
        attn = c.family != "ssm"
        frozen = c.decode_streaming == "frozen"
        want_k5 = ticks * cfg.num_layers if attn and not frozen else 0
        mode = f"{'paged' if attn else 'dense'}+replay-prefill"
        if (out["mode"] != mode or ran["paged_row_stats"] != want_k5
                or any(v for k, v in ran.items() if k != "paged_row_stats")
                or (frozen and not out["rebases"]) or (not attn and "kv" in out["stats"])):
            raise AssertionError(f"{name}: route {out['mode']}, {ticks} ticks, launches "
                                 f"{ran}, rebases {out['rebases']}: want {mode}, K5 "
                                 f"{want_k5} ({cfg.num_layers} a tick unless frozen or "
                                 f"attention-free), no other kernel")
        log(f"serve {name}: {ticks} ticks, K5 {ran['paged_row_stats']} "
            f"({ran['paged_row_stats'] / max(ticks, 1):.0f} a tick)"
            + (f", {out['rebases']} rebases, {1e3 * out['rebase_s'] / out['rebases']:.2f} "
               f"ms each" if frozen else ""))
        runs[name] = ran
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def serve_hymba_phase(torch, dev) -> dict:
    """``serve_hymba`` and ``serve_hymba_frozen`` at HYMBA_LAYERS, prompts
    of HYMBA_LENS tokens (``serve_replay_phase``)."""
    return serve_replay_phase(torch, dev, HYMBA, "serve_hymba", HYMBA_LENS,
                              layers=HYMBA_LAYERS)


def train_hymba_phase(torch, dev) -> dict:
    """``train_hymba``: Hymba-1.5B at full width cut to HYMBA_LAYERS, train_4k's
    seq 4096 at batch HYMBA_TRAIN_BATCH, remat "full", 3 steps under
    ``spectral_shift_fused`` (K1-K4 at 50 batch-heads of d = 64: K1 2 / K2
    2 / K3 1 / K4 1 a layer and step) and 3 under the config's own
    ``chunked`` (no kernel); the step-0 losses within PAPER_BERT_TOL
    (relative, a sanity bound) of each other. Returns each run's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config

    shape = ShapeConfig("train_4k", 4096, HYMBA_TRAIN_BATCH, "train")
    runs = {}
    for impl in ("spectral_shift_fused", "chunked"):
        cfg = dataclasses.replace(get_config(HYMBA), attention_impl=impl, remat="full",
                                  num_layers=HYMBA_LAYERS)
        label = "train_hymba" if impl == "spectral_shift_fused" else f"train_hymba_{impl}"
        runs[label] = train_steps(torch, dev, cfg, shape, 3, label)
        n = 3 * cfg.num_layers
        want = (dict(landmark_summary=2 * n, query_side=2 * n, paged_row_stats=0,
                     landmark_summary_bwd=n, query_side_bwd=n)
                if impl == "spectral_shift_fused" else dict.fromkeys(TRAIN_KERNELS + (
                    "paged_row_stats",), 0))
        if runs[label]["launches"] != want:
            raise AssertionError(f"{label}: launches {runs[label]['launches']} != {want}")
    fused, chunked = runs["train_hymba"]["losses"], runs["train_hymba_chunked"]["losses"]
    rel = rel_diffs(fused, chunked)
    log(f"train_hymba: spectral_shift_fused {runs['train_hymba']['ms']:.1f} ms per step, "
        f"peak {runs['train_hymba']['peak']:.2f} GiB; chunked "
        f"{runs['train_hymba_chunked']['ms']:.1f} ms per step, peak "
        f"{runs['train_hymba_chunked']['peak']:.2f} GiB; fused losses vs chunked rel diff "
        f"{['%.2e' % x for x in rel]} (step 0 tol {PAPER_BERT_TOL})")
    if not rel[0] <= PAPER_BERT_TOL:
        raise AssertionError(f"train_hymba: step-0 loss {fused[0]} differs from chunked's "
                             f"{chunked[0]} by {rel[0]:.3e} > {PAPER_BERT_TOL}")
    return {k: v["launches"] for k, v in runs.items()}


def train_deepseek_phase(torch, dev) -> dict:
    """``train_deepseek``: DeepSeek-V2-Lite at full width cut to
    DEEPSEEK_TRAIN_LAYERS layers, train_4k's seq 4096 at batch
    DEEPSEEK_TRAIN_BATCH, remat "full", 3 steps under its config's own
    ``chunked`` and 3 under ``spectral_shift`` (MLA runs the plain
    spectral-shift attention under every approximate impl, as the
    reference: no kernel may launch); the step-0 losses within
    PAPER_BERT_TOL of each other. Returns each run's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config

    shape = ShapeConfig("train_4k", 4096, DEEPSEEK_TRAIN_BATCH, "train")
    runs = {}
    for impl in ("chunked", "spectral_shift"):
        cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=DEEPSEEK_TRAIN_LAYERS,
                                  attention_impl=impl, remat="full")
        label = "train_deepseek" if impl == "chunked" else f"train_deepseek_{impl}"
        runs[label] = train_steps(torch, dev, cfg, shape, 3, label)
        if any(runs[label]["launches"].values()):
            raise AssertionError(f"{label}: a kernel launched: {runs[label]['launches']}")
    rel = rel_diffs(runs["train_deepseek_spectral_shift"]["losses"],
                    runs["train_deepseek"]["losses"])
    log(f"train_deepseek: chunked {runs['train_deepseek']['ms']:.1f} ms per step, peak "
        f"{runs['train_deepseek']['peak']:.2f} GiB; spectral_shift "
        f"{runs['train_deepseek_spectral_shift']['ms']:.1f} ms per step, peak "
        f"{runs['train_deepseek_spectral_shift']['peak']:.2f} GiB; losses vs chunked rel "
        f"diff {['%.2e' % x for x in rel]} (step 0 tol {PAPER_BERT_TOL})")
    if not rel[0] <= PAPER_BERT_TOL:
        raise AssertionError(f"train_deepseek: step-0 losses differ by {rel[0]:.3e} > "
                             f"{PAPER_BERT_TOL}")
    return {k: v["launches"] for k, v in runs.items()}


WHISPER = "whisper-base"
LLAVA = "llava-next-34b"
XLSTM = "xlstm-350m"
WHISPER_LENS = [16, 40, 64, 100]   # token replay costs a tick per prompt token
XLSTM_LENS = [16, 40, 64, 100]
# train_4k's global batch of 256 cut to 4: at 8 the decoder's saved fp32
# score blocks (no remat, as the reference's unrolled stack) and the
# logits' log-sum-exp pass 80 GB
WHISPER_TRAIN_BATCH = 4
LLAVA_SERVE_LAYERS = 16            # of 60: 9.9 B parameters, 19.8 GB of bf16 weights
LLAVA_TRAIN_LAYERS = 2             # of 60: 2.09 B parameters at 16 B each
LLAVA_TRAIN_BATCH = 1
XLSTM_TRAIN_BATCH = 2
XLSTM_TRAIN_LAYERS = 6   # of 24: one sLSTM block (every sixth) and five mLSTM
XLSTM_TOL = 2e-2   # replayed decode vs the forward (``tests/test_decode.py:59``)


def whisper_k5_entries(torch, dev) -> dict:
    """K5 at Whisper-base's decode shape (8 kv heads, r = 1, d = 64; kv_valid
    0 / 17 / 60 / 116) and at the 4096-key horizon of its learned decoder
    positions (``dec_pos``; 256 slots)."""
    return k5_model_entries(torch, dev, WHISPER, "whisper", hkv=8, r=1, d=64, cases=(
        ("", [0, 17, 60, 116], 32), ("_long", [512, 1024, 2048, 4096], 256)), seed=12)


def llava_k5_entries(torch, dev) -> dict:
    """K5 at LLaVA-NeXT-34B's decode shape (8 kv heads, r = 7, d = 128;
    kv_valid 48 / 200 / 333 / 480, the main path's prompts)."""
    return k5_model_entries(torch, dev, LLAVA, "llava", hkv=8, r=7, d=128, cases=(
        ("", [48, 200, 333, 480], 32),), seed=13)


def llava_ss_entries(torch, dev) -> dict:
    """K1 and K2 at LLaVA-NeXT-34B's prefill shape (56 query heads of 128,
    the 8 kv heads broadcast: b = 56, n = 352, kv_valid 333, c = 64), fp32
    and bf16, held against their plain versions: K1 as
    ``ss_attention_fused`` launches it (bf16, no stats) and as the seed of
    the streaming stats (fp32 landmark means over bf16 keys, with stats),
    K2 in bf16. Returns the timed entries."""
    from repro_torch.kernels.ss_attention import (landmark_summary,
                                                  landmark_summary_plain, query_side,
                                                  query_side_plain)

    gen = torch.Generator(device=dev).manual_seed(14)
    b, c, d, n, kvv = 56, 64, 128, 352, 333
    scale = d**-0.5

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    entries = {}
    for q_dt, kv_dt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.bfloat16)):
        q_l = randn(b, c, d, s=0.5, dtype=q_dt)
        k, v = randn(b, n, d, s=0.5, dtype=kv_dt), randn(b, n, d, dtype=kv_dt)
        out, m, l = landmark_summary(q_l, k, v, scale=scale, kv_valid=kvv, return_stats=True)
        ref, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, kv_end=kvv,
                                             return_stats=True)
        err = check(f"K1 landmark_summary {LLAVA} prefill b={b} c={c} n={n} "
                    f"kv_valid={kvv} q={q_dt} kv={kv_dt}",
                    [("out", out, ref, None), ("m", m, rm, None), ("l", l, rl, None)])
        if kv_dt != torch.bfloat16:
            continue
        stats = q_dt == torch.float32
        mask = torch.arange(n, device=dev)[None, :] < kvv
        entries["llava_landmark_summary_stats" if stats else "llava_landmark_summary"] = dict(
            fn=partial(landmark_summary, q_l, k, v, scale=scale, kv_valid=kvv,
                       return_stats=stats),
            plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, kv_end=kvv,
                          return_stats=stats),
            library=None if stats else partial(
                torch.nn.functional.scaled_dot_product_attention, q_l[None], k[None],
                v[None], attn_mask=mask.expand(c, n), scale=scale),
            err=err, bound=k1_bound(b, c, kvv, d, d, b * c * kvv,
                                    q_bytes=q_l.element_size(), stats=stats),
            shape=(f"{LLAVA} prefill: b={b} c={c} n={n} kv_valid={kvv} d=dv={d} "
                   + ("fp32 q, bf16 k/v, with stats (seed)" if stats
                      else "bf16, no stats (ss_attention_fused)")))
    for dt in (torch.float32, torch.bfloat16):
        q, k_l = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
        m_mat, v = randn(b, c, d, dtype=dt), randn(b, n, d, dtype=dt)
        delta = randn(b, 1, 1, s=0.1).abs()
        err = check(f"K2 query_side {LLAVA} prefill b={b} n={n} c={c} "
                    f"{str(dt).split('.')[-1]}",
                    [("out", query_side(q, k_l, m_mat, v, delta, scale=scale),
                      query_side_plain(q, k_l, m_mat, v, delta, scale=scale), None)])
    entries["llava_query_side"] = dict(
        fn=partial(query_side, q, k_l, m_mat, v, delta, scale=scale),
        plain=partial(query_side_plain, q, k_l, m_mat, v, delta, scale=scale),
        library=partial(sdpa_query_side, q, k_l, m_mat, v, delta, scale=scale),
        err=err, bound=k2_bound(b, n, c, d, d, b * n * c),
        shape=f"{LLAVA} prefill: b={b} n={n} c={c} d=dv={d} bf16")
    return entries


def bidir_train_kernel_entries(torch, dev, b: int = WHISPER_TRAIN_BATCH * 8,
                               n: int = 1500, c: int = 32, d: int = 64) -> dict:
    """Held and timed entries of Whisper-base's encoder training launches,
    bidirectional (the paper's own setting): batch 4 x 8 heads, n = 1500
    frames (a multiple of neither c nor the kernels' tiles: segments of
    47, the last one padded), c = 32, d = 64. K1 with stats and K2 forward,
    K3 and K4 backward, each against its plain version in fp32 (TF32 off)
    and bf16; timing entries are the bf16 launches."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.ss_attention import (landmark_summary,
                                                  landmark_summary_plain, query_side,
                                                  query_side_plain)
    from repro_torch.kernels.ss_attention_bwd import (landmark_summary_bwd,
                                                      landmark_summary_bwd_plain,
                                                      query_side_bwd,
                                                      query_side_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(15)
    scale = d**-0.5

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    full = torch.ones((c, n), dtype=torch.bool, device=dev)
    pairs = b * cost.b_side_pairs(c, n)   # every (row, key) pair is attended
    at = f"b={b} c={c} n={n} d=dv={d}"
    entries = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        es = 2 if dt == torch.bfloat16 else 4
        q_l, k, v = randn(b, c, d, s=0.5, dtype=dt), randn(b, n, d, s=0.5, dtype=dt), randn(b, n, d, dtype=dt)
        bv, m, l = landmark_summary(q_l, k, v, scale=scale, return_stats=True)
        rbv, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, return_stats=True)
        err1 = check(f"K1 landmark_summary {WHISPER} encoder train {at} bidirectional stats "
                     f"{dname}", [("out", bv, rbv, None), ("m", m, rm, None),
                                  ("l", l, rl, None)])
        g = randn(b, c, d, dtype=dt)
        dcoef = torch.sum(g.float() * bv.float(), dim=-1, keepdim=True)
        out = landmark_summary_bwd(q_l, k, v, bv, m, l, g, scale=scale)
        ref = landmark_summary_bwd_plain(q_l, k, v, g, m, l, dcoef, scale=scale)
        err3 = check(f"K3 landmark_summary_bwd {WHISPER} encoder {at} bidirectional {dname}",
                     [(nm, o, r, None) for nm, o, r in zip(("dq_l", "dk", "dv"), out, ref)])
        q, k_l = randn(b, n, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
        m_mat, v2 = randn(b, c, d, dtype=dt), randn(b, n, d, dtype=dt)
        delta = randn(b, 1, 1, s=0.1).abs()
        err2 = check(f"K2 query_side {WHISPER} encoder train {at} bidirectional {dname}",
                     [("out", query_side(q, k_l, m_mat, v2, delta, scale=scale),
                       query_side_plain(q, k_l, m_mat, v2, delta, scale=scale), None)])
        g2 = randn(b, n, d, dtype=dt)
        names = ("dq", "dk_l", "dm", "dv", "ddelta")
        err4 = check(f"K4 query_side_bwd {WHISPER} encoder {at} bidirectional {dname}",
                     [(nm, o, r, None) for nm, o, r in zip(
                         names, query_side_bwd(q, k_l, m_mat, v2, delta, g2, scale=scale),
                         query_side_bwd_plain(q, k_l, m_mat, v2, delta, g2, scale=scale))])
    shape = f"{WHISPER} encoder training: {at} bf16, bidirectional"
    entries["whisper_landmark_summary_train"] = dict(
        fn=partial(landmark_summary, q_l, k, v, scale=scale, return_stats=True),
        plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, return_stats=True),
        library=library_with_stats(q_l, k, v, full, scale=scale), err=err1,
        bound=k1_bound(b, c, n, d, d, pairs, q_bytes=es, kv_bytes=es, out_bytes=es,
                       stats=True),
        shape=f"{shape}, with stats")
    entries["whisper_landmark_summary_bwd"] = dict(
        fn=partial(landmark_summary_bwd, q_l, k, v, bv, m, l, g, scale=scale),
        plain=partial(landmark_summary_bwd_plain, q_l, k, v, g, m, l, dcoef, scale=scale),
        library=sdpa_backward(partial(sdpa_4d, scale=scale), (q_l, k, v), g), err=err3,
        bound=k3_bound(b, c, n, d, d, pairs, es),
        shape=shape)
    entries["whisper_query_side_train"] = dict(
        fn=partial(query_side, q, k_l, m_mat, v2, delta, scale=scale),
        plain=partial(query_side_plain, q, k_l, m_mat, v2, delta, scale=scale),
        library=partial(sdpa_query_side, q, k_l, m_mat, v2, delta, scale=scale), err=err2,
        bound=k2_bound(b, n, c, d, d, pairs, es),
        shape=shape)
    entries["whisper_query_side_bwd"] = dict(
        fn=partial(query_side_bwd, q, k_l, m_mat, v2, delta, g2, scale=scale),
        plain=partial(query_side_bwd_plain, q, k_l, m_mat, v2, delta, g2, scale=scale),
        library=sdpa_backward(partial(sdpa_query_side, scale=scale),
                              (q, k_l, m_mat, v2, delta), g2), err=err4,
        bound=k4_bound(b, n, c, d, d, pairs, es),
        shape=shape)
    return entries


# Context parallelism: each case is a sequence split over shards,
# K1 / K3 at each shard's kv_offset and K2 / K4 at its q_offset.
SHARD_CASES = {
    # name: (b, c, n global, shards, d, causal)
    "qwen2_sp2": (56, 64, 8192, 2, 128, True),
    "qwen2_sp4": (56, 64, 8192, 4, 128, True),
    "qwen2_sp4_ragged": (56, 64, 8000, 4, 128, True),
    "whisper_sp2": (WHISPER_TRAIN_BATCH * 8, 32, 1500, 2, 64, False),
    # sp_train's launches: paper-bert, 2 rows a rank x 8 heads of 64, the
    # 8192-token sequence over the 2 ranks of "model"
    "bert_sp2": (16, 64, 8192, 2, 64, True),
    # past 64 landmarks: K2 / K4 in column tiles, K3 with per-row-tile partials
    "qwen2_sp2_c128": (56, 128, 8192, 2, 128, True),
    # sp_hymba_fused's launches: Hymba-1.5B, one row a rank x 25 query heads
    # (5 kv heads broadcast) of 64, the 4096-token sequence over the 2
    # ranks of "model"
    "hymba_sp2": (25, 64, 4096, 2, 64, True),
    # sp_llava's launches: LLaVA-NeXT-34B, one row x 56 query heads (8 kv
    # heads broadcast) of 128, the 8192-position joint sequence over 4
    # ranks (Qwen2-7B's qwen2_sp4 shape, timed here at LLaVA's path)
    "llava_sp4": (56, 64, 8192, 4, 128, True),
}
# the timed shards: the last of each split (its low landmark rows reach no
# key of it), bf16
SHARD_TIMED = {"qwen2_sp2": "seq_shard_launch", "qwen2_sp4_ragged": "seq_shard_ragged_launch",
               "whisper_sp2": "whisper_seq_shard_launch",
               "bert_sp2": "paper_bert_seq_shard_launch",
               "hymba_sp2": "hymba_seq_shard_launch", "llava_sp4": "llava_seq_shard_launch"}


def shard_kernel_entries(torch, dev) -> dict:
    """K1 and K3 with ``kv_offset`` and K2 and K4 at a shard's ``q_offset``,
    as the context-parallel attention (``kernels/sharded.py``) launches them
    on each rank, against their plain versions in fp32 (TF32 off) and bf16
    at KERNEL_TOL, for every shard of every SHARD_CASES split: Qwen2-7B's
    training shape (b 56, c 64, n 8192, d 128, causal) over 2 and 4 shards
    and n 8000 over 4 (ragged: 2000 keys a shard, not a whole number of
    64-key tiles, and segments of 125 keys that straddle the shards),
    Whisper's bidirectional encoder shape (b 32, c 32, n 1500, d 64) over
    2, and sp_train's paper-bert shape (b 16, c 64, n 8192, d 64, causal,
    segments of 128) over 2. K1's rows that reach no key of the shard must come back (out 0,
    m -1e30, l 0); K3's dK / dV of keys no row reaches, zero. Timing
    entries: the last shard of each SHARD_TIMED split in bf16."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.ss_attention import (b_side_mask, landmark_summary,
                                                  landmark_summary_plain, query_side,
                                                  query_side_plain)
    from repro_torch.kernels.ss_attention_bwd import (landmark_summary_bwd,
                                                      landmark_summary_bwd_plain,
                                                      query_side_bwd,
                                                      query_side_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(24)

    def randn(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    entries = {}
    names = ("dq", "dk_l", "dm", "dv", "ddelta")
    for case, (b, c, n, shards, d, causal) in SHARD_CASES.items():
        n_loc = -(-n // shards)
        seg = -(-n // c) if causal else 0
        scale = d**-0.5
        for i in range(shards):
            off = i * n_loc
            end = min(n, off + n_loc)
            at = (f"{case} shard {i}/{shards}: b={b} c={c} n={n} n_loc={n_loc} "
                  f"kv_offset={off} d={d} {'causal' if causal else 'bidirectional'}")
            bmask = b_side_mask(c, n_loc, seg=seg, kv_offset=off, kv_end=end, device=dev)
            empty = ~bmask.any(dim=1)
            for dt in (torch.float32, torch.bfloat16):
                dname = str(dt).split(".")[-1]
                es = 2 if dt == torch.bfloat16 else 4
                kw1 = dict(scale=scale, causal=causal, kv_valid=n, seq_len_k=n,
                           kv_offset=off)
                q_l = randn(b, c, d, s=0.5, dtype=dt)
                k, v = randn(b, n_loc, d, s=0.5, dtype=dt), randn(b, n_loc, d, dtype=dt)
                bv, m, l = landmark_summary(q_l, k, v, return_stats=True, **kw1)
                rbv, rm, rl = landmark_summary_plain(q_l, k, v, scale=scale, seg=seg,
                                                     kv_offset=off, kv_end=end,
                                                     return_stats=True)
                err1 = check(f"K1 kv_offset {at} {dname}",
                             [("out", bv, rbv, None), ("m", m, rm, None), ("l", l, rl, None)])
                if not (torch.all(bv[:, empty] == 0) and torch.all(m[:, empty] == -1e30)
                        and torch.all(l[:, empty] == 0)):
                    raise AssertionError(f"K1 {at} {dname}: rows with no key must get "
                                         f"out 0, m -1e30, l 0")
                # K3 against the stats K1 gave (the sharded attention hands it the merged
                # global ones: any consistent (bv, m, l) holds it)
                g = randn(b, c, d, dtype=dt)
                dcoef = torch.sum(g.float() * bv.float(), dim=-1, keepdim=True)
                out3 = landmark_summary_bwd(q_l, k, v, bv, m, l, g, **kw1)
                ref3 = landmark_summary_bwd_plain(q_l, k, v, g, m, l, dcoef, scale=scale,
                                                  seg=seg, kv_offset=off, kv_end=end)
                err3 = check(f"K3 kv_offset {at} {dname}",
                             [(nm, o, r, None) for nm, o, r in zip(("dq_l", "dk", "dv"),
                                                                   out3, ref3)])
                unreached = ~bmask.any(dim=0)
                if not (torch.all(out3[1][:, unreached] == 0)
                        and torch.all(out3[2][:, unreached] == 0)):
                    raise AssertionError(f"K3 {at} {dname}: keys no row reaches must get "
                                         f"zero dK / dV")
                kw2 = dict(scale=scale, causal=causal, seq_len_k=n, q_offset=off)
                q, k_l = randn(b, n_loc, d, s=0.5, dtype=dt), randn(b, c, d, s=0.5, dtype=dt)
                m_mat, v2 = randn(b, c, d, dtype=dt), randn(b, n_loc, d, dtype=dt)
                delta = randn(b, 1, 1, s=0.1).abs()
                err2 = check(f"K2 q_offset {at} {dname}",
                             [("out", query_side(q, k_l, m_mat, v2, delta, **kw2),
                               query_side_plain(q, k_l, m_mat, v2, delta, scale=scale,
                                                seg=seg, pos_offset=off), None)])
                g2 = randn(b, n_loc, d, dtype=dt)
                err4 = check(f"K4 q_offset {at} {dname}",
                             [(nm, o, r, None) for nm, o, r in zip(
                                 names, query_side_bwd(q, k_l, m_mat, v2, delta, g2, **kw2),
                                 query_side_bwd_plain(q, k_l, m_mat, v2, delta, g2,
                                                      scale=scale, seg=seg,
                                                      pos_offset=off))])
                if dt != torch.bfloat16 or case not in SHARD_TIMED or i != shards - 1:
                    continue
                # the work this shard's data needs: attended (row, key) pairs
                # of K1 / K3 and (query, column) pairs of K2 / K4
                pairs1 = b * cost.b_side_pairs(c, n_loc, seg=seg, kv_offset=off, kv_end=end)
                pairs2 = b * cost.f_side_pairs(n_loc, c, seg=seg, pos_offset=off)
                qpos = off + torch.arange(n_loc, device=dev)
                fmask = (torch.arange(c, device=dev)[None, :] <= (qpos // seg)[:, None]
                         if seg else torch.ones((n_loc, c), dtype=torch.bool, device=dev))
                shape = (f"{at.split(': ', 1)[1]}, bf16 (the last of {shards} shards, "
                         f"{int(empty.sum())} of {c} rows reach no key)")
                entries[f"{case}_landmark_summary"] = dict(
                    fn=partial(landmark_summary, q_l, k, v, return_stats=True, **kw1),
                    plain=partial(landmark_summary_plain, q_l, k, v, scale=scale, seg=seg,
                                  kv_offset=off, kv_end=end, return_stats=True),
                    library=library_with_stats(q_l, k, v, bmask, scale=scale), err=err1,
                    bound=k1_bound(b, c, n_loc, d, d, pairs1, q_bytes=es, kv_bytes=es,
                                   out_bytes=es, stats=True),
                    shape=f"{shape}, with stats")
                entries[f"{case}_landmark_summary_bwd"] = dict(
                    fn=partial(landmark_summary_bwd, q_l, k, v, bv, m, l, g, **kw1),
                    plain=partial(landmark_summary_bwd_plain, q_l, k, v, g, m, l, dcoef,
                                  scale=scale, seg=seg, kv_offset=off, kv_end=end),
                    library=sdpa_backward(partial(sdpa_4d, attn_mask=bmask, scale=scale),
                                          (q_l, k, v), g), err=err3,
                    bound=k3_bound(b, c, n_loc, d, d, pairs1, es),
                    shape=shape)
                entries[f"{case}_query_side"] = dict(
                    fn=partial(query_side, q, k_l, m_mat, v2, delta, **kw2),
                    plain=partial(query_side_plain, q, k_l, m_mat, v2, delta, scale=scale,
                                  seg=seg, pos_offset=off),
                    library=partial(sdpa_query_side, q, k_l, m_mat, v2, delta, scale=scale,
                                    attn_mask=fmask), err=err2,
                    bound=k2_bound(b, n_loc, c, d, d, pairs2, es),
                    shape=shape.replace(" rows reach no key", " landmark rows reach no key"))
                entries[f"{case}_query_side_bwd"] = dict(
                    fn=partial(query_side_bwd, q, k_l, m_mat, v2, delta, g2, **kw2),
                    plain=partial(query_side_bwd_plain, q, k_l, m_mat, v2, delta, g2,
                                  scale=scale, seg=seg, pos_offset=off),
                    library=sdpa_backward(partial(sdpa_query_side, scale=scale,
                                                  attn_mask=fmask),
                                          (q, k_l, m_mat, v2, delta), g2), err=err4,
                    bound=k4_bound(b, n_loc, c, d, d, pairs2, es),
                    shape=shape)
    return entries


def frontend_batch(cfg, seq: int, batch: int):
    """Whisper's and LLaVA's training batches: ``SyntheticLM`` tokens beside
    seeded stub frame embeddings (1500 frames of d_model) or patch features
    (min(2880, seq / 2) of 1024), ``batch_specs``' shapes."""
    from repro_torch.configs.registry import ENCODER_SEQ
    from repro_torch.data.pipeline import StubFrontendLM

    return StubFrontendLM(cfg.family, cfg.vocab_size, seq, batch, d_model=cfg.d_model,
                          num_patches=cfg.num_patches, enc_len=ENCODER_SEQ, seed=0)


def whisper_model_checks(torch, dev) -> None:
    """Whisper-base at full width, fp32, kernel route against the plain route
    on the card: token-replay serving logits (``drive_replay``, prompts of
    16 and 40 tokens, 4 greedy ticks past the longer; K5 once a decoder
    layer a tick at hkv 8, r 1, d 64, from kv_valid 0; cross K/V zero, as
    the engine serves them) at 1 decoder layer (MODEL_TOL) and 2 (printed);
    then one grad step (seq 512, 1500 frames, batch 1) with the encoder
    under ``spectral_shift_fused`` (K1-K4 bidirectional at n = 1500, c =
    32, d = 64), kernel route against plain route and against the plain
    ``spectral_shift``, loss and grads at GRAD_TOL with 1 encoder and 1
    decoder layer, printed with 2 + 2 (ROADMAP P1: the random-weight
    decoder's sharp cross attention amplifies rounding; in the CPU tests the
    two packages' 2 + 2-layer gradients each sit 1e-2 from float64)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params
    from repro_torch.train.train_step import make_grad_step

    worst = {}
    for layers in (1, 2):
        cfg = dataclasses.replace(get_config(WHISPER), num_layers=layers,
                                  encoder_layers=layers, compute_dtype="float32")
        t0 = time.perf_counter()
        params = random_params(cfg, seed=0, device=dev)
        before = launch_counts()
        card, fed, ticks = drive_replay(torch, params, cfg, dev, (16, 40))
        after = launch_counts()
        k5 = after["paged_row_stats"] - before["paged_row_stats"]
        if (k5 != ticks * layers
                or any(after[k] != before[k] for k in TRAIN_KERNELS)):
            raise AssertionError(f"model parity {WHISPER}: K5 launched {k5} times, want "
                                 f"{ticks * layers}; launches {after}")
        with plain_route():
            plain, _, _ = drive_replay(torch, params, cfg, dev, (16, 40), feed=fed)
        if launch_counts() != after:
            raise AssertionError(f"model parity {WHISPER}: the plain route launched a "
                                 f"kernel")
        errs = []
        for a, b in zip(card, plain):
            if not torch.isfinite(a).all():
                raise AssertionError(f"model parity {WHISPER}: non-finite logits")
            err, scale = max_err(a, b)
            errs.append(err / scale)
        worst[layers] = max(errs)
        log(f"model parity: {WHISPER} full width (d_model={cfg.d_model}, heads="
            f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.resolved_head_dim}, d_ff="
            f"{cfg.d_ff}, vocab={cfg.vocab_size}) {layers} fp32 decoder layer(s), token "
            f"replay of prompts (16, 40) + 4 ticks through the paged decode step "
            f"({ticks} ticks, K5 {k5}), kernel route vs plain route on the card: worst "
            f"logit err of max-abs {max(errs):.2e} (positions 8-31: "
            f"{max(errs[8:32]):.2e}, past them {max(errs[32:]):.2e}) "
            + (f"(tol {MODEL_TOL})" if layers == 1 else "(printed: P1, P2)")
            + f"; {time.perf_counter() - t0:.1f}s")
        del params
    if not worst[1] <= MODEL_TOL:
        raise AssertionError(f"model parity {WHISPER}: 1-layer logit err {worst[1]:.3e} > "
                             f"{MODEL_TOL}")

    for layers in (1, 2):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(WHISPER), num_layers=layers,
                                  encoder_layers=layers, compute_dtype="float32",
                                  remat="none", encoder_attention_impl="spectral_shift_fused")
        params = random_params(cfg, seed=0, device=dev)
        batch = to_device(frontend_batch(cfg, 512, 1).batch(0), dev)
        before = launch_counts()
        loss, grads = make_grad_step(cfg)(params, batch)
        after = launch_counts()
        ran = {k: after[k] - before[k] for k in TRAIN_KERNELS}
        if ran != dict.fromkeys(TRAIN_KERNELS, layers):
            raise AssertionError(f"grad parity {WHISPER}: launches {ran}, want "
                                 f"{layers} of each of K1-K4 (the encoder's only)")
        with plain_route():
            ploss, pgrads = make_grad_step(cfg)(params, batch)
        sloss, sgrads = make_grad_step(dataclasses.replace(
            cfg, encoder_attention_impl="spectral_shift"))(params, batch)
        if launch_counts() != after:
            raise AssertionError(f"grad parity {WHISPER}: the plain routes launched a "
                                 f"kernel")
        res = {}
        for name, (l2, g2) in (("plain route", (ploss, pgrads)),
                               ("spectral_shift", (sloss, sgrads))):
            lerr = abs(float(loss) - float(l2)) / abs(float(l2))
            errs = grad_errs(torch, grads, g2)
            w = max(errs, key=errs.get)
            res[name] = (lerr, errs[w], w)
        held = layers == 1
        log(f"grad parity: {WHISPER} full width {layers} encoder + {layers} decoder fp32 "
            f"layers, seq 512, 1500 frames, spectral_shift_fused encoder (K1-K4 "
            f"{ran['landmark_summary']} each) vs "
            + "; vs ".join(f"{k}: loss rel {v[0]:.2e}, worst grad err of max-abs "
                           f"{v[1]:.2e} ({v[2]})" for k, v in res.items())
            + (f" (tol {GRAD_TOL})" if held else " (printed: P1)")
            + f"; {time.perf_counter() - t0:.1f}s")
        if held and not all(v[0] <= GRAD_TOL and v[1] <= GRAD_TOL for v in res.values()):
            raise AssertionError(f"grad parity {WHISPER}: {res} past {GRAD_TOL}")
        del params, grads, pgrads, sgrads
        gc.collect()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def served_initial_state(torch):
    """While the block runs, ``model_forward``'s mLSTM and sLSTM cells start
    from the served state, every leaf zero (m = 0), instead of the
    forward's fresh state (m = -1e30): the state the engine's token replay
    starts from (``serve/kv_cache.py``), as in the reference."""
    from repro_torch.models import model as m

    mlstm, slstm = m.mlstm_chunked, m.slstm_scan

    def mlstm_zero(q, k, v, ilog, flog, state=None, chunk=64):
        b, h, _, dh = q.shape
        zeros = [torch.zeros(shape, dtype=torch.float32, device=q.device)
                 for shape in ((b, h, dh, dh), (b, h, dh), (b, h))]
        return mlstm(q, k, v, ilog, flog, state=state or tuple(zeros), chunk=chunk)

    def slstm_zero(xg, r_w, state=None):
        b, _, h, _, dh = xg.shape
        zero = torch.zeros((b, h, dh), dtype=torch.float32, device=xg.device)
        return slstm(xg, r_w, state=state or (zero,) * 4)

    m.mlstm_chunked, m.slstm_scan = mlstm_zero, slstm_zero
    try:
        yield
    finally:
        m.mlstm_chunked, m.slstm_scan = mlstm, slstm


def xlstm_model_checks(torch, dev) -> None:
    """xLSTM-350M at full width, all 24 blocks, fp32 (no kernel: attention-
    free): 16 tokens of 2 lanes replayed one a tick through the decode step
    from the zero state, as the engine serves them, against
    ``model_forward`` over the same tokens with its cells started from that
    same served state (``served_initial_state``), within the reference's
    own ``tests/test_decode.py`` bound (|a - b| <= 2e-2 + 2e-2 |b|). The
    plain forward starts at m = -1e30: against it the decode differs
    wherever an sLSTM block is (printed; the reference's own decode and
    forward differ as much: 1.06 of 0.91 at 24 reduced blocks)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import random_params
    from repro_torch.models.model import model_forward
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.paged import PagedKVCache

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(XLSTM), compute_dtype="float32")
    params = random_params(cfg, seed=0, device=dev)
    kv = PagedKVCache(cfg, ServeConfig(max_lanes=2, max_seq=64), dev)
    step = kv.make_fused_step(lambda c_, t_: decode_step(params, cfg, c_, t_, seq_max=64))
    tokens = torch.randint(1, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(5)).to(dev)
    before = launch_counts()
    outs = []
    for t in range(tokens.shape[1]):
        lg = step(torch.zeros((2, 1), dtype=torch.int32, device=dev), tokens[:, t:t + 1],
                  torch.full((2,), t, dtype=torch.int32, device=dev),
                  torch.ones(2, dtype=torch.bool, device=dev), 1)
        outs.append(lg[:, 0].float())
    dec = torch.stack(outs, dim=1)
    with torch.no_grad():
        fresh, _ = model_forward(params, cfg, {"tokens": tokens})
        with served_initial_state(torch):
            served, _ = model_forward(params, cfg, {"tokens": tokens})
    if launch_counts() != before:
        raise AssertionError(f"model parity {XLSTM}: a kernel launched")
    if not all(torch.isfinite(t).all() for t in (dec, fresh, served)):
        raise AssertionError(f"model parity {XLSTM}: non-finite logits")
    excess = float(((dec - served.float()).abs() - XLSTM_TOL * served.float().abs()).max())
    err, scale = max_err(dec, served)
    ferr, _ = max_err(dec, fresh)
    log(f"model parity: {XLSTM} full width (d_model={cfg.d_model}, {cfg.num_layers} blocks, "
        f"sLSTM every {cfg.slstm_every}, vocab={cfg.vocab_size}) fp32, 16 tokens replayed "
        f"through the decode step vs model_forward from the served state on the card: "
        f"max abs err {err:.3e} (logits max-abs {scale:.3e}), worst |a-b| - "
        f"{XLSTM_TOL}|b| = {excess:.3e} (tol {XLSTM_TOL}); vs the forward from its "
        f"fresh state (m = -1e30) {ferr:.3e} (printed); {time.perf_counter() - t0:.1f}s")
    del params, kv
    gc.collect()
    torch.cuda.empty_cache()
    if not excess <= XLSTM_TOL:
        raise AssertionError(f"model parity {XLSTM}: decode vs forward {excess:.3e} past "
                             f"the bound")


def serve_llava_phase(torch, dev) -> dict:
    """``serve_llava``: LLaVA-NeXT-34B at full width cut to
    LLAVA_SERVE_LAYERS layers, the main path's settings and prompts (text
    only, as the reference's engine serves the family): K1 twice and K2
    once a layer for each prompt longer than c (200, 333, 480), K5 once a
    layer a decode tick. Returns its launch counts."""
    from repro_torch.configs.base import ServeConfig

    serve = ServeConfig(max_lanes=4, max_seq=512, prefill_impl="ss_fused",
                        decode_impl="paged", seed=0)
    out = serve_run(torch, dev, LLAVA, LLAVA_SERVE_LAYERS, serve, "serve_llava")
    ran, ticks = out["launches"], out["decode_ticks"]
    long = sum(n > 64 for n in SERVE_LENS)
    want = dict(landmark_summary=2 * long * LLAVA_SERVE_LAYERS,
                query_side=long * LLAVA_SERVE_LAYERS,
                paged_row_stats=ticks * LLAVA_SERVE_LAYERS)
    if out["mode"] != "paged+batched-prefill" or any(ran[k] != v for k, v in want.items()):
        raise AssertionError(f"serve_llava: route {out['mode']}, launches {ran}, want "
                             f"{want}")
    return {"serve_llava": ran}


def train_whisper_phase(torch, dev) -> dict:
    """``train_whisper``: Whisper-base, all 6 + 6 layers at full width,
    train_4k's decoder seq 4096 beside 1500 stub frames, batch cut from 256
    to WHISPER_TRAIN_BATCH, 3 steps under each encoder impl: the config's
    own ``spectral_shift`` (no kernel) and ``spectral_shift_fused`` (K1-K4
    bidirectional at b = 32, n = 1500, c = 32, d = 64: one of each a
    layer and step, no remat, as the reference's unrolled stack); the
    decoder's self-attention stays ``chunked``, its cross attention the
    plain rectangular branch. Step-0 losses within PAPER_BERT_TOL of each
    other. Returns each run's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config

    shape = ShapeConfig("train_4k", 4096, WHISPER_TRAIN_BATCH, "train")
    runs = {}
    for impl in ("spectral_shift", "spectral_shift_fused"):
        cfg = dataclasses.replace(get_config(WHISPER), encoder_attention_impl=impl)
        label = "train_whisper" if impl == "spectral_shift_fused" else f"train_whisper_{impl}"
        runs[label] = train_steps(torch, dev, cfg, shape, 3, label,
                                  data=frontend_batch(cfg, shape.seq_len, shape.global_batch))
        n = 3 * cfg.encoder_layers if impl == "spectral_shift_fused" else 0
        want = dict(dict.fromkeys(TRAIN_KERNELS, n), paged_row_stats=0)
        if runs[label]["launches"] != want:
            raise AssertionError(f"{label}: launches {runs[label]['launches']} != {want}")
    rel = rel_diffs(runs["train_whisper"]["losses"],
                    runs["train_whisper_spectral_shift"]["losses"])
    log(f"train_whisper: spectral_shift_fused {runs['train_whisper']['ms']:.1f} ms per "
        f"step, peak {runs['train_whisper']['peak']:.2f} GiB; spectral_shift "
        f"{runs['train_whisper_spectral_shift']['ms']:.1f} ms per step, peak "
        f"{runs['train_whisper_spectral_shift']['peak']:.2f} GiB; losses rel diff "
        f"{['%.2e' % x for x in rel]} (step 0 tol {PAPER_BERT_TOL})")
    if not rel[0] <= PAPER_BERT_TOL:
        raise AssertionError(f"train_whisper: step-0 losses differ by {rel[0]:.3e} > "
                             f"{PAPER_BERT_TOL}")
    return {k: v["launches"] for k, v in runs.items()}


def train_llava_phase(torch, dev) -> dict:
    """``train_llava``: LLaVA-NeXT-34B at full width cut to
    LLAVA_TRAIN_LAYERS layers, train_4k's seq 4096 (2048 stub patches of
    1024 features ahead of 2048 tokens) at batch LLAVA_TRAIN_BATCH, remat
    "full", 3 steps under its own ``chunked`` (no kernel) and under
    ``spectral_shift_fused`` (K1-K4 causal at b = 56, n 4096, c 64, d 128:
    K1 2 / K2 2 / K3 1 / K4 1 a layer and step); step-0 losses within
    PAPER_BERT_TOL. Returns each run's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config

    shape = ShapeConfig("train_4k", 4096, LLAVA_TRAIN_BATCH, "train")
    runs = {}
    for impl in ("chunked", "spectral_shift_fused"):
        cfg = dataclasses.replace(get_config(LLAVA), num_layers=LLAVA_TRAIN_LAYERS,
                                  attention_impl=impl, remat="full")
        label = "train_llava" if impl == "spectral_shift_fused" else f"train_llava_{impl}"
        runs[label] = train_steps(torch, dev, cfg, shape, 3, label,
                                  data=frontend_batch(cfg, shape.seq_len, shape.global_batch))
        n = 3 * cfg.num_layers if impl == "spectral_shift_fused" else 0
        want = dict(landmark_summary=2 * n, query_side=2 * n, landmark_summary_bwd=n,
                    query_side_bwd=n, paged_row_stats=0)
        if runs[label]["launches"] != want:
            raise AssertionError(f"{label}: launches {runs[label]['launches']} != {want}")
    rel = rel_diffs(runs["train_llava"]["losses"], runs["train_llava_chunked"]["losses"])
    log(f"train_llava: spectral_shift_fused {runs['train_llava']['ms']:.1f} ms per step, "
        f"peak {runs['train_llava']['peak']:.2f} GiB; chunked "
        f"{runs['train_llava_chunked']['ms']:.1f} ms per step, peak "
        f"{runs['train_llava_chunked']['peak']:.2f} GiB; fused losses vs chunked rel diff "
        f"{['%.2e' % x for x in rel]} (step 0 tol {PAPER_BERT_TOL})")
    if not rel[0] <= PAPER_BERT_TOL:
        raise AssertionError(f"train_llava: step-0 losses differ by {rel[0]:.3e} > "
                             f"{PAPER_BERT_TOL}")
    return {k: v["launches"] for k, v in runs.items()}


def train_xlstm_phase(torch, dev) -> dict:
    """``train_xlstm``: xLSTM-350M at full width cut to XLSTM_TRAIN_LAYERS
    blocks (five mLSTM blocks and the sLSTM block that every sixth is),
    train_4k's seq 4096 at batch XLSTM_TRAIN_BATCH, 2 steps (no remat, as
    the reference's unrolled stack; the sLSTM block recurs one step a
    token, eager: host-bound). No kernel may launch. Returns its
    launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config

    shape = ShapeConfig("train_4k", 4096, XLSTM_TRAIN_BATCH, "train")
    cfg = dataclasses.replace(get_config(XLSTM), num_layers=XLSTM_TRAIN_LAYERS)
    run = train_steps(torch, dev, cfg, shape, 2, "train_xlstm")
    if any(run["launches"].values()):
        raise AssertionError(f"train_xlstm: a kernel launched: {run['launches']}")
    return {"train_xlstm": run["launches"]}


# --------------------------------------------------------------------------
# context parallelism: ranks on the one card
# --------------------------------------------------------------------------
SP_MESH = (2, 2)                 # ("data", "model"): 4 ranks on the one card
SP_ATTENTION = dict(b=56, c=64, n=8192, d=128)   # Qwen2-7B's training shape, 8k
SP_FWD_TOL, SP_GRAD_TOL = 2e-4, 5e-4   # fp32, TF32 off, relative to max-abs
SP_TRAIN_SEQ, SP_TRAIN_BATCH, SP_TRAIN_STEPS = 8192, 4, 2
SP_LOSS_TOL = 5e-3               # SP against single-process losses, relative
SP_STEP0_TOL = 1.5e-3            # step 0 (a forward of the same weights), relative
SP_TIMEOUT_S = 600.0             # every collective of the ranks' group
# the sequence over "model"; "embed": None keeps FSDP off "data", so
# sp_train's parameters stay whole on every rank
SP_OVERRIDES = {"seq": "model", "embed": None}


def _counted(totals: dict, fn):
    """Run ``fn`` with the kernels' launch counts set to 0 just before and
    add the launches it made to ``totals``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    for k, v in launch_counts().items():
        totals[k] = totals.get(k, 0) + v
    return out


def sp_attention_rank(mesh, b: int, c: int, n: int, d: int) -> dict:
    """One rank of ``sp_attention``: ``ss_attention_fused_sharded`` on its
    rows of Qwen2-7B's training shape at n = 8192 (causal), the sequence
    over "model" (2 shards; the two "data" rows are replicas) and over
    ("data", "model") (4 shards), forward and the gradients of
    sum(out * w), in fp32 and bf16, against the single-device fused route
    on the card over the whole sequence (this rank's rows); then remat
    "ss_stats"'s policy against none (bf16). Returns host values only:
    errors, ms, launches of the sharded runs (the reference's excluded),
    peak GiB and the seconds in collectives."""
    import torch
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    from repro_torch.core.attention import SSConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.sharded import shard_sequence, ss_attention_fused_sharded
    from repro_torch.models.model import _ss_stats_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = SSConfig(num_landmarks=c, causal=True, landmark_via_matmul=True)
    launches: dict = {}
    res = {"rank": mesh.rank, "cases": {}}
    torch.cuda.reset_peak_memory_stats(dev)
    coll0, t_all = mesh.collective_seconds, time.perf_counter()
    for axes in (("model",), ("data", "model")):
        shards, idx = mesh.axis_size(axes), mesh.index(axes)
        n_loc = n // shards
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            gen = torch.Generator(device=dev).manual_seed(24)
            q, k, v, w = ((torch.randn((b, n, d), generator=gen, device=dev) * s).to(dt)
                          for s in (0.5, 0.5, 1.0, 1.0))
            ql, kl, vl = (shard_sequence(x, mesh, axes).requires_grad_(True)
                          for x in (q, k, v))
            wl = shard_sequence(w, mesh, axes)

            def loss(a, b_, c_):
                out = ss_attention_fused_sharded(a, b_, c_, cfg, mesh=mesh, seq_axes=axes)
                return out, (out.float() * wl.float()).sum()

            def run():
                out, val = loss(ql, kl, vl)
                grads = torch.autograd.grad(val, (ql, kl, vl))
                torch.cuda.synchronize(dev)
                return out.detach(), grads

            out, grads = _counted(launches, run)
            t0 = time.perf_counter()
            _counted(launches, run)
            ms = 1e3 * (time.perf_counter() - t0)
            # the single-device fused route over the whole sequence
            qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
            ref = ops.ss_attention_fused(qg, kg, vg, cfg)
            rgrads = torch.autograd.grad((ref.float() * w.float()).sum(), (qg, kg, vg))
            rows = slice(idx * n_loc, (idx + 1) * n_loc)

            def rel(a, r):
                r = r[:, rows].float()
                return float((a.float() - r).abs().max() / r.abs().max())

            res["cases"][(shards, dname)] = dict(
                fwd=rel(out, ref.detach()), grads=[rel(g, r) for g, r in zip(grads, rgrads)],
                ms=ms)
            if dname == "bfloat16":
                def grads_of(context_fn):
                    def go():
                        if context_fn is None:
                            _, val = loss(ql, kl, vl)
                        else:
                            _, val = checkpoint(loss, ql, kl, vl, use_reentrant=False,
                                                context_fn=context_fn)
                        return torch.autograd.grad(val, (ql, kl, vl))
                    return go

                calls = mesh.collective_calls
                g_none = _counted(launches, grads_of(None))
                mid = mesh.collective_calls
                g_ss = _counted(launches, grads_of(
                    partial(create_selective_checkpoint_contexts, _ss_stats_policy)))
                res["cases"][(shards, "ss_stats")] = dict(
                    bitwise=all(torch.equal(a, b2) for a, b2 in zip(g_none, g_ss)),
                    collectives=(mid - calls, mesh.collective_calls - mid))
            del q, k, v, w, ql, kl, vl, wl, out, grads, qg, kg, vg, ref, rgrads
            torch.cuda.empty_cache()
    res["launches"] = launches
    res["collective_share"] = (mesh.collective_seconds - coll0) / (time.perf_counter() - t_all)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return res


def step0_ce(trainer, patch=None) -> float:
    """The global CE of step 0's batch at the trainer's initial weights, a
    forward only under its mesh (and layout). ``patch``: (module, name,
    value) set while it runs and restored after (a control)."""
    import torch

    from repro_torch.train.train_step import make_eval_step

    if patch is not None:
        module, name, value = patch
        saved = getattr(module, name)
        setattr(module, name, value)
    try:
        with trainer._rules(), torch.no_grad():
            _, metrics = make_eval_step(trainer.cfg)(trainer.params, trainer._batch(0))
    finally:
        if patch is not None:
            setattr(module, name, saved)
    return float(metrics["ce"])


def sp_step0_ce(trainer, mesh, drop: bool) -> float:
    """``step0_ce``; ``drop``: the control, the flash merge of the
    context-parallel B-side without the partial of the sequence's second
    shard (its keys lost to every landmark row)."""
    import torch

    import repro_torch.kernels.sharded as sharded

    rescale = sharded.flash_rescale

    def dropped(m, l, acc, m_g):
        l_r, acc_r = rescale(m, l, acc, m_g)
        if mesh.index("model") == 1:
            return torch.zeros_like(l_r), torch.zeros_like(acc_r)
        return l_r, acc_r

    return step0_ce(trainer, (sharded, "flash_rescale", dropped) if drop else None)


def sp_paper_bert(overrides=None):
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config("paper-bert"), attention_impl="spectral_shift_fused",
                               **(overrides or {}))


def sp_train_rank(mesh, seq: int, batch: int, steps: int) -> dict:
    """One rank of ``sp_train``: the ``Trainer`` on paper-bert at full width
    and depth under ``spectral_shift_fused``, data over "data" and the
    sequence over "model" (``{"seq": "model"}``): step 0's forward at the
    initial weights, sound and with one shard's B-side partial dropped
    (``sp_step0_ce``, uncounted); losses, ms a step after the first, peak
    GiB, the share of the steps in collectives and the launches of the
    steps; then the 1-layer fp32 twin: one grad step under
    the mesh (gradients summed over the ranks) and, on rank 0, the
    single-device grad step on the whole batch, held leaf by leaf. The
    parameters stay whole on every rank (``SP_OVERRIDES``), as they were
    when the port applied no parameter rule, so its figures compare with
    earlier runs'."""
    import torch

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch, to_device
    from repro_torch.distributed.sharding import apply_seq_sharding_config, sharding_rules
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train.train_step import make_grad_step
    from repro_torch.train.trainer import Trainer

    dev = mesh.device
    ov = SP_OVERRIDES
    shape = ShapeConfig("train_4k", seq, batch, "train")
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_ckpt_") as tmp:
        tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0,
                           checkpoint_dir=tmp)
        trainer = Trainer(sp_paper_bert(), tcfg, shape, mesh, rule_overrides=ov)
        plan = trainer.plan
        step0 = {name: sp_step0_ce(trainer, mesh, drop)
                 for name, drop in (("sound", False), ("control", True))}
        torch.cuda.reset_peak_memory_stats(dev)
        coll0, t0 = mesh.collective_seconds, time.perf_counter()
        hist = _counted(launches, lambda: trainer.run(steps))
        share = (mesh.collective_seconds - coll0) / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # the 1-layer fp32 twin (TF32 off): one grad step, held leaf by leaf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg1 = apply_seq_sharding_config(sp_paper_bert(dict(
        num_layers=1, compute_dtype="float32", remat="none")), mesh, ov)
    params = init_params(model_specs(cfg1), torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    host = SyntheticLM(cfg1.vocab_size, seq, batch, seed=0).batch(0)
    with sharding_rules(mesh, ov):
        loss, grads = make_grad_step(cfg1)(params,
                                           to_device(make_global_batch(host, mesh, ov), dev))
    twin = None
    if mesh.rank == 0:
        ref_loss, ref = make_grad_step(cfg1)(params, to_device(host, dev))
        twin = dict(loss=abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
                    grad=max(float((a - r).abs().max() / r.abs().max().clamp(min=1e-30))
                             for a, r in zip(tree_leaves(grads), tree_leaves(ref))))
    return dict(rank=mesh.rank, losses=[h["loss"] for h in hist],
                ms=1e3 * sum(h["step_time_s"] for h in hist[1:]) / max(1, len(hist) - 1),
                peak_gib=peak, collective_share=share, launches=launches,
                plan=None if plan is None else (plan.impl, plan.block_n, plan.source),
                twin=twin, step0=step0)


# --------------------------------------------------------------------------
# tensor parallelism x FSDP: the same ranks
# --------------------------------------------------------------------------
TP_TRAIN_SEQ, TP_TRAIN_BATCH, TP_TRAIN_STEPS = 4096, PAPER_BERT_BATCH, 2
# a rank's attention batch-heads: 8 rows over 2 "data" ranks x 8 heads over
# 2 "model" ranks
TP_RANK_BATCH_HEADS = (TP_TRAIN_BATCH // 2) * (8 // 2)
# Step 0's discriminating check: a forward of the initial weights at
# TP_STEP0_LAYERS fp32 layers (TF32 off), TP x FSDP against one device. At
# 12 layers the forward is chaotic (P1): on the CPU at full width and seq
# 512, fp32 sits 2.3e-3 off float64, and TP moves the CE by 3.0e-3 there,
# against 8.8e-8 at 4 layers, where dropping layer 0's MLP all-reduce
# moves it by 3.2e-3 (float64: identical at 12 layers).
TP_STEP0_LAYERS = 4
TP_STEP0_TOL = 1e-4              # relative
# The steps train that 4-layer fp32 config (the 12-layer bf16 steps, whose
# loss bound separated no fault, went to pay for ep_train and pp_train).


def tp_step0_ce(trainer, drop: bool) -> float:
    """``step0_ce``; ``drop``: the control, layer 0's MLP row-parallel
    all-reduce dropped (each rank keeps its partial sum of ``w_down``'s
    product)."""
    import repro_torch.models.layers as layers

    constraint, calls = layers.logical_constraint, [0]

    def dropped(x, axes, partial=()):
        calls[0] += 1
        return x if calls[0] == 1 else constraint(x, axes, partial)

    return step0_ce(trainer, (layers, "logical_constraint", dropped) if drop else None)


def tp_step0_config():
    """paper-bert under the fused kernels cut to TP_STEP0_LAYERS fp32
    layers: step 0's discriminating forward."""
    return sp_paper_bert(dict(num_layers=TP_STEP0_LAYERS, compute_dtype="float32"))


def params_digest(trainer) -> str:
    """sha256 of the whole parameters' bytes (gathered: every rank calls
    it)."""
    import hashlib

    import torch

    from repro_torch.models.params import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(trainer.full_state()["params"]):
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def tp_train_rank(mesh, seq: int, batch: int, steps: int, ckpt: str) -> dict:
    """One rank of ``tp_train``: the ``Trainer`` on paper-bert at full width
    under ``spectral_shift_fused`` cut to ``tp_step0_config``'s 4 fp32
    layers (TF32 off) and the default rules: rows and FSDP over "data",
    query heads, MLP width and vocab over "model" (4 rows and 4 heads a
    rank: K1-K4 at b = 16). Step 0's forward at the initial weights,
    sound and with layer 0's MLP all-reduce dropped (``tp_step0_ce``,
    uncounted); losses, ms a step after the first, peak GiB, the share of
    the steps in collectives and the launches of the steps; a checkpoint
    of the last step into ``ckpt`` (rank 0 writes whole arrays), restored
    onto a 1 x 4 mesh (``make_local_mesh(4)``: the digest of its gathered
    parameters against the 2 x 2 run's); then the 1-layer fp32 twin: one
    grad step on the rank's slices under the layout, gradients gathered,
    and on rank 0 the single-device grad step on the whole batch, held
    leaf by leaf."""
    import torch

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch, to_device
    from repro_torch.distributed.sharding import param_layout, sharding_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import gather_tree, init_params, shard_tree, tree_leaves
    from repro_torch.train.train_step import make_grad_step
    from repro_torch.train.trainer import Trainer

    dev = mesh.device
    shape = ShapeConfig("train_4k", seq, batch, "train")
    launches: dict = {}
    tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0,
                       checkpoint_dir=ckpt)
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = Trainer(tp_step0_config(), tcfg, shape, mesh)
    step0 = {name: tp_step0_ce(trainer, drop)
             for name, drop in (("sound", False), ("control", True))}
    tp = trainer.layout.tp
    plan = trainer.plan
    torch.cuda.reset_peak_memory_stats(dev)
    coll0, t0 = mesh.collective_seconds, time.perf_counter()
    hist = _counted(launches, lambda: trainer.run(steps))
    share = (mesh.collective_seconds - coll0) / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    t_save = time.perf_counter()
    trainer.save(blocking=True)
    mesh.barrier()
    save_s = time.perf_counter() - t_save
    digest = params_digest(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    mesh14 = make_local_mesh(4, device=dev)
    onto = Trainer(tp_step0_config(), tcfg, shape, mesh14)
    restored = (onto.step, params_digest(onto) == digest, onto.layout.tp)
    del onto
    gc.collect()
    torch.cuda.empty_cache()
    # the 1-layer fp32 twin (TF32 off): one grad step, held leaf by leaf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg1 = sp_paper_bert(dict(num_layers=1, compute_dtype="float32", remat="none"))
    specs = model_specs(cfg1)
    layout = param_layout(mesh, cfg1, specs)
    params = init_params(specs, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    host = SyntheticLM(cfg1.vocab_size, seq, batch, seed=0).batch(0)
    with sharding_rules(mesh, None, layout):
        loss, grads = make_grad_step(cfg1)(shard_tree(params, layout.placements, mesh),
                                           to_device(make_global_batch(host, mesh), dev))
    grads = gather_tree(grads, layout.placements, mesh)
    twin = None
    if mesh.rank == 0:
        ref_loss, ref = make_grad_step(cfg1)(params, to_device(host, dev))
        twin = dict(loss=abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
                    grad=max(float((a - r).abs().max() / r.abs().max().clamp(min=1e-30))
                             for a, r in zip(tree_leaves(grads), tree_leaves(ref))))
    return dict(rank=mesh.rank, losses=[h["loss"] for h in hist], tp=tuple(tp),
                ms=1e3 * sum(h["step_time_s"] for h in hist[1:]) / max(1, len(hist) - 1),
                peak_gib=peak, collective_share=share, launches=launches,
                plan=None if plan is None else (plan.impl, plan.block_n, plan.source),
                twin=twin, step0=step0, digest=digest, restored=restored, save_s=save_s)


# --------------------------------------------------------------------------
# expert parallelism and the pipeline: the same ranks
# --------------------------------------------------------------------------
EP_MESH = (4, 1)                 # ("data", "model"): 16 of the 64 experts a rank
EP_LAYERS, EP_SEQ, EP_BATCH, EP_STEPS = 2, 2048, 4, 2
# Step 0's check: a forward of the initial weights at 1 fp32 layer (TF32
# off), capacity E / k so that no slot drops on either route, seq
# EP_CHECK_SEQ, EP over 4 ranks against the single-process "gspmd"
# Trainer. The CPU rehearsal at reduced width (1 layer, fp32, seq 64) puts
# EP 7.1e-8 off gspmd and the control (the return exchange with its source
# order reversed) 9.2e-4 off; at full width on the card the sound run is
# bitwise equal to one device's and the control moves the CE by 9.6e-6
# only (the MoE's share of a random 1-layer model's CE is small): the
# bound sits at 1e-6, 14x the rehearsal's sound gap.
EP_CHECK_SEQ = 512
EP_STEP0_TOL = 1e-6              # relative
PP_STAGES, PP_MICRO, PP_MB, PP_SEQ, PP_STEPS = 4, 8, 2, 4096, 3
# The pipeline's check: 4 fp32 layers, one a stage (TF32 off), against the
# port's sequential ``reference_forward`` one microbatch at a time (the
# same shapes): the forward and the loss bitwise; the trunk's gradients
# sum over the microbatches in another order, held at PP_GRAD_TOL of
# max-abs (CPU rehearsal at reduced width: 2.9e-7). The control, stage 1
# fed the previous tick's activation, must break the forward's identity.
PP_CHECK_LAYERS = 4
PP_GRAD_TOL = 1e-5


def ep_config(**overrides):
    """DeepSeek-V2-Lite at full width cut to EP_LAYERS layers, expert
    parallel."""
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(DEEPSEEK),
                               **dict(dict(num_layers=EP_LAYERS, moe_impl="ep"), **overrides))


def ep_check_config(moe_impl: str = "ep"):
    """``ep_config`` at 1 fp32 layer with capacity E / k (no slot drops)."""
    cfg = ep_config(num_layers=1, compute_dtype="float32", moe_impl=moe_impl)
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)


def ep_step0_ce(trainer, control: bool) -> float:
    """``step0_ce``; ``control``: the return exchange of every MoE layer
    with its source order reversed (each shard's results handed to another
    shard's tokens)."""
    import repro_torch.models.moe as moe

    exchange, calls = moe.ep_all_to_all, [0]

    def reversed_return(x, mesh_id, axes):
        calls[0] += 1
        out = exchange(x, mesh_id, axes)
        return out.flip(0) if calls[0] % 2 == 0 else out

    return step0_ce(trainer, (moe, "ep_all_to_all", reversed_return) if control else None)


def ep_train_rank(mesh, seq: int, batch: int, steps: int) -> dict:
    """One rank of ``ep_train`` on a 4 x 1 ("data", "model") mesh over the
    group's ranks: the ``Trainer`` on DeepSeek-V2-Lite at full width under
    ``moe_impl="ep"``: step 0's forward of ``ep_check_config`` (1 fp32
    layer, capacity E / k) sound and with the return exchange reversed
    (``ep_step0_ce``, uncounted); then EP_LAYERS bf16 layers at the
    config's own capacity 1.25: losses, ms a step after the first, the
    shares of the steps in the exchanges (all-to-all) and in the
    all-reduces (the gradients', the loss's, the aux means'), the share of
    routed slots dropped, peak GiB. The whole initial tree is built in
    host memory and only the rank's slices go to the card (the Trainer)."""
    import torch

    import repro_torch.models.moe as moe
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.train.trainer import Trainer

    dev = mesh.device
    emesh = Mesh(EP_MESH, ("data", "model"), device=dev, timeout_s=SP_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp:
        tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0,
                           checkpoint_dir=tmp)
        fp32 = Trainer(ep_check_config(), tcfg,
                       ShapeConfig("train_4k", EP_CHECK_SEQ, batch, "train"), emesh)
        experts = tuple(fp32.params["layers"]["moe"]["w_gate"].shape)
        step0 = {name: ep_step0_ce(fp32, control)
                 for name, control in (("sound", False), ("control", True))}
        del fp32
        gc.collect()
        torch.cuda.empty_cache()
        t_init = time.perf_counter()
        trainer = Trainer(ep_config(), tcfg, ShapeConfig("train_4k", seq, batch, "train"),
                          emesh)
        init_s = time.perf_counter() - t_init
        moe.reset_slot_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        ops0, t0 = emesh.seconds_by_op(), time.perf_counter()
        launches: dict = {}
        hist = _counted(launches, lambda: trainer.run(steps))
        wall = time.perf_counter() - t0
        ops = {k: v - ops0.get(k, 0.0) for k, v in emesh.seconds_by_op().items()}
        routed, kept = moe.slot_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=mesh.rank, step0=step0, experts=experts, init_s=init_s,
                losses=[h["loss"] for h in hist], aux=[h["aux"] for h in hist],
                ms=1e3 * sum(h["step_time_s"] for h in hist[1:]) / max(1, len(hist) - 1),
                exchange_share=ops.get("all_to_all", 0.0) / wall,
                all_reduce_share=ops.get("all_reduce", 0.0) / wall,
                dropped=1.0 - kept / max(routed, 1), peak_gib=peak, launches=launches)


def pp_parts(cfg, dev, stage: int):
    """paper-bert's initial weights (seed 0, the single device's draw) as
    the pipeline runs them: the top-level leaves whole and this stage's
    layers (``stack_stages`` leaves (1, L/S, ...)), fp32 masters that
    require grad."""
    import torch

    from repro_torch.distributed.pipeline import stack_stages
    from repro_torch.models.model import layer_params, model_specs
    from repro_torch.models.params import init_params, tree_map

    params = init_params(model_specs(cfg), torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    layers = [layer_params(params, i) for i in range(cfg.num_layers)]
    stage_params = tree_map(lambda t: t[stage:stage + 1].clone().requires_grad_(True),
                            stack_stages(layers, PP_STAGES))
    top = {k: v.requires_grad_(True) for k, v in params.items() if k != "layers"}
    return top, stage_params, layers


def pp_layer_fn(cfg):
    """One paper-bert layer as the pipeline runs it: ``layer_fn(lp, x)``
    on a layer's working copy, positions from x's shape."""
    import torch

    from repro_torch.models.model import dense_layer_forward

    def layer_fn(lp, x):
        pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[0], x.shape[1])
        return dense_layer_forward(lp, cfg, x, pos, cfg.attention_impl, "causal")[0]

    return layer_fn


def pp_head_ce(cfg, top, x, tokens):
    """The final norm, the head and the next-token CE of one microbatch
    (``top``: the working copy; a checkpoint, so that its logits live one
    microbatch at a time)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.layers import rms_norm
    from repro_torch.train.losses import next_token_loss

    def head(norm, w, h, t):
        return next_token_loss(rms_norm(h, norm, cfg.norm_eps) @ w, t)[0]

    return checkpoint(head, top["final_norm"], top["lm_head"], x, tokens, use_reentrant=False)


def pp_loss(cfg, top, stage_params, tokens, forward):
    """The CE of a batch of tokens (B, S) through the pipelined trunk: the
    embedding and the head on every rank, the batch as PP_MICRO
    microbatches. Returns (loss, the trunk's output (M, mb, S, D))."""
    from repro_torch.models.model import working_params

    top, stage_params = working_params(top, cfg), working_params(stage_params, cfg)
    x = top["embed"][tokens]
    b, s, d = x.shape
    out = forward(stage_params, x.reshape(PP_MICRO, b // PP_MICRO, s, d))
    toks = tokens.reshape(PP_MICRO, b // PP_MICRO, s)
    loss = sum(pp_head_ce(cfg, top, out[i], toks[i]) for i in range(PP_MICRO)) / PP_MICRO
    return loss, out


def pp_check(pmesh, seq: int) -> dict:
    """The pipeline at PP_CHECK_LAYERS fp32 layers (TF32 off) against the
    port's ``reference_forward`` one microbatch at a time on the same rank:
    max-abs gaps of the output and the loss (bitwise expected), the worst
    gradient leaf of this stage's layers relative to its max-abs, and the
    control's output gap (stage 1 fed the previous tick's activation)."""
    import torch

    import repro_torch.distributed.pipeline as pipeline
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.params import tree_leaves, tree_map

    dev, stage = pmesh.device, pmesh.coords["pipe"]
    cfg = sp_paper_bert(dict(num_layers=PP_CHECK_LAYERS, compute_dtype="float32"))
    top, stage_params, layers = pp_parts(cfg, dev, stage)
    tokens = torch.from_numpy(SyntheticLM(cfg.vocab_size, seq, PP_MICRO * PP_MB,
                                          seed=0).batch(0)["tokens"]).long().to(dev)
    layer_fn = pp_layer_fn(cfg)
    forward = pipeline.make_pipeline_forward(layer_fn, pmesh, "pipe")
    loss, out = pp_loss(cfg, top, stage_params, tokens, forward)
    loss.backward()
    mine = [t.grad[0] for t in tree_leaves(stage_params)]
    # the sequential reference, one microbatch at a time
    seq_layers = [tree_map(lambda t: t.detach().clone().requires_grad_(True), lp)
                  for lp in layers]
    x = top["embed"].detach()[tokens].reshape(PP_MICRO, PP_MB, seq, -1)
    toks = tokens.reshape(PP_MICRO, PP_MB, seq)
    gap, ces = 0.0, []
    for i in range(PP_MICRO):
        y = pipeline.reference_forward(layer_fn, seq_layers, x[i])
        gap = max(gap, float((y.detach() - out[i].detach()).abs().max()))
        ces.append(pp_head_ce(cfg, top, y, toks[i]))
        (ces[-1] / PP_MICRO).backward()
    ref_loss = sum(ce.detach() for ce in ces) / PP_MICRO
    per = PP_CHECK_LAYERS // PP_STAGES
    ref = [torch.stack([t.grad for t in leaves])
           for leaves in zip(*[tree_leaves(lp) for lp in
                               seq_layers[stage * per:(stage + 1) * per]])]
    grad = max(float((a - r).abs().max() / r.abs().max().clamp(min=1e-30))
               for a, r in zip(mine, ref))
    # the control: stage 1 gets, for microbatch i, microbatch i - 1's
    # activation (the previous tick's; zeros for the first)
    recv, prev = pipeline.pipe_recv, []

    def stale(token, like, mesh_id, axis, src):
        got = recv(token, like, mesh_id, axis, src)
        if stage != 1:
            return got
        prev.append(got)
        return prev[-2] if len(prev) > 1 else torch.zeros_like(got)

    pipeline.pipe_recv = stale
    try:
        with torch.no_grad():
            _, bad = pp_loss(cfg, top, stage_params, tokens, forward)
    finally:
        pipeline.pipe_recv = recv
    control = max(float((bad[i] - out[i].detach()).abs().max()) for i in range(PP_MICRO))
    return dict(out_gap=gap, loss_gap=abs(float(loss.detach()) - float(ref_loss)), grad=grad,
                control=control, scale=float(out.detach().abs().max()))


def pp_train_rank(mesh, seq: int, steps: int) -> dict:
    """One rank of ``pp_train`` on a ("pipe",) mesh of PP_STAGES over the
    group's ranks: ``pp_check``, then paper-bert at full width and depth
    (bf16, ``spectral_shift_fused``), PP_STAGES stages of 3 layers, the
    batch as PP_MICRO microbatches of PP_MB x ``seq``; ``steps`` forward +
    backward passes of the CE: losses, ms a step after the first, the
    shares of the steps in send, recv (the transfers and the waits for a
    peer: the bubble) and the broadcast, peak GiB, K1-K4 launches."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.pipeline import make_pipeline_forward

    dev = mesh.device
    pmesh = Mesh((PP_STAGES,), ("pipe",), device=dev, timeout_s=SP_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    check = pp_check(pmesh, seq)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = sp_paper_bert()
    top, stage_params, _ = pp_parts(cfg, dev, pmesh.coords["pipe"])
    forward = make_pipeline_forward(pp_layer_fn(cfg), pmesh, "pipe")
    data = SyntheticLM(cfg.vocab_size, seq, PP_MICRO * PP_MB, seed=0)
    launches: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    ops0 = pmesh.seconds_by_op()
    losses, times = [], []
    for step in range(steps):
        tokens = torch.from_numpy(data.batch(step)["tokens"]).long().to(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()

        def run():
            loss, _ = pp_loss(cfg, top, stage_params, tokens, forward)
            loss.backward()
            return float(loss.detach())

        losses.append(_counted(launches, run))
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    wall = sum(times)
    ops = {k: v - ops0.get(k, 0.0) for k, v in pmesh.seconds_by_op().items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del top, stage_params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=mesh.rank, check=check, losses=losses,
                ms=1e3 * sum(times[1:]) / max(1, len(times) - 1),
                shares={k: ops.get(k, 0.0) / wall for k in ("send", "recv", "broadcast")},
                peak_gib=peak, launches=launches)


# --------------------------------------------------------------------------
# fault tolerance and the dry-run: the same ranks
# --------------------------------------------------------------------------
# elastic_train: tp_train's config and shape (paper-bert at 4 fp32 layers,
# TP 2 x FSDP 2), hosts of one rank each; host0 fails before step
# ELASTIC_FAIL_AT, the survivors (world ranks 1, 2) go on over 1 x 2 from the
# checkpoint of that step.
ELASTIC_HOSTS, ELASTIC_EVERY, ELASTIC_FAIL_AT, ELASTIC_STEPS = 4, 2, 2, 4
ELASTIC_SURVIVORS = [1, 2]


def elastic_train_rank(mesh, seq: int, batch: int, root: str) -> dict:
    """One rank of ``elastic_train``: the ``Trainer`` on ``tp_step0_config``
    over a 2 x 2 mesh of its own (the restart destroys the mesh it leaves)
    with a ``HeartbeatMonitor`` of ELASTIC_HOSTS hosts and
    ``FailureInjector({ELASTIC_FAIL_AT: ["host0"]})``, a checkpoint every
    ELASTIC_EVERY steps and one of step 0, ELASTIC_STEPS steps: its losses,
    ms a step, peak GiB, the restart's seconds (``recoveries``) and the
    launches. Then, over the survivors' 1 x 2 sub-mesh, an uninterrupted
    run restored from the failure step's checkpoint (``resume``: its steps
    must equal the elastic run's bitwise) and the control, the step-0
    checkpoint's state restored at the failure step (``control``: a wrong
    step, whose loss must differ)."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed.fault_tolerance import FailureInjector, HeartbeatMonitor
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.train.trainer import Trainer

    dev = mesh.device
    shape = ShapeConfig("train_4k", seq, batch, "train")
    torch.backends.cuda.matmul.allow_tf32 = False

    def tcfg(name: str, every: int):
        return TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=every,
                           checkpoint_dir=os.path.join(root, name))

    own = Mesh(SP_MESH, ("data", "model"), device=dev, timeout_s=SP_TIMEOUT_S)
    monitor = HeartbeatMonitor([f"host{i}" for i in range(ELASTIC_HOSTS)], timeout_s=600)
    trainer = Trainer(tp_step0_config(), tcfg("elastic", ELASTIC_EVERY), shape, own,
                      monitor=monitor, injector=FailureInjector({ELASTIC_FAIL_AT: ["host0"]}))
    trainer.save(blocking=True)   # step 0: the control's state
    torch.cuda.reset_peak_memory_stats(dev)
    launches: dict = {}
    hist = _counted(launches, lambda: trainer.run(ELASTIC_STEPS))
    out = dict(rank=mesh.rank, losses={h["step"]: h["loss"] for h in hist},
               ms={h["step"]: 1e3 * h["step_time_s"] for h in hist}, active=trainer.active,
               mesh=dict(trainer.mesh.shape), hosts=list(monitor.hosts),
               recoveries=trainer.recoveries, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == ELASTIC_SURVIVORS[0]:   # the new mesh's rank 0 wrote the checkpoints
        for name, step in (("resume", ELASTIC_FAIL_AT), ("control", 0)):
            shutil.copytree(os.path.join(root, "elastic", f"step_{step:08d}"),
                            os.path.join(root, name, f"step_{ELASTIC_FAIL_AT:08d}"))
    dist.barrier()
    sub = Mesh((1, 2), ("data", "model"), ranks=ELASTIC_SURVIVORS, device=dev,
               timeout_s=SP_TIMEOUT_S)
    if sub.member:
        for name, steps in (("resume", ELASTIC_STEPS - ELASTIC_FAIL_AT), ("control", 1)):
            t = Trainer(tp_step0_config(), tcfg(name, 0), shape, sub)
            out[name] = {h["step"]: h["loss"] for h in t.run(steps)}
            del t
            gc.collect()
            torch.cuda.empty_cache()
    sub.close()
    return out


def dryrun_rank(mesh, seq: int, batch: int, root: str) -> dict:
    """One rank of ``dryrun``: ``tp_train``'s Trainer (``tp_step0_config``,
    TP 2 x FSDP 2 on the group's mesh) runs one step on the card under
    ``FlopCounterMode``, the mesh's collectives counted by op and group
    (``Mesh.traffic``): its FLOPs by op, collectives
    (``dryrun.collectives_since``), state bytes (the parameter slices and
    two fp32 moments) and launches, for the parent to hold against
    ``run_cell`` on a 2 x 2 ``AbstractMesh``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.kernels.cost import register_flop_formulas
    from repro_torch.launch.dryrun import collectives_since
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import Trainer

    register_flop_formulas()
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = Trainer(tp_step0_config(), TrainConfig(total_steps=10, warmup_steps=1,
                                                     checkpoint_every=0, checkpoint_dir=root),
                      ShapeConfig("train_4k", seq, batch, "train"), mesh)
    leaves = tree_leaves(trainer.params)
    state = sum(t.numel() * t.element_size() for t in leaves) + 2 * sum(
        t.numel() * 4 for t in leaves)
    before = mesh.traffic()
    launches: dict = {}
    with FlopCounterMode(display=False) as counter:
        hist = _counted(launches, lambda: trainer.run(1))
    collectives = collectives_since(mesh, before)
    counts = counter.get_flop_counts()["Global"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=mesh.rank, state=float(state), launches=launches,
                ms=1e3 * hist[0]["step_time_s"],
                flops_by_op={str(k): float(v) for k, v in counts.items()},
                collectives=collectives)


# --------------------------------------------------------------------------
# the recurrent families under a sequence shard, Whisper under a batch split
# --------------------------------------------------------------------------
SP_HYMBA_LAYERS = 2               # of 32
SP_HYMBA_SEQ, SP_HYMBA_BATCH = 4096, 2   # one row x 2048 positions a rank
SP_XLSTM_SEQ, SP_XLSTM_BATCH = 2048, 2   # 6 blocks: the sLSTM recurs a step a token
DP_WHISPER_SEQ, DP_WHISPER_BATCH = 4096, 4   # one row a rank, 1500 stub frames
DP_MESH = (4, 1)                  # ("data", "model"): Whisper's rows over the 4 ranks
# Whisper-base's decoder over "model" of the 2 x 2 group: 2048 tokens and
# 2 rows a rank (the encoder's kernels at b = 2 rows x 8 heads = 16); the
# single process's bf16 step at batch 8 ran out of the card's memory
SP_WHISPER_SEQ, SP_WHISPER_BATCH = 4096, 4
# sp_whisper's float64 witness: 2 + 2 layers. The sequence split sums the
# cross attention's landmarks in another order than one process does, and
# the random-weight decoder grows that float64 rounding 50-170x a layer:
# a position's CE moved 1.8e-13 / 3.0e-11 / 1.4e-9 / 2.7e-6 at 1 / 2 / 3 /
# 6 layers each side (an H100 80GB HBM3 at 700 W, PERF.md §6)
SP_WHISPER_STEP0_LAYERS = 2
FAMILY_STEPS = 2
# step 0: each position's CE on a rank against the single process's, max
# abs, in float64 (Hymba chunked, xLSTM, Whisper) or at 1 fp32 layer, TF32
# off (Hymba fused: K1-K4 take fp32 and bf16 only). On the card fp32 is
# not a witness at 2 layers: the single process alone moves a position's
# CE by up to 2.6e-3 (Hymba) / 4.0e-3 (xLSTM) between a batch of 2 and its
# first row alone, 1.1e-4-1.4e-4 at 1 Hymba layer, 3.4e-12 in float64 (an
# H100 80GB HBM3 at 700 W, PERF.md §6). A control (shard 1's entering mamba state and
# conv halo zeroed; shard 1's sLSTM state dropped; every row given the next
# row's frames; under Whisper's sequence shard, cross attention's Q~ from
# the rank's own rows, and apart from it ``dec_pos`` read from row 0 on
# every shard) must exceed the bound.
FAMILY_STEP0_TOL = {"float64": 1e-8, "float32": 1e-3}
# the bf16 steps against the single process's, relative: a sanity bound
# (Adam's first steps amplify bf16 rounding: Whisper's DP step 1 moved
# 5.5e-3 in the CPU rehearsal at reduced width, its step 0 7e-8)
FAMILY_LOSS_TOL = 2e-2
FAMILIES = ("hymba_chunked", "hymba_fused", "xlstm", "sp_whisper", "whisper")
# the families on the group's 2 x 2 mesh with the sequence over "model"
SP_FAMILIES = FAMILIES[:4]


def family_config(name: str, step0: bool = False):
    """The config of a family path: Hymba-1.5B at full width cut to
    SP_HYMBA_LAYERS under its own ``chunked`` attention or
    ``spectral_shift_fused``; xLSTM-350M at 6 blocks (one sLSTM); Whisper-base
    at 6 + 6 layers, its bf16 steps under a sequence shard with the encoder
    through K1-K4 (``spectral_shift_fused``). ``step0``: the step-0
    witness's, in float64 (the kernels take no float64: Whisper's encoder
    then runs its own plain ``spectral_shift``; under the sequence shard at
    SP_WHISPER_STEP0_LAYERS + SP_WHISPER_STEP0_LAYERS layers), or for the
    fused Hymba one fp32 layer."""
    from repro_torch.configs.registry import get_config

    over = {}
    if step0:
        over = (dict(compute_dtype="float32", num_layers=1) if name == "hymba_fused"
                else dict(compute_dtype="float64"))
        if name == "sp_whisper":
            over.update(num_layers=SP_WHISPER_STEP0_LAYERS,
                        encoder_layers=SP_WHISPER_STEP0_LAYERS)
    if name.startswith("hymba"):
        impl = "chunked" if name == "hymba_chunked" else "spectral_shift_fused"
        return dataclasses.replace(get_config(HYMBA), **{"num_layers": SP_HYMBA_LAYERS,
                                                         "attention_impl": impl, **over})
    if name == "xlstm":
        return dataclasses.replace(get_config(XLSTM), **{"num_layers": XLSTM_TRAIN_LAYERS,
                                                         **over})
    if name == "sp_whisper" and not step0:
        over = dict(encoder_attention_impl="spectral_shift_fused")
    return dataclasses.replace(get_config(WHISPER), **over)


def family_shape(name: str):
    from repro_torch.configs.base import ShapeConfig

    seq, batch = {"xlstm": (SP_XLSTM_SEQ, SP_XLSTM_BATCH),
                  "whisper": (DP_WHISPER_SEQ, DP_WHISPER_BATCH),
                  "sp_whisper": (SP_WHISPER_SEQ, SP_WHISPER_BATCH)}.get(
                      name, (SP_HYMBA_SEQ, SP_HYMBA_BATCH))
    return ShapeConfig("train_4k", seq, batch, "train")


def family_data(name: str):
    if not name.endswith("whisper"):
        return None
    shape = family_shape(name)
    return frontend_batch(family_config(name), shape.seq_len, shape.global_batch)


def token_ce(torch, trainer, patches=()):
    """Each position's CE (rows x positions, numpy) of step 0's batch at
    the trainer's initial weights, a forward under its mesh: the rank's
    rows and positions (their targets the next global tokens), or the whole
    batch on one device (the last position against token 0, as a rank's
    targets hold); a float64 model wholly in float64
    (``float64_everywhere``). ``patches``: (module, name, value) triples
    set while it runs."""
    import torch.nn.functional as F

    from repro_torch.models.model import model_forward

    saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
    for module, name, value in patches:
        setattr(module, name, value)
    f64 = trainer.cfg.compute_dtype == "float64"
    try:
        with (float64_everywhere(torch) if f64 else contextlib.nullcontext()), \
                trainer._rules(), torch.no_grad():
            batch = trainer._batch(0)
            logits, _ = model_forward(trainer.params, trainer.cfg, batch)
            targets = batch.get("targets")
            if targets is None:
                tok = batch["tokens"]
                targets = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], dim=1)
            ce = F.cross_entropy(logits.flatten(0, 1).to(torch.float64 if f64 else
                                                          torch.float32),
                                 targets.flatten(), reduction="none").view(targets.shape)
    finally:
        for module, name, value in saved:
            setattr(module, name, value)
    return ce.cpu().numpy()


def family_controls(name: str) -> dict:
    """The controls of a family path, each a list of (module, name, value)
    patches that break what the slice carries across ranks while every
    collective still runs."""
    if name != "sp_whisper":
        return {"control": family_control(name)}
    from repro_torch.core.landmarks import segment_means
    import repro_torch.kernels.sharded as sharded
    import repro_torch.models.model as model_module

    def local(x, m, mesh, axes):   # Q~ from the rank's own rows
        return segment_means(x, m, via_matmul=True)

    rows = model_module._dec_pos_rows

    def from_row0(pos, offset, s, n):   # every shard reads dec_pos from row 0
        return rows(pos, 0, s, n)

    return {"control": [(sharded, "global_segment_means", local)],
            "control_dec_pos": [(model_module, "_dec_pos_rows", from_row0)]}


def family_control(name: str) -> list:
    """The control of a family path: (module, name, value) patches that
    break what the slice carries across ranks while every collective still
    runs."""
    import numpy as np

    import repro_torch.distributed.seq_parallel as sp
    import repro_torch.train.trainer as trainer_module

    if name.startswith("hymba"):
        carry, halo = sp.affine_carry, sp.halo_exchange

        def zeroed(a, b, mesh, axes):   # shard 1's entering mamba state lost
            h = carry(a, b, mesh, axes)
            return h * 0 if mesh.index(axes) == 1 else h

        def zeroed_halo(x, mesh, axes, rows):   # ... and its conv context
            h = halo(x, mesh, axes, rows)
            return h * 0 if mesh.index(axes) == 1 else h

        return [(sp, "affine_carry", zeroed), (sp, "halo_exchange", zeroed_halo)]
    if name == "xlstm":
        chain = sp.state_chain

        def dropped(run, fresh, mesh, axes, anchor):   # shard 1's sLSTM starts afresh
            lost = len(fresh) == 4 and mesh.index(axes) == 1
            return chain(lambda st: run(fresh if lost else st), fresh, mesh, axes, anchor)

        return [(sp, "state_chain", dropped)]
    split = trainer_module.make_global_batch

    def shifted(host, mesh, overrides=None):   # every row gets the next row's frames
        return split(dict(host, frames=np.roll(host["frames"], 1, axis=0)), mesh, overrides)

    return [(trainer_module, "make_global_batch", shifted)]


def family_rank_run(mesh, name: str, steps: int) -> dict:
    """One rank of a family path: step 0's per-position CE (the witness
    config: float64, or 1 fp32 layer with TF32 off), sound and under the
    control (``token_ce``, uncounted), then
    ``steps`` bf16 steps: losses, ms a step after the first, peak GiB, the
    collectives' share of the steps and the launches."""
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer

    dev = mesh.device
    ov = None if name == "whisper" else {"seq": "model"}
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_family_") as tmp:
        tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0,
                           checkpoint_dir=tmp)
        witness = Trainer(family_config(name, step0=True), tcfg, family_shape(name), mesh,
                          rule_overrides=ov, data=family_data(name))
        ce = {"sound": token_ce(torch, witness),
              **{k: token_ce(torch, witness, v) for k, v in family_controls(name).items()}}
        del witness
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(family_config(name), tcfg, family_shape(name), mesh,
                          rule_overrides=ov, data=family_data(name))
        torch.cuda.reset_peak_memory_stats(dev)
        coll0, t0 = mesh.collective_seconds, time.perf_counter()
        launches: dict = {}
        hist = _counted(launches, lambda: trainer.run(steps))
        share = (mesh.collective_seconds - coll0) / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=mesh.rank, coords=dict(mesh.coords), ce=ce,
                losses=[h["loss"] for h in hist],
                ms=1e3 * sum(h["step_time_s"] for h in hist[1:]) / max(1, len(hist) - 1),
                peak_gib=peak, collective_share=share, launches=launches,
                phase_s=time.perf_counter() - t_phase)


def family_rank(mesh, steps: int) -> dict:
    """The family paths on one rank: Hymba, xLSTM and ``sp_whisper`` on the
    group's 2 x 2 mesh (the sequence over "model", Whisper's rows over
    "data"), ``dp_whisper`` on a 4 x 1 mesh of its own over the same ranks
    (its rows over "data")."""
    from repro_torch.distributed.mesh import Mesh

    out = {name: family_rank_run(mesh, name, steps) for name in SP_FAMILIES}
    wmesh = Mesh(DP_MESH, ("data", "model"), device=mesh.device, timeout_s=SP_TIMEOUT_S)
    out["whisper"] = family_rank_run(wmesh, "whisper", steps)
    return out


def family_single(torch, dev) -> dict:
    """The single process's side of every family path: step 0's
    per-position CE (the witness config) and ``FAMILY_STEPS`` bf16 steps
    (``train_steps``)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer

    out = {}
    for name in FAMILIES:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_family0_") as tmp:
            one = Trainer(family_config(name, step0=True), TrainConfig(checkpoint_dir=tmp),
                          family_shape(name), device=dev, data=family_data(name))
            ce = token_ce(torch, one)
            del one
        gc.collect()
        torch.cuda.empty_cache()
        run = train_steps(torch, dev, family_config(name), family_shape(name), FAMILY_STEPS,
                          f"{name} single-process reference", data=family_data(name))
        out[name] = dict(run, ce=ce)
    return out


def check_families(fams: list, single: dict) -> None:
    """Hold the family paths' ranks to the single process: step 0's
    per-position CE within FAMILY_STEP0_TOL of its witness's dtype, which
    each control must exceed; the ranks of a sequence agree on the losses, which stay within
    the sanity bound FAMILY_LOSS_TOL of the single process's; launches per rank
    K1 2 / K2 2 / K3 1 / K4 1 a layer and step under the fused Hymba (remat
    full), none elsewhere. Logs ms a step, peak GiB and the collectives'
    share per rank beside the single process."""
    import numpy as np

    for name in FAMILIES:
        runs = [f[name] for f in fams]
        ref = single[name]["ce"]
        sound, controls = 0.0, dict.fromkeys(family_controls(name), 0.0)
        for r in runs:
            if name == "whisper":   # rows over "data", whole sequence
                rows, cols = r["coords"]["data"], 0
            else:
                rows, cols = r["coords"]["data"], r["coords"]["model"]
            b, s = r["ce"]["sound"].shape
            want = ref[rows * b:(rows + 1) * b, cols * s:(cols + 1) * s]
            sound = max(sound, float(np.abs(r["ce"]["sound"] - want).max()))
            for k in controls:
                controls[k] = max(controls[k], float(np.abs(r["ce"][k] - want).max()))
        rel = rel_diffs(runs[0]["losses"], single[name]["losses"])
        layers = family_config(name).num_layers
        witness = family_config(name, step0=True)
        tol = FAMILY_STEP0_TOL[witness.compute_dtype]
        n = layers * FAMILY_STEPS if name == "hymba_fused" else 0
        want_l = dict(landmark_summary=2 * n, query_side=2 * n, landmark_summary_bwd=n,
                      query_side_bwd=n, paged_row_stats=0)
        if name == "sp_whisper":   # the encoder's layers, no remat: one each a layer
            n = family_config(name).encoder_layers * FAMILY_STEPS
            want_l = dict(landmark_summary=n, query_side=n, landmark_summary_bwd=n,
                          query_side_bwd=n, paged_row_stats=0)
        log(f"{name}: {family_config(name).name} {layers} layers seq "
            f"{family_shape(name).seq_len} batch {family_shape(name).global_batch} on 4 "
            f"ranks ({'rows over data' if name == 'whisper' else 'sequence over model'}): "
            f"step 0 ({witness.compute_dtype}, {witness.num_layers} layers) per-position CE "
            f"max abs err {sound:.3e} against the single process (tol {tol}); "
            f"{', '.join(f'{k} {v:.3e}' for k, v in controls.items())} (must exceed it); bf16 "
            f"losses {['%.4f' % x for x in runs[0]['losses']]} vs single-process "
            f"{['%.4f' % x for x in single[name]['losses']]} (rel "
            f"{['%.2e' % x for x in rel]}); ms a step after the first per rank "
            f"{['%.1f' % r['ms'] for r in runs]} (single-process {single[name]['ms']:.1f}); "
            f"peak GiB per rank {['%.2f' % r['peak_gib'] for r in runs]} (single-process "
            f"{single[name]['peak']:.2f}); collectives "
            f"{['%.1f%%' % (100 * r['collective_share']) for r in runs]} of each rank's "
            f"steps; launches per rank {runs[0]['launches']}; phase "
            f"{['%.1f' % r['phase_s'] for r in runs]} s per rank")
        if not sound <= tol:
            raise AssertionError(f"{name}: step 0 per-position CE {sound:.3e} > {tol}")
        for k, control in controls.items():
            if not control > tol:
                raise AssertionError(f"{name}: the {k} moves step 0's CE by {control:.3e}, "
                                     f"within the bound {tol}: the check would not see it")
        groups: dict = {}
        for r in runs:   # the ranks that train the same rows agree
            groups.setdefault(r["coords"]["data"] if name != "whisper" else 0,
                              []).append(r["losses"])
        if name != "whisper" and any(g.count(g[0]) != len(g) for g in groups.values()):
            raise AssertionError(f"{name}: the ranks of a sequence disagree on the losses "
                                 f"{[r['losses'] for r in runs]}")
        if not max(rel) <= FAMILY_LOSS_TOL:
            raise AssertionError(f"{name}: losses {runs[0]['losses']} vs "
                                 f"{single[name]['losses']}: {max(rel):.3e} > "
                                 f"{FAMILY_LOSS_TOL}")
        if any(r["launches"] != want_l for r in runs):
            raise AssertionError(f"{name}: launches per rank {[r['launches'] for r in runs]} "
                                 f"!= {want_l}")


# --------------------------------------------------------------------------
# LLaVA under a sequence shard: step 0 at one fp32 layer
# --------------------------------------------------------------------------
SP_LLAVA_SEQ = 8192          # the joint sequence: min(2880, 4096) patches, 5312 tokens
SP_LLAVA_MESH = (1, 4)       # ("data", "model"): the joint sequence over the 4 ranks
# the leaves whose summed step-0 gradients are held to the single process's:
# the projector, the embedding and the layer
SP_LLAVA_LEAVES = ("mm_proj", "embed", "layers")


def sp_llava_config():
    """LLaVA-NeXT-34B at full width cut to 1 of its 60 layers, in fp32, the
    attention through K1-K4 (``spectral_shift_fused``; under the sequence
    shard the context-parallel driver, ``kv_offset`` / ``q_offset`` at b =
    56, c = 64, 2048 keys a rank, d = 128), remat full."""
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(LLAVA), num_layers=1,
                               attention_impl="spectral_shift_fused",
                               compute_dtype="float32", remat="full")


def sp_llava_params(torch, cfg, dev):
    """Step 0's weights, drawn as the Trainer draws them (seed 0 on the
    device's generator)."""
    from repro_torch.models.model import model_specs, torch_dtype
    from repro_torch.models.params import init_params

    gen = torch.Generator(device=dev).manual_seed(0)
    return init_params(model_specs(cfg), gen, dtype=torch_dtype(cfg.param_dtype), device=dev)


def llava_text_ce(torch, params, cfg, batch):
    """Each text position's CE (rows x text positions, numpy) of a forward
    of ``batch``: a rank's slice of the joint sequence (its text rows are
    the last of its slice, their targets its joint ``targets``'), or the
    whole batch (the last text position against token 0, as a rank's
    targets hold)."""
    import torch.nn.functional as F

    from repro_torch.models.model import model_forward

    with torch.no_grad():
        logits, _ = model_forward(params, cfg, batch)
    n_text = batch["tokens"].shape[1]
    if "targets" in batch:
        targets = batch["targets"][:, batch["targets"].shape[1] - n_text:]
    else:
        tok = batch["tokens"]
        targets = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], dim=1)
    text = logits[:, logits.shape[1] - n_text:].float()
    ce = F.cross_entropy(text.flatten(0, 1), targets.flatten(), reduction="none")
    return ce.view(targets.shape).cpu().numpy()


def sp_llava_rank(mesh, path: str) -> dict:
    """One rank of ``sp_llava``: LLaVA-NeXT-34B (``sp_llava_config``) with
    its joint sequence of SP_LLAVA_SEQ over the 4 ranks of a 1 x 4 mesh of
    its own: shard 0 holds patches only, shard 1 the prefix's end at 2880,
    shards 2-3 text only. Step 0 is computed from the weights and the train
    step's loss and gradient (``train/train_step.py:value_and_grad``) under
    the mesh's rules, not through the ``Trainer``: its constructor
    allocates AdamW's state, 12.2 GB a rank beside 6.1 GB of weights and
    6.1 GB of gradients, which four ranks on the one card would not hold;
    no optimizer step runs. TF32 off. Each text position's CE, sound and
    under the control (the boundary shard's text placed at offset 0 of its
    slice; uncounted), then one gradient (counted); the gradients of
    SP_LLAVA_LEAVES summed over the ranks, written by rank 0 to ``path``
    for the single process (``check_sp_llava``)."""
    import torch

    import repro_torch.models.model as model_module
    from repro_torch.data.pipeline import joint_slices, make_global_batch, to_device
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import apply_seq_sharding_config, sharding_rules
    from repro_torch.models.params import flatten_with_paths
    from repro_torch.train.train_step import value_and_grad

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    lmesh = Mesh(SP_LLAVA_MESH, ("data", "model"), device=mesh.device, timeout_s=SP_TIMEOUT_S)
    dev, ov = lmesh.device, {"seq": "model"}
    cfg = apply_seq_sharding_config(sp_llava_config(), lmesh, ov)
    params = sp_llava_params(torch, cfg, dev)
    host = frontend_batch(cfg, SP_LLAVA_SEQ, 1).batch(0)
    p, n_text = host["patches"].shape[1], host["tokens"].shape[1]
    j = lmesh.index(("model",))
    _, text = joint_slices(p, n_text, SP_LLAVA_MESH[1], j)
    batch = to_device(make_global_batch(host, lmesh, ov), dev)

    def text_first(pe, x):   # the control: the boundary shard's text at offset 0
        return torch.cat([x, pe] if pe.shape[1] and x.shape[1] else [pe, x], dim=1)

    launches: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with sharding_rules(lmesh, ov):
        ce = {"sound": llava_text_ce(torch, params, cfg, batch)}
        joint = model_module._joint_rows
        model_module._joint_rows = text_first
        try:
            ce["control"] = llava_text_ce(torch, params, cfg, batch)
        finally:
            model_module._joint_rows = joint
        coll0, t0 = lmesh.collective_seconds, time.perf_counter()
        loss, _, grads = _counted(launches, lambda: value_and_grad(params, cfg, batch))
        torch.cuda.synchronize(dev)
        grad_s = time.perf_counter() - t0
        share = (lmesh.collective_seconds - coll0) / grad_s
    loss = float(lmesh.all_reduce(loss.reshape(1), "sum", ("model",)))
    summed = {}
    for name, g in flatten_with_paths(grads).items():
        if name.split("::")[0] in SP_LLAVA_LEAVES:
            g = lmesh.all_reduce(g.contiguous(), "sum", ("model",))
            if lmesh.rank == 0:
                summed[name] = g.cpu()
            del g
    del grads, params
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if lmesh.rank == 0:
        torch.save(summed, path)
    del summed
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=lmesh.rank, shard=j, patches=int(batch["patches"].shape[1]),
                text=(text.start, text.stop), ce=ce, loss=loss, launches=launches,
                grad_s=grad_s, collective_share=share, peak_gib=peak,
                phase_s=time.perf_counter() - t_phase)


def check_sp_llava(torch, dev, lls: list, path: str) -> None:
    """``sp_llava``'s single process, after the ranks have exited (one fp32
    layer at 8192 positions, about 14 GB): each text position's CE within
    FAMILY_STEP0_TOL["float32"] of every rank's, which the control must
    exceed; the summed gradients of SP_LLAVA_LEAVES within SP_GRAD_TOL of
    each leaf's max-abs; launches per rank K1 2 / K2 2 / K3 1 / K4 1 (one
    layer, remat full)."""
    import numpy as np

    from repro_torch.data.pipeline import to_device
    from repro_torch.models.params import flatten_with_paths
    from repro_torch.train.train_step import value_and_grad

    t0 = time.perf_counter()
    cfg = sp_llava_config()
    params = sp_llava_params(torch, cfg, dev)
    batch = to_device(frontend_batch(cfg, SP_LLAVA_SEQ, 1).batch(0), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ref = llava_text_ce(torch, params, cfg, batch)
    loss, _, grads = value_and_grad(params, cfg, batch)
    loss = float(loss)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del params
    summed = torch.load(path)
    os.remove(path)
    errs = {}
    for name, g in flatten_with_paths(grads).items():
        if name in summed:
            errs[name] = float((g - summed[name].to(dev)).abs().max() / g.abs().max())
    if set(errs) != set(summed):
        raise AssertionError(f"sp_llava: gradient leaves {sorted(summed)} vs {sorted(errs)}")
    del grads, summed
    gc.collect()
    torch.cuda.empty_cache()
    sound = control = 0.0
    for r in lls:
        want = ref[:, r["text"][0]:r["text"][1]]
        sound = max(sound, float(np.abs(r["ce"]["sound"] - want).max()) if want.size else 0.0)
        if want.size:
            control = max(control, float(np.abs(r["ce"]["control"] - want).max()))
    worst = max(errs, key=errs.get)
    tol = FAMILY_STEP0_TOL["float32"]
    want_l = dict(landmark_summary=2, query_side=2, landmark_summary_bwd=1, query_side_bwd=1,
                  paged_row_stats=0)
    log(f"sp_llava: {cfg.name} 1 fp32 layer (TF32 off), joint seq {SP_LLAVA_SEQ} "
        f"(patches per shard {[r['patches'] for r in lls]}, text per shard "
        f"{[r['text'][1] - r['text'][0] for r in lls]}) over {SP_LLAVA_MESH[1]} ranks: "
        f"step 0 per-position CE max abs err {sound:.3e} against the single process (tol "
        f"{tol}); control, the boundary shard's text at offset 0 of its slice, "
        f"{control:.3e} (must exceed it); loss {lls[0]['loss']:.6f} vs {loss:.6f}; "
        f"gradients of {len(errs)} leaves worst {errs[worst]:.3e} of max-abs ({worst}; tol "
        f"{SP_GRAD_TOL}); forward + backward {['%.1f' % (1e3 * r['grad_s']) for r in lls]} "
        f"ms per rank, collectives {['%.1f%%' % (100 * r['collective_share']) for r in lls]}; "
        f"peak GiB per rank {['%.2f' % r['peak_gib'] for r in lls]} (single process "
        f"{peak:.2f}); launches per rank {lls[0]['launches']}; phase "
        f"{['%.1f' % r['phase_s'] for r in lls]} s per rank, single {time.perf_counter() - t0:.1f} s")
    if not sound <= tol:
        raise AssertionError(f"sp_llava: step 0 per-position CE {sound:.3e} > {tol}")
    if not control > tol:
        raise AssertionError(f"sp_llava: the control moves step 0's CE by {control:.3e}, "
                             f"within the bound {tol}: the check would not see it")
    if not errs[worst] <= SP_GRAD_TOL:
        raise AssertionError(f"sp_llava: gradient {worst} {errs[worst]:.3e} > {SP_GRAD_TOL}")
    if any(r["launches"] != want_l for r in lls):
        raise AssertionError(f"sp_llava: launches per rank {[r['launches'] for r in lls]} "
                             f"!= {want_l}")


def sp_rank(mesh, attention: dict, seq: int, batch: int, steps: int, tp: tuple,
            ep: tuple, pp: tuple, elastic: tuple, dry: tuple, fam: tuple,
            llava: tuple) -> dict:
    """The context-parallel paths, ``tp_train``, ``ep_train``, ``pp_train``,
    ``dryrun``, the family paths, ``sp_llava`` and ``elastic_train`` on one
    rank of the SP_MESH group, each phase's memory freed before the next."""
    import torch

    out = {"attention": sp_attention_rank(mesh, **attention)}
    gc.collect()
    out["train"] = sp_train_rank(mesh, seq, batch, steps)
    gc.collect()
    out["tp"] = tp_train_rank(mesh, *tp)
    for name, fn, args in (("ep", ep_train_rank, ep), ("pp", pp_train_rank, pp),
                           ("dryrun", dryrun_rank, dry), ("families", family_rank, fam),
                           ("llava", sp_llava_rank, llava),
                           ("elastic", elastic_train_rank, elastic)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn(mesh, *args)
        out[name]["phase_s"] = time.perf_counter() - t0
    return out


def sp_phase(torch, dev) -> dict:
    """``sp_attention``, ``sp_train``, ``tp_train``, ``ep_train``,
    ``pp_train``, ``dryrun`` and ``elastic_train``: 4 ranks on the one card
    (``launch/mesh.py:spawn_local``, gloo: NCCL will not put two ranks of
    one communicator on one GPU, so the (c, .)-sized collectives are staged
    through host memory; no figure here is one for NVLink), a ("data",
    "model") mesh of 2 x 2. ``sp_attention``: the context-parallel attention
    at Qwen2-7B's shape (b 56, c 64, n 8192, d 128, causal) over 2 and 4
    shards against the single-device fused route, fp32 within SP_FWD_TOL /
    SP_GRAD_TOL of max-abs, bf16 printed, remat "ss_stats" bitwise equal
    to none (its two B-side collectives not rerun), K1-K4 counted per
    rank. ``sp_train``: paper-bert (12 layers, d 512, 8 heads of 64, c 64)
    at global seq 8192, batch 4, 2 steps, data over "data" and the
    sequence over "model", its step-0 loss (a forward of the same weights)
    within SP_STEP0_TOL of the single-process Trainer's (run first, here),
    a bound that a control with one shard's B-side partial dropped must
    exceed, and its later losses within the sanity bound SP_LOSS_TOL, its
    launches per rank K1 2 / K2 2 / K3 1 / K4 1 a layer and step (remat
    full); the 1-layer fp32 twin's gradients within GRAD_TOL. ``tp_train``:
    paper-bert at TP_STEP0_LAYERS fp32 layers, seq 4096, global batch 8,
    2 steps under the default rules (tensor parallelism over "model",
    FSDP over "data"; K1-K4 at each rank's 16 batch-heads), step 0's loss
    within TP_STEP0_TOL of one device's, a bound that a control with layer
    0's MLP all-reduce dropped must exceed, launches per rank K1 2 / K2 2
    / K3 1 / K4 1 a layer and step (remat full), the 1-layer fp32 twin's
    gathered gradients within GRAD_TOL, and its last step's checkpoint
    restored bitwise (gathered parameters) onto a 1 x 4 mesh and onto one
    device. ``ep_train``, ``pp_train`` and ``elastic_train`` on meshes of
    their own over the same ranks (``ep_train_rank``, ``pp_train_rank``,
    ``elastic_train_rank``; the one-device reference of ``ep_train``'s step
    0 runs here first), ``dryrun`` on the group's (``dryrun_rank``,
    ``check_dryrun``). Returns the
    launches of each path, summed over the ranks."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.train.trainer import Trainer

    shape = ShapeConfig("train_4k", SP_TRAIN_SEQ, SP_TRAIN_BATCH, "train")
    single = train_steps(torch, dev, sp_paper_bert(), shape, SP_TRAIN_STEPS,
                         "sp_train single-process reference")
    fam_single = family_single(torch, dev)
    # ep_train's single-process reference: step 0 of the same weights under
    # "gspmd" on one device
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep0_") as tmp:
        one = Trainer(ep_check_config("gspmd"), TrainConfig(checkpoint_dir=tmp),
                      ShapeConfig("train_4k", EP_CHECK_SEQ, EP_BATCH, "train"), device=dev)
        ep_single0 = step0_ce(one)
        del one
    gc.collect()
    torch.cuda.empty_cache()
    tp_ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_tp_ckpt_")
    elastic_root = tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_")
    llava_root = tempfile.TemporaryDirectory(prefix="chip_smoke_sp_llava_")
    llava_grads = os.path.join(llava_root.name, "grads.pt")
    t0 = time.perf_counter()
    ranks = spawn_local(sp_rank, SP_MESH, ("data", "model"),
                        args=(SP_ATTENTION, SP_TRAIN_SEQ, SP_TRAIN_BATCH, SP_TRAIN_STEPS,
                              (TP_TRAIN_SEQ, TP_TRAIN_BATCH, TP_TRAIN_STEPS, tp_ckpt.name),
                              (EP_SEQ, EP_BATCH, EP_STEPS), (PP_SEQ, PP_STEPS),
                              (TP_TRAIN_SEQ, TP_TRAIN_BATCH, elastic_root.name),
                              (TP_TRAIN_SEQ, TP_TRAIN_BATCH, elastic_root.name),
                              (FAMILY_STEPS,), (llava_grads,)),
                        backend="gloo", device="cuda", timeout_s=SP_TIMEOUT_S, threads=2)
    wall = time.perf_counter() - t0
    elastic_root.cleanup()
    # ---- sp_attention ------------------------------------------------------
    for key in ((2, "float32"), (2, "bfloat16"), (4, "float32"), (4, "bfloat16")):
        cases = [r["attention"]["cases"][key] for r in ranks]
        fwd = max(cs["fwd"] for cs in cases)
        grads = [max(cs["grads"][j] for cs in cases) for j in range(3)]
        log(f"sp_attention {key[0]} shards {key[1]}: forward rel err {fwd:.2e}, grads dq / "
            f"dk / dv {['%.2e' % g for g in grads]} of max-abs against the single-device "
            f"fused route; forward + backward ms per rank "
            f"{['%.1f' % cs['ms'] for cs in cases]}")
        if key[1] == "float32" and not (fwd <= SP_FWD_TOL and max(grads) <= SP_GRAD_TOL):
            raise AssertionError(f"sp_attention {key}: forward {fwd:.3e} (tol {SP_FWD_TOL}) "
                                 f"or grads {max(grads):.3e} (tol {SP_GRAD_TOL})")
    for shards in (2, 4):
        ss = [r["attention"]["cases"][(shards, "ss_stats")] for r in ranks]
        if not all(s["bitwise"] for s in ss):
            raise AssertionError(f"sp_attention {shards} shards: remat ss_stats gradients "
                                 f"differ from none")
        # the recompute reruns the landmark all-reduce alone: the B-side op is kept
        if any(s["collectives"][1] != s["collectives"][0] + 1 for s in ss):
            raise AssertionError(f"sp_attention {shards} shards: collectives none / "
                                 f"ss_stats {[s['collectives'] for s in ss]}")
    att_launches = [r["attention"]["launches"] for r in ranks]
    # per rank: 2 dtypes x 2 meshes x 2 runs (K1-K4 one each) + the two remat
    # runs x 2 meshes (K1 2, K2 3, K3 2, K4 2)
    want = dict(landmark_summary=12, query_side=14, landmark_summary_bwd=12,
                query_side_bwd=12, paged_row_stats=0)
    if any(lc != want for lc in att_launches):
        raise AssertionError(f"sp_attention: launches per rank {att_launches} != {want}")
    log(f"sp_attention: remat ss_stats gradients bitwise equal to none on every rank; "
        f"launches per rank {att_launches[0]}; collectives "
        f"{['%.1f%%' % (100 * r['attention']['collective_share']) for r in ranks]} of each "
        f"rank's phase; peak GiB per rank "
        f"{['%.2f' % r['attention']['peak_gib'] for r in ranks]}")
    # ---- sp_train ----------------------------------------------------------
    trains = [r["train"] for r in ranks]
    losses = trains[0]["losses"]
    if any(t["losses"] != losses for t in trains):
        raise AssertionError(f"sp_train: ranks disagree on the losses "
                             f"{[t['losses'] for t in trains]}")
    rel = rel_diffs(losses, single["losses"])
    layers = sp_paper_bert().num_layers
    per_rank = dict(landmark_summary=2 * layers * SP_TRAIN_STEPS,
                    query_side=2 * layers * SP_TRAIN_STEPS,
                    landmark_summary_bwd=layers * SP_TRAIN_STEPS,
                    query_side_bwd=layers * SP_TRAIN_STEPS, paged_row_stats=0)
    if any(t["launches"] != per_rank for t in trains):
        raise AssertionError(f"sp_train: launches per rank "
                             f"{[t['launches'] for t in trains]} != {per_rank}")
    twin = trains[0]["twin"]
    # step 0 is a forward of the same weights on both sides: held at
    # SP_STEP0_TOL, which the control (one shard's B-side partial dropped)
    # must exceed; the later steps' bf16 drift is held at SP_LOSS_TOL only
    # (a sanity bound: Adam's first steps amplify rounding)
    step0 = trains[0]["step0"]
    if any(t["step0"] != step0 for t in trains):
        raise AssertionError(f"sp_train: ranks disagree on step 0's CE "
                             f"{[t['step0'] for t in trains]}")
    ref0 = single["losses"][0]
    sound0, control0 = (abs(step0[k] - ref0) / abs(ref0) for k in ("sound", "control"))
    log(f"sp_train step 0 (a forward at the initial weights): SP loss rel {rel[0]:.2e} "
        f"(tol {SP_STEP0_TOL}), SP forward CE {step0['sound']:.6f} (rel {sound0:.2e}); "
        f"control, shard 1's B-side partial dropped from the merge: CE "
        f"{step0['control']:.6f} (rel {control0:.2e}, must exceed the tol); single-process "
        f"{ref0:.6f}")
    if not rel[0] <= SP_STEP0_TOL:
        raise AssertionError(f"sp_train: step 0 loss {losses[0]} vs {ref0}: {rel[0]:.3e} > "
                             f"{SP_STEP0_TOL}")
    if not control0 > SP_STEP0_TOL:
        raise AssertionError(f"sp_train: the control (a dropped B-side partial) moves step "
                             f"0's CE by {control0:.3e}, within the bound {SP_STEP0_TOL}: "
                             f"the check would not see it")
    log(f"sp_train: paper-bert 12 layers seq {SP_TRAIN_SEQ} batch {SP_TRAIN_BATCH} over "
        f"{SP_MESH[0]} x {SP_MESH[1]} ranks (plan {trains[0]['plan']}): losses "
        f"{['%.4f' % x for x in losses]} vs single-process {['%.4f' % x for x in single['losses']]} "
        f"(rel {['%.2e' % x for x in rel]}, tol {SP_LOSS_TOL}); ms per step after the first "
        f"{['%.1f' % t['ms'] for t in trains]} (single-process {single['ms']:.1f}); peak "
        f"GiB per rank {['%.2f' % t['peak_gib'] for t in trains]}; collectives "
        f"{['%.1f%%' % (100 * t['collective_share']) for t in trains]} of each rank's steps "
        f"(gloo through the host); launches per rank {trains[0]['launches']}; 1-layer fp32 "
        f"twin loss rel {twin['loss']:.2e}, worst grad leaf {twin['grad']:.2e} of max-abs "
        f"(tol {GRAD_TOL}); the ranks' group {wall:.1f}s")
    if not max(rel) <= SP_LOSS_TOL:
        raise AssertionError(f"sp_train: losses {losses} vs {single['losses']}: "
                             f"{max(rel):.3e} > {SP_LOSS_TOL}")
    if not (twin["grad"] <= GRAD_TOL and twin["loss"] <= GRAD_TOL):
        raise AssertionError(f"sp_train: 1-layer fp32 twin {twin} past {GRAD_TOL}")
    # ---- tp_train ----------------------------------------------------------
    tps = [r["tp"] for r in ranks]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp0_") as tmp:
        one = Trainer(tp_step0_config(), TrainConfig(checkpoint_dir=tmp),
                      ShapeConfig("train_4k", TP_TRAIN_SEQ, TP_TRAIN_BATCH, "train"),
                      device=dev)
        single0 = tp_step0_ce(one, False)
        del one
    with tp_ckpt:
        one = Trainer(tp_step0_config(), TrainConfig(checkpoint_dir=tp_ckpt.name),
                      ShapeConfig("train_4k", TP_TRAIN_SEQ, TP_TRAIN_BATCH, "train"),
                      device=dev)
        one_restored = (one.step, params_digest(one) == tps[0]["digest"])
        del one
        gc.collect()
        torch.cuda.empty_cache()
    check_tp_train(tps, one_restored, single0)
    eps = [r["ep"] for r in ranks]
    check_ep_train(eps, ep_single0)
    pps = [r["pp"] for r in ranks]
    check_pp_train(pps)
    drys = [r["dryrun"] for r in ranks]
    check_dryrun(drys)
    fams = [r["families"] for r in ranks]
    check_families(fams, fam_single)
    lls = sorted((r["llava"] for r in ranks), key=lambda r: r["shard"])
    with llava_root:
        check_sp_llava(torch, dev, lls, llava_grads)
    els = [r["elastic"] for r in ranks]
    check_elastic_train(els)
    log(f"the ranks' group {wall:.1f}s: ep_train {['%.1f' % e['phase_s'] for e in eps]} s, "
        f"pp_train {['%.1f' % p['phase_s'] for p in pps]} s, dryrun "
        f"{['%.1f' % d['phase_s'] for d in drys]} s, families "
        f"{['%.1f' % f['phase_s'] for f in fams]} s, sp_llava "
        f"{['%.1f' % r['phase_s'] for r in lls]} s, elastic_train "
        f"{['%.1f' % e['phase_s'] for e in els]} s per rank")

    def total(rows):
        return {k: sum(r[k] for r in rows) for k in rows[0]}

    return {"sp_attention": total(att_launches),
            "sp_train": total([t["launches"] for t in trains]),
            "tp_train": total([t["launches"] for t in tps]),
            "ep_train": total([e["launches"] for e in eps]),
            "pp_train": total([p["launches"] for p in pps]),
            "dryrun": total([d["launches"] for d in drys]),
            **{{"hymba_chunked": "sp_hymba_chunked", "hymba_fused": "sp_hymba_fused",
                "xlstm": "sp_xlstm", "sp_whisper": "sp_whisper", "whisper": "dp_whisper"}[name]:
               total([f[name]["launches"] for f in fams]) for name in FAMILIES},
            "sp_llava": total([r["launches"] for r in lls]),
            "elastic_train": total([e["launches"] for e in els])}


def check_elastic_train(els: list) -> None:
    """Hold ``elastic_train``'s ranks (``elastic_train_rank``'s results): the
    survivors on 1 x 2 reach ELASTIC_STEPS, the others stop at the failure,
    inactive; the survivors' steps after the failure equal the
    uninterrupted restore bitwise and the control (step 0's state at the
    failure step) differs; launches per rank K1 2 / K2 2 / K3 1 / K4 1 a
    layer and step run (remat full). Logs the restart's seconds, ms a step
    before and after, peak GiB."""
    layers = tp_step0_config().num_layers
    for e in els:
        survivor = e["rank"] in ELASTIC_SURVIVORS
        run = ELASTIC_STEPS if survivor else ELASTIC_FAIL_AT
        if (e["active"] != survivor or sorted(e["losses"]) != list(range(run))
                or e["mesh"] != {"data": 1, "model": 2}
                or e["hosts"] != [f"host{i}" for i in range(1, ELASTIC_HOSTS)]):
            raise AssertionError(f"elastic_train rank {e['rank']}: active {e['active']}, "
                                 f"steps {sorted(e['losses'])}, mesh {e['mesh']}, hosts "
                                 f"{e['hosts']}")
        want = dict(landmark_summary=2 * layers * run, query_side=2 * layers * run,
                    landmark_summary_bwd=layers * run, query_side_bwd=layers * run,
                    paged_row_stats=0)
        if e["launches"] != want:
            raise AssertionError(f"elastic_train rank {e['rank']}: launches {e['launches']} "
                                 f"!= {want}")
        if not all(math.isfinite(x) for x in e["losses"].values()):
            raise AssertionError(f"elastic_train rank {e['rank']}: losses {e['losses']}")
    after = range(ELASTIC_FAIL_AT, ELASTIC_STEPS)
    for e in (els[r] for r in ELASTIC_SURVIVORS):
        if any(e["losses"][s] != e["resume"][s] for s in after):
            raise AssertionError(f"elastic_train rank {e['rank']}: steps {list(after)} "
                                 f"{[e['losses'][s] for s in after]} differ from the "
                                 f"uninterrupted restore {[e['resume'][s] for s in after]}")
        if e["control"][ELASTIC_FAIL_AT] == e["losses"][ELASTIC_FAIL_AT]:
            raise AssertionError("elastic_train: the control (step 0's state restored at "
                                 "the failure step) gives the same loss: the check would "
                                 "not see a wrong restore")
    surv = els[ELASTIC_SURVIVORS[0]]
    rec = [e["recoveries"][0] for e in els]
    log(f"elastic_train: paper-bert {tp_step0_config().num_layers} fp32 layers seq "
        f"{TP_TRAIN_SEQ} batch {TP_TRAIN_BATCH}, TP 2 x FSDP 2 -> host0 fails at step "
        f"{ELASTIC_FAIL_AT} -> 1 x 2 over world ranks {ELASTIC_SURVIVORS}: losses "
        f"{['%.6f' % surv['losses'][s] for s in range(ELASTIC_STEPS)]}, steps "
        f"{list(after)} bitwise equal to the uninterrupted restore on both survivors; "
        f"control (step 0's state at step {ELASTIC_FAIL_AT}) "
        f"{surv['control'][ELASTIC_FAIL_AT]:.6f} (differs); restart seconds per rank: wait "
        f"{['%.3f' % r['wait_s'] for r in rec]}, new groups "
        f"{['%.3f' % r['groups_s'] for r in rec]}, restore "
        f"{['%.3f' % r.get('restore_s', float('nan')) for r in rec]}, slice check "
        f"{['%.3f' % r.get('check_s', float('nan')) for r in rec]}; ms a step per rank "
        f"{[{s: round(m, 1) for s, m in e['ms'].items()} for e in els]}; peak GiB per rank "
        f"{['%.2f' % e['peak_gib'] for e in els]}")


def check_dryrun(drys: list) -> None:
    """Hold ``dryrun``'s ranks (``dryrun_rank``'s results: one real step on
    the card) to ``run_cell`` of the same config and shape on a 2 x 2
    ``AbstractMesh`` at each rank: FLOPs by op (K1-K4's formulas counted,
    not zero), collectives by op and state bytes, exactly. Traces
    Qwen2-7B's ``train_4k`` cell on the production mesh on the host under
    its own ``chunked`` attention (keys all-gathered over the sequence
    shard) and under the fused one, logging each one's time, FLOPs and
    collectives, and Whisper's and LLaVA's ``train_4k`` cells, which trace
    under the sequence shard (LLaVA at 2 of its 60 layers:
    host time); each gathers its decoder's keys (``chunked``) and Whisper's
    cross attention all-reduces its global query landmarks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.launch.dryrun import run_cell

    cfg = tp_step0_config()
    overrides = dict(num_layers=cfg.num_layers, compute_dtype=cfg.compute_dtype,
                     attention_impl=cfg.attention_impl)
    shape = ShapeConfig("train_4k", TP_TRAIN_SEQ, TP_TRAIN_BATCH, "train")
    for d in drys:
        t0 = time.perf_counter()
        cell = run_cell("paper-bert", "train_4k", False, cfg_overrides=overrides,
                        mesh=AbstractMesh(SP_MESH, ("data", "model"), rank=d["rank"]),
                        shape=shape)
        trace_s = time.perf_counter() - t0
        if (cell["flops_by_op"] != d["flops_by_op"] or cell["collectives"] != d["collectives"]
                or cell["state_bytes_per_device"] != d["state"]):
            raise AssertionError(f"dryrun rank {d['rank']}: predicted flops "
                                 f"{cell['flops_by_op']}, collectives {cell['collectives']}, "
                                 f"state {cell['state_bytes_per_device']}; the card's "
                                 f"{d['flops_by_op']}, {d['collectives']}, {d['state']}")
        zero = [op for op in TRAIN_KERNELS
                if not cell["flops_by_op"].get(f"repro_torch.{op}", 0) > 0]
        if zero:
            raise AssertionError(f"dryrun: no FLOPs counted for {zero}")
    log(f"dryrun: tp_train's step on the card (rank 0: {drys[0]['ms']:.1f} ms, "
        f"{sum(drys[0]['flops_by_op'].values()):.6e} FLOPs: "
        f"{json.dumps(drys[0]['flops_by_op'])}; collectives "
        f"{json.dumps(drys[0]['collectives'])}; state {drys[0]['state']:.0f} B) equals "
        f"run_cell on a 2 x 2 AbstractMesh on every rank (last trace {trace_s:.2f} s)")
    frontends = []
    for arch, over in ((WHISPER, None), (LLAVA, dict(num_layers=2))):
        t0 = time.perf_counter()
        cell = run_cell(arch, "train_4k", False, cfg_overrides=over)
        need = ("all-gather", "all-reduce") if arch == WHISPER else ("all-gather",)
        if not all(cell["collectives"].get(op, {}).get("count") for op in need):
            raise AssertionError(f"dryrun: {arch} train_4k: collectives {cell['collectives']}")
        frontends.append(f"run_cell('{arch}', 'train_4k', False"
                         f"{', cfg_overrides=' + json.dumps(over) if over else ''}) "
                         f"{time.perf_counter() - t0:.1f} s on the host (trace "
                         f"{cell['trace_s']} s): {cell['flops_total']:.6e} FLOPs a rank, "
                         f"collectives {json.dumps(cell['collectives'])}")
    for attention in (None, "spectral_shift_fused"):
        t0 = time.perf_counter()
        cell = run_cell("qwen2-7b", "train_4k", False, attention=attention)
        if not cell["collectives"].get("all-gather" if attention is None
                                       else "all-reduce", {}).get("count"):
            raise AssertionError(f"dryrun: qwen2-7b train_4k under {cell['attention']}: "
                                 f"collectives {cell['collectives']}")
        log(f"dryrun: run_cell('qwen2-7b', 'train_4k', False) under {cell['attention']} "
            f"{time.perf_counter() - t0:.1f} s on the host (trace {cell['trace_s']} s): "
            f"{cell['flops_total']:.6e} FLOPs a rank, state "
            f"{cell['state_bytes_per_device']:.0f} B, collectives "
            f"{json.dumps(cell['collectives'])}")
    for line in frontends:
        log(f"dryrun: {line}")


def check_ep_train(eps: list, single0: float) -> None:
    """Hold ``ep_train``'s ranks (``ep_train_rank``'s results) to one
    device's step-0 CE of ``ep_check_config`` under "gspmd" (``single0``)
    and to each other; log its figures."""
    losses, step0 = eps[0]["losses"], eps[0]["step0"]
    if any(e["losses"] != losses or e["step0"] != step0 for e in eps):
        raise AssertionError(f"ep_train: ranks disagree on the losses or step 0's CE "
                             f"{[(e['losses'], e['step0']) for e in eps]}")
    sound0, control0 = (abs(step0[k] - single0) / abs(single0) for k in ("sound", "control"))
    cfg = ep_config()
    log(f"ep_train step 0 (a forward of the initial weights at 1 fp32 layer, TF32 off, "
        f"capacity E / k, seq {EP_CHECK_SEQ}): EP over {EP_MESH[0]} x {EP_MESH[1]} CE "
        f"{step0['sound']:.7f} (rel {sound0:.2e}, tol {EP_STEP0_TOL}); control, the return "
        f"exchange's source order reversed: CE {step0['control']:.7f} (rel {control0:.2e}, "
        f"must exceed the tol); one device under gspmd {single0:.7f}")
    log(f"ep_train: DeepSeek-V2-Lite {cfg.num_layers} layers (d {cfg.d_model}, "
        f"{cfg.num_experts} experts top-{cfg.top_k}, capacity {cfg.capacity_factor}) bf16, "
        f"seq {EP_SEQ} batch {EP_BATCH} over {EP_MESH[0]} x {EP_MESH[1]} ranks, expert "
        f"slice per rank {eps[0]['experts']}: losses {['%.4f' % x for x in losses]}, aux "
        f"{['%.4f' % x for x in eps[0]['aux']]}; ms per step after the first "
        f"{['%.1f' % e['ms'] for e in eps]}; all-to-all "
        f"{['%.1f%%' % (100 * e['exchange_share']) for e in eps]} and all-reduces "
        f"{['%.1f%%' % (100 * e['all_reduce_share']) for e in eps]} of each rank's steps "
        f"(gloo on one card, staged through the host); routed slots dropped "
        f"{['%.2f%%' % (100 * e['dropped']) for e in eps]}; peak GiB per rank "
        f"{['%.2f' % e['peak_gib'] for e in eps]}; Trainer built in "
        f"{['%.1f' % e['init_s'] for e in eps]} s; launches per rank {eps[0]['launches']}")
    if not sound0 <= EP_STEP0_TOL:
        raise AssertionError(f"ep_train: step 0's CE {step0['sound']} vs {single0}: "
                             f"{sound0:.3e} > {EP_STEP0_TOL}")
    if not control0 > EP_STEP0_TOL:
        raise AssertionError(f"ep_train: the control (a reversed return exchange) moves step "
                             f"0's CE by {control0:.3e}, within the bound {EP_STEP0_TOL}: "
                             f"the check would not see it")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ep_train: non-finite loss {losses}")
    if any(sum(e["launches"].values()) for e in eps):
        raise AssertionError(f"ep_train: MLA and the MoE run no kernel, but launched "
                             f"{eps[0]['launches']}")


def check_pp_train(pps: list) -> None:
    """Hold ``pp_train``'s check (``pp_check``) and launches; log its
    figures."""
    losses = pps[0]["losses"]
    if any(p["losses"] != losses for p in pps):
        raise AssertionError(f"pp_train: ranks disagree on the losses "
                             f"{[p['losses'] for p in pps]}")
    checks = [p["check"] for p in pps]
    per = sp_paper_bert().num_layers // PP_STAGES
    per_rank = dict(landmark_summary=per * PP_MICRO * PP_STEPS,
                    query_side=per * PP_MICRO * PP_STEPS,
                    landmark_summary_bwd=per * PP_MICRO * PP_STEPS,
                    query_side_bwd=per * PP_MICRO * PP_STEPS, paged_row_stats=0)
    bubble = (PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1)
    log(f"pp_train check ({PP_CHECK_LAYERS} fp32 layers, one a stage, TF32 off, against "
        f"reference_forward one microbatch at a time): output gap "
        f"{[c['out_gap'] for c in checks]} (max-abs {checks[0]['scale']:.3e}), loss gap "
        f"{[c['loss_gap'] for c in checks]} (bitwise expected); worst stage grad leaf "
        f"{['%.2e' % c['grad'] for c in checks]} of max-abs (tol {PP_GRAD_TOL}); control, "
        f"stage 1 fed the previous tick's activation: output gap "
        f"{['%.3e' % c['control'] for c in checks]} (must be non-zero)")
    log(f"pp_train: paper-bert {sp_paper_bert().num_layers} layers bf16 over {PP_STAGES} "
        f"stages, {PP_MICRO} microbatches of {PP_MB} x {PP_SEQ}: losses "
        f"{['%.4f' % x for x in losses]}; ms per step (forward + backward) after the first "
        f"{['%.1f' % p['ms'] for p in pps]}; send "
        f"{['%.1f%%' % (100 * p['shares']['send']) for p in pps]}, recv (transfers and "
        f"waits: the measured bubble, the schedule's {100 * bubble:.1f}%) "
        f"{['%.1f%%' % (100 * p['shares']['recv']) for p in pps]}, broadcast "
        f"{['%.1f%%' % (100 * p['shares']['broadcast']) for p in pps]} of each rank's "
        f"steps (gloo on one card, through the host); peak GiB per rank "
        f"{['%.2f' % p['peak_gib'] for p in pps]}; launches per rank "
        f"{[p['launches'] for p in pps]}")
    if any(c["out_gap"] != 0.0 or c["loss_gap"] != 0.0 for c in checks):
        raise AssertionError(f"pp_train: the pipelined forward differs from the sequential "
                             f"one: {checks}")
    if not all(c["grad"] <= PP_GRAD_TOL for c in checks):
        raise AssertionError(f"pp_train: stage gradients {[c['grad'] for c in checks]} past "
                             f"{PP_GRAD_TOL}")
    if not all(c["control"] > 0.0 for c in checks[1:]):
        raise AssertionError(f"pp_train: the control (a stale activation) left the output "
                             f"unchanged: {[c['control'] for c in checks]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pp_train: non-finite loss {losses}")
    if any(p["launches"] != per_rank for p in pps):
        raise AssertionError(f"pp_train: launches per rank {[p['launches'] for p in pps]} "
                             f"!= {per_rank}")


def check_tp_train(tps: list, one_restored: tuple, single0: float) -> None:
    """Hold ``tp_train``'s ranks (``tp_train_rank``'s results) to one
    device's step-0 CE of ``tp_step0_config`` (``single0``) and to each
    other; log its figures."""
    losses = tps[0]["losses"]
    if any(t["losses"] != losses for t in tps):
        raise AssertionError(f"tp_train: ranks disagree on the losses "
                             f"{[t['losses'] for t in tps]}")
    step0 = tps[0]["step0"]
    if any(t["step0"] != step0 for t in tps):
        raise AssertionError(f"tp_train: ranks disagree on step 0's CE "
                             f"{[t['step0'] for t in tps]}")
    sound0, control0 = (abs(step0[k] - single0) / abs(single0) for k in ("sound", "control"))
    per_rank = dict(landmark_summary=2 * TP_STEP0_LAYERS * TP_TRAIN_STEPS,
                    query_side=2 * TP_STEP0_LAYERS * TP_TRAIN_STEPS,
                    landmark_summary_bwd=TP_STEP0_LAYERS * TP_TRAIN_STEPS,
                    query_side_bwd=TP_STEP0_LAYERS * TP_TRAIN_STEPS, paged_row_stats=0)
    twin = tps[0]["twin"]
    log(f"tp_train step 0 (a forward of the initial weights at {TP_STEP0_LAYERS} fp32 "
        f"layers, TF32 off): TP x FSDP CE {step0['sound']:.7f} (rel {sound0:.2e}, tol "
        f"{TP_STEP0_TOL}); control, layer 0's MLP all-reduce dropped: CE "
        f"{step0['control']:.7f} (rel {control0:.2e}, must exceed the tol); one device "
        f"{single0:.7f}")
    log(f"tp_train: paper-bert {TP_STEP0_LAYERS} fp32 layers seq {TP_TRAIN_SEQ} batch "
        f"{TP_TRAIN_BATCH} over {SP_MESH[0]} x {SP_MESH[1]} ranks, tensor-parallel axes "
        f"(heads, kv heads, ff, vocab) {tps[0]['tp']}, FSDP over data (plan "
        f"{tps[0]['plan']}): losses {['%.4f' % x for x in losses]}; ms per step after the "
        f"first {['%.1f' % t['ms'] for t in tps]}; peak GiB per rank "
        f"{['%.2f' % t['peak_gib'] for t in tps]}; collectives "
        f"{['%.1f%%' % (100 * t['collective_share']) for t in tps]} of each rank's steps "
        f"(gloo on one card, staged through the host: no figure here stands for "
        f"NVLink); launches per rank {tps[0]['launches']}; checkpoint gathered and "
        f"written in {['%.1f' % t['save_s'] for t in tps]} s; restored onto 1 x 4 "
        f"(step, bitwise, tensor-parallel axes) {tps[0]['restored']} and onto one "
        f"device (step, bitwise) {one_restored}; 1-layer fp32 twin loss rel "
        f"{twin['loss']:.2e}, worst gathered grad leaf {twin['grad']:.2e} of max-abs "
        f"(tol {GRAD_TOL})")
    if not sound0 <= TP_STEP0_TOL:
        raise AssertionError(f"tp_train: step 0's CE {step0['sound']} vs {single0}: "
                             f"{sound0:.3e} > {TP_STEP0_TOL}")
    if not control0 > TP_STEP0_TOL:
        raise AssertionError(f"tp_train: the control (a dropped MLP all-reduce) moves step "
                             f"0's CE by {control0:.3e}, within the bound {TP_STEP0_TOL}: "
                             f"the check would not see it")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"tp_train: non-finite loss {losses}")
    if any(t["launches"] != per_rank for t in tps):
        raise AssertionError(f"tp_train: launches per rank "
                             f"{[t['launches'] for t in tps]} != {per_rank}")
    if not (twin["grad"] <= GRAD_TOL and twin["loss"] <= GRAD_TOL):
        raise AssertionError(f"tp_train: 1-layer fp32 twin {twin} past {GRAD_TOL}")
    if any(t["restored"][:2] != (TP_TRAIN_STEPS, True) for t in tps) or one_restored != (
            TP_TRAIN_STEPS, True):
        raise AssertionError(f"tp_train: restores {[t['restored'] for t in tps]}, "
                             f"{one_restored}: not the saved step's parameters")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="depth of the served model (width is never cut)")
    ap.add_argument("--train-layers", type=int, default=4,
                    help="depth of the trained model (width is never cut)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[chip_smoke] no CUDA device: this script runs on the card")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"[chip_smoke] {src / 'repro_torch'} not found: run "
                         f"from a checkout of the repository")
    sys.path.insert(0, str(src))
    # A fresh autotune cache for the run: no plan a user's cache holds may
    # steer the paths held to the kernels' own tilings.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "ss_autotune.json")
        return run(args, torch, t_start)


def run(args, torch, t_start: float) -> int:
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    report = build.build()
    # each entry function (mangled name) with its registers, spills and
    # shared memory, in ptxas's order
    regs = {n: [re.sub(r"^ptxas info\s*: ", "", ln.strip())
                for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "entry function" in ln]
            for n, r in report.items()}
    log(f"built {sorted(report)} in {time.perf_counter() - t0:.1f}s "
        f"(parallel nvcc, sm_90a); ptxas: {json.dumps(regs)}")

    def elapsed(done: str) -> None:
        log(f"{done}: {time.perf_counter() - t_start:.1f}s since the start")

    kernels = kernel_phase(torch, dev)
    elapsed("phase 2")
    model_phase(torch, dev)
    grad_phase(torch, dev)
    elapsed("phase 3 at c = 64")
    wide_c_model_checks(torch, dev)
    elapsed("phase 3")
    served = serve_phase(torch, dev, args.layers)
    elapsed("phase 4")
    trained, full_ms, full_peak, full_losses = train_phase(torch, dev, args.train_layers,
                                                           TRAIN_STEPS)
    auto, auto_ms, auto_peak, _ = train_phase(torch, dev, args.train_layers, TRAIN_STEPS,
                                              remat="auto", round_trip=False)
    dots, dots_ms, dots_peak, _ = train_phase(torch, dev, args.train_layers, TRAIN_STEPS,
                                              remat="dots", round_trip=False)
    traced, traced_ms, _, traced_losses = train_phase(torch, dev, args.train_layers,
                                                      TRAIN_STEPS, round_trip=False,
                                                      telemetry=True)
    elapsed("train remat full / auto / dots / telemetry")
    tuned, train_plan = train_autotune_phase(torch, dev, args.train_layers, full_losses)
    bert = train_paper_bert_phase(torch, dev)
    chunked = train_chunked_phase(torch, dev, args.train_layers)
    elapsed("train_autotune, train_paper_bert, train_chunked")
    hymba = train_hymba_phase(torch, dev)
    deepseek = train_deepseek_phase(torch, dev)
    whisper = train_whisper_phase(torch, dev)
    llava = train_llava_phase(torch, dev)
    xlstm = train_xlstm_phase(torch, dev)
    elapsed("train_hymba ... train_xlstm")
    sp = sp_phase(torch, dev)
    elapsed("the ranks' phases")
    autotuned_rows(torch, dev, kernels, train_plan, served.pop("_decode_plan"))
    if traced_losses != full_losses:
        raise AssertionError(f"train telemetry: losses {traced_losses} differ from the run "
                             f"without telemetry {full_losses}")
    log(f"train: remat full {full_ms:.1f} ms per step, peak {full_peak:.2f} GiB; remat "
        f"auto (ss_stats) {auto_ms:.1f} ms per step, peak {auto_peak:.2f} GiB; remat "
        f"dots {dots_ms:.1f} ms per step, peak {dots_peak:.2f} GiB; remat full with "
        f"telemetry {traced_ms:.1f} ms per step, losses identical to the run without")
    paths = dict(served, train=trained, train_remat_auto=auto, train_remat_dots=dots,
                 train_telemetry=traced, train_autotune=tuned, **bert, **chunked, **hymba,
                 **deepseek, **whisper, **llava, **xlstm, **sp)
    for k in kernels:
        # K5' launches through K5's wrapper and counter: no path of its own
        k["launches_by_path"] = {path: counts.get(k["name"], 0)
                                 for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    log(f"total {time.perf_counter() - t_start:.1f}s")

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
