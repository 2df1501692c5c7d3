#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --multi-card   # only the phases across cards

Builds the port's CUDA kernels from the sources in the checkout.  First
the LM serving path: the flash-attention kernel against its plain
version and timed (phase ``flash_grid``: B * H = 65,540 batch-heads on the
CUDA-core route against the plain version, a tensor-core call in chunks
of 2 query tiles bit-equal to one launch), qwen2.5-3b at full width
(random init) served through
``repro_torch.launch.steps`` — four prompts of 2048 tokens through
``make_prefill_step`` (the flash launch count set to 0 just before it),
16 greedy decode steps — and the float32 gate of the kernel route
against the plain route; then the same for the moe and ssm families:
``lm_moe_serve`` (dbrx-132b at full width, its depth cut from 40 layers
to 8: the flash kernel at its group of 6, once a layer in prefill, and
the share of (token, slot) assignments the MoE capacity drops),
``lm_moe_check`` (2 layers in float32), ``lm_ssm_serve`` and
``lm_ssm_check`` (mamba2-2.7b whole, no flash launch); then the hybrid,
audio and vlm families, each whole: ``lm_hybrid_serve`` /
``lm_hybrid_check`` (zamba2-7b: the flash kernel once a shared-block
application, 27), ``lm_audio_*`` (whisper-medium, 1,500 audio frames and
416 prompt tokens: 24 encoder, 24 decoder and 24 cross launches) and
``lm_vlm_*`` (llama-3.2-vision-11b, 1,601 image patches: 32 self and 8
cross launches), the zero-initialised LoRA b and gates drawn non-zero
first; ``time_flash`` at each of their serve shapes.  Then the training
path: ``train_check`` (the flash kernel's autograd Function -- the kernel
forward, the plain version's chunked backward -- against the plain
version's autograd at minicpm-2b's training shape, f32 and bf16, one
backward timed; minicpm-2b at full width cut to 2 layers in f32, one
step's loss and gradients on the kernel route against the plain route),
``train_step`` (minicpm-2b whole, 8 x 4,096 tokens a step in
micro-batches of 2, remat, AdamW, WSD, through
``launch.steps.make_train_step``: the flash launch count set to 0 before
each timed step, 320 a step; step seconds, tokens/s, the model-FLOP
share, peak memory, a traced step's busy share, falling losses) and
``train_cli`` (the train CLI for 6 steps and again for 9, resuming from
its own checkpoint; a bit-exact kill-and-resume at 2 layers; the
resilient loop's retry of a step that fails after its update with no
checkpoint on disk, bit-equal to a clean run, and the cost of its
pre-step host snapshot).  Then the sharded LM paths, ``lm_shard_check``:
a rank of this script (``--shard-rank``) on card 0 over NCCL at mesh (1,
1), a sharded minicpm-2b train step (2 layers, f32) against the
single-process step and qwen2.5-3b serving (2 layers, f32, 4 x 512
prompt tokens, 8 decode steps over the sharded cache) against one
process; then the moe and ssm families, their state created shard by
shard: dbrx-132b at full width in f32, one Adafactor step at 1 layer and
serving at 2, and mamba2-2.7b at full width, 2 layers in f32, one AdamW
step and serving; then the hybrid, audio and vlm families, the LoRA b
and gates drawn non-zero: zamba2-7b cut to one unit and whisper-medium
whole, one AdamW step each, and llama-3.2-vision-11b cut to one unit,
one Adafactor step, each with serving (whisper's 1,500 frames in a cross
cache along the frames, the vlm's 1,601 patches on kv heads where the
model axis does not divide them), each against one process (the loss
within 1e-6 relative, the routed and dropped counts summed over the
ranks equal, creation's peak above the local state by at most one leaf
drawn whole); each rank's flash launches by route equal to one
process's, none in an ssm run (four ranks at meshes (2, 2) and (1, 4)
with ``--multi-card``: gloo cannot carry DTensor's all-gather on CUDA
tensors); and ``examples``, the port's two LM examples (``activations_ccm``:
its CCM through ``knn_topk`` and ``ccm_lookup``; ``train_lm``: a falling
loss).  Then it holds
each EDM kernel against its plain PyTorch version on the card at the
shapes of the paths that run it, drives two paths of ``repro_torch.launch.edm_run`` at
the series length and E_max of the paper's Fish1_Normo recording — the
main path (the causal map) and the significance path (map, convergence
statistics, surrogate p-values and BH-FDR edges) — and then each again
in column tiles (``--target-tile``: the tiled map and store byte for byte
the untiled ones, with peak device memory beside them), the all-E
phase 2 (``--no-bucketed``, untiled and tiled) and the map with the
bfloat16 distance accumulator — each path with the kernel launch counts
set to 0 just before it and read just after, checks them against the
plain-version engine, and times every kernel (both accumulators of the
kNN kernels) with CUDA events beside its bound, its plain version and
(where one exists) one PyTorch library call computing the same
function.  Then the EDM kernels' wide routes: phase ``wide_tables``
(``knn_topk`` at k 48, 96 and 128 and at E_max 40, ``knn_topk_prefix``
at the same k and at E_max 40 with 70 library sizes, ``ccm_lookup`` at
the same k, with 150 segments and just past its two staged target rows:
tables bit-equal to the plain versions in both accumulators, the lookup
within 1e-6 max|Y|, each timed beside its bound, its plain version and
its launches a call; the map at E_max 40 on ``cuda``, counts set to 0
just before it, against ``torch-reference``) and phase
``long_recording`` (a map of 32 series of 36,020 frames, Lp 36,000,
whole on ``cuda`` with its counts; one series' tables and a chunk's
lookup against the plain versions; the lookup at Lp 36,000 beside
``F.embedding_bag``).  Then past 128 neighbours, the kNN kernels'
key-select route: phase ``deep_tables`` (``knn_topk`` at phase 1's shape
at k 160, 256 and 715 -- k == Lc, the self excluded, ending in (+inf,
self) --, in bf16 at k 256, at phase 2's shape over four buckets at k
200, on one library shard at k 160 and at E_max 160 / k 161;
``knn_topk_prefix`` at k 160 and 256 over five library sizes in both
accumulators; ``ccm_lookup`` at k 160 and 256 beside
``F.embedding_bag`` and at Lp 36,000 on one staged row: each bit-equal
to its plain version, the lookup within 1e-6 max|Y|, timed beside its
bound; the map at k_override 200 on ``cuda``, its counts set to 0 just
before it, against ``torch-reference``).

Before the fleet, the kNN selection bench's path: the slab kernel
(``kernels/knn_slab``, the port of the bench's dense-slab Pallas kernel)
against its plain version bit for bit (ragged Lq and Lc, both
``exclude_self`` settings, tied and constant series, k above the valid
candidates with its 3.0e38 entries, k 64) and against ``knn_topk``
where k fits, then a case for each of its routes (the threshold filter
with the row in shared memory and with its tail in the device
workspace; the exact search where the candidates overflow, k above the
buffer, k == Lc_pad), each case's route counts read from the kernel's
device counters; phase ``bench_knn``, the port's ``knn`` bench
(``repro_torch.bench.run``) at Lq 128, E_max 20, k 21 and Lc up to
64,000 on both engines, every launch and route count set to 0 just
before it, with each kernel's CUDA-event time and the slab's routes
beside the slab's plain version and bound;
phase ``bench_gate``, the bench's ``--check`` regression gate at
``--tiny`` (``build/smoke_bench_gate/``: the baselines written, a check
against them passing, one against an empty directory skipping, one
against a field divided by 10 retrying and exiting nonzero);
and phase ``dryrun``, ``repro_torch.launch.edm_dryrun`` for Fish1_Normo
and Subject11 at their own N and L (one chunk each: peak device memory,
seconds, roofline terms, the whole run extrapolated; JSONs in
``build/dryrun/``).

Last, the fleet (``edm_run --workers``, ``launch/edm_fleet.py``): W
worker processes share the card, each with its own CUDA context (the
card's compute mode is printed; what this process holds on the card is
released first).  Phases ``fleet_main`` (the main path with two
workers, its map byte-equal to the single-process map of
``end_to_end``, the card's busy share sampled beside the single
process's), ``fleet_significance`` (two workers at the significance
path's N, all five artifacts byte-equal to the single-process store),
``fleet_kill`` (three workers, units of 5 rows, ``w0`` SIGKILLed once a
block is durable and relaunched under its id) and ``fleet_faults``
(``--workers 3 --unit-rows 5`` with ``EDM_FAULTS=tile_pre_rename:crash@2``
armed in every first-generation worker; the supervisor relaunches each
without it): each store byte-equal to the single-process one, complete
by ``edm_fleet status``, clean by ``fsck``, no lease left.  The launch
counts are per process: each worker's last line carries its own, and
the summed counts must equal the single-process ones where no process
died; each worker's phase-2 seconds and peak device memory are printed
beside them.  The kernels line's ``launches_fleet`` holds each run's sum,
the kill and fault runs' under ``kill_survivors`` / ``faults_survivors``:
the sums of the processes that finished, since one that was killed or
crashed prints no done line.  The fleets' logs go to ``build/smoke_fleet_logs/``.

Several device slots and the library-sharded kNN (``runtime/platform.py``,
``core/pipeline.py``): ``check_knn`` cases of ``knn_topk``'s column range
(a shard at an offset, a padded last shard, a shard wholly past Lc,
exclude_self across three shards whose merge equals the unsharded
table; both accumulators); ``multi_device_main`` (the main path over
``EDM_LOCAL_DEVICE_IDS=0,0``, two row slots on card 0, and over every
visible card where there are several: data.npy byte-equal to
``end_to_end``'s, fsck clean, the same launches, each card's sampled busy
share; a speedup only where two cards ran); ``multi_device_significance``
(two slots, the five artifacts byte-equal to ``significance``'s);
``sharded_knn`` (Subject11's length, L 8,528: 1, 2, 4 and 8 simulated
shards and one a visible card, each bit-equal to the unsharded kernel
table, with build and merge times); ``distributed`` (two ranks joined
through the EDM_* contract, each with a time limit: on gloo with both on
card 0, the tables staged through host memory; NCCL's refusal of two
ranks on one card; NCCL with a card a rank where two are visible, else
said so on the line).

Rows across ranks (``runtime/ranks.py``), after the fleet: phases
``ranks_main`` (``edm_run`` at the main path's N as two ranks sharing
card 0, on gloo as ``edm_run`` joins its ranks: data.npy byte-equal to the
one-process run of the same call, fsck clean, the launches summed over
the ranks' ``rank r/W done`` lines equal to the one process's, the
card's sampled busy share, each rank's rows and seconds) and
``ranks_significance`` (the same at the significance path's N, all five
artifacts byte-equal); ``engine_check_cli`` (``python -m
repro_torch.engine.check --engine cuda``) and ``extensions``
(``ccm_lagged`` through ``knn_topk`` equal to its plain route on the
card, the S-Map sweep on the card within 1e-5 of the CPU).  With
``--multi-card``, ``ranks_cards``: one gloo rank a card over every
visible card at the main path's N, against card 0 alone, with each
card's busy share; and last ``lm_shard_check`` on four ranks and
``lm_shard_multi``: four NCCL ranks, a card each, minicpm-2b whole
trained at mesh (2, 2) (FSDP and TP; step s, tokens/s, the 6NT share,
peak memory a card, each card's busy share, the first loss against one
card's), qwen2.5-3b whole served at mesh (1, 4) (prefill s, decode ms a
step, peak a card), dbrx-132b whole (40 layers, bf16, created shard by
shard) served at (1, 4) (the share of assignments dropped) and trained
at (1, 4) at 8 layers (Adafactor, remat; the 6NT share of its active
parameters), mamba2-2.7b whole trained at (2, 2) and served at (1, 4),
zamba2-7b, whisper-medium and llama-3.2-vision-11b whole served at (1,
4), zamba2-7b and llama-3.2-vision-11b whole trained at (2, 2) (bf16,
AdamW, remat, 4 x 4,096 tokens; the vlm's ~117 GB of state fits only
across cards).  The ranks' logs go to
``build/smoke_ranks_*/`` and ``build/smoke_shard_*/``.

The telemetry trio (``runtime/history.py``, ``trace.py``,
``autotune.py``): every ``edm_run`` of the smoke records its telemetry
(the default sink) and its summary in one run history
(``build/smoke_history.jsonl``, EDM_HISTORY).  Phase ``autotune`` (after
the tiled main path) runs the map at 2,048 with telemetry off and on in
turns, with ``--autotune`` and under the tuned shapes (``--tune-from``),
every map byte-equal, and prints the telemetry cost, the tuned run's
launches and peak memory, the recommendation with its evidence, and the
memory the main path's own store's recommendation would need (by the
peak's slope in library rows), and runs that recommendation at the main
path's N under the cap ``--autotune`` prints (a chunk fitted to the
card's free memory): the map byte-equal to the main path's, the peak
below the card's memory.  Phase ``fleet_trace``
runs ``edm_fleet trace --json --reconcile`` over the ``fleet_main``
store (every stage's six buckets and its critical-path unit, each
stage within 1% of ``fleet_status``); ``fleet_watch`` is ``edm_fleet
status --watch`` beside ``fleet_significance``; ``trends`` (after the
ranks) finalizes the significance store again, which must replace its
history record, and reads the history through ``edm_fleet trends``.

Every phase prints one JSON line, its ``t_s`` the seconds since the
script started; the line before the last is the card's
name and power limit as nvidia-smi gives them, the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
so does a machine without a CUDA card, or a directory holding this file
and nothing else of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Fish1_Normo (the paper's smallest recording): L = 1450, E_max = 20.
FISH1_L, E_MAX = 1450, 20
# Subject11: the paper's longest library, L = 8528.
SUBJECT11_L = 8528
LIB_BLOCK = 8
TARGET_BLOCK = 2048
CHECK_N = 256  # series of the cuda vs torch-reference engine checks
PROFILE_N = 512  # series of the profiled runs of both paths
# The significance path: the repo's default library sizes up to Lp = 1430
# and surrogate count, the surrogates' null model and the FDR level.
SIG_LIB_SIZES = (100, 200, 400, 800, 1430)
SIG_M, SIG_CHECK_M = 20, 9
NEAR_TIE = 1e-6  # |difference| below which a comparison may round either way
# The tiled and all-E phase 2 and the tiled significance stage: the main
# path's map again in column tiles of 4,096 targets; the all-E layout
# (--no-bucketed) at N = 2,048, untiled and in tiles of 512; the
# significance path in tiles of 512; the bfloat16 accumulator's map at
# N = 2,048.  Subject11: N = 101,729 series.
MAIN_TILE, SIG_TILE = 4096, 256
# The tiled phases run at the untiled paths' N (--n, --sig-n), each
# against that path's store: the map in two tiles of 4,096 a row, the
# significance path in four tiles of 256 a row.
ALL_E_N, ALL_E_TILE, BF16_N = 2048, 512, 2048
# The autotuner's phase: N 2,048; the peak's slope in library rows
# measured from lib_block 8 to 128.
AUTOTUNE_N, SLOPE_LIB_BLOCK = 2048, 128
SUBJECT11_N = 101729

# The LM serving path: qwen2.5-3b at full width (36 layers, d 2048, 16 / 2
# heads of 128, d_ff 11008, vocab 151,936 padded to 152,064), random
# init; four requests of 2048 prompt tokens, 16 greedy decode steps (32
# until the wide EDM phases came: the smoke's time limit).
LM_ARCH = "qwen2.5-3b"
SERVE_B, SERVE_S, DECODE_STEPS = 4, 2048, 16
# The moe and ssm families, the same requests: dbrx-132b at full width (d
# 6144, 48 / 8 heads of 128, 16 experts top-4 of d_ff 10,752, vocab
# 100,352), its depth cut from 40 layers to 8 (the whole model is ~264 GB
# in bf16, more than one card holds; 8 layers are ~54.6 GB) and to 2 for
# the float32 gate (~31 GB); mamba2-2.7b whole (64 layers, d 2560, 80 SSD
# heads of 64, state 128, vocab 50,280 padded to 50,432; ~5.7 GB in bf16,
# ~11.3 GB in float32).
MOE_ARCH, MOE_SERVE_LAYERS, MOE_CHECK_LAYERS = "dbrx-132b", 8, 2
SSM_ARCH = "mamba2-2.7b"
# The hybrid, audio and vlm families, each whole, the same B and decode
# steps: zamba2-7b (81 layers: 54 Mamba2 blocks, 27 applications of one
# shared block of 32 heads of 112; 4.74 B parameters, 9.48 GB in bf16) and
# llama-3.2-vision-11b (40 layers, 8 of them behind a gated cross block over
# 1,601 image patches; 9.78 B, 19.55 GB) at 2,048 prompt tokens;
# whisper-medium (24 + 24 layers over 1,500 audio frames; 0.88 B) at 416
# prompt tokens, its text context of 448 less 32 for decode steps.  Audio
# frames and image patches are 0.1 N(0, 1) from a seeded generator on the
# card.  The float32 gates draw the zero-initialised LoRA b and gates
# non-zero first (ZERO_LEAVES), so that no branch hides behind a zero.
HYBRID_ARCH, AUDIO_ARCH, VLM_ARCH = "zamba2-7b", "whisper-medium", "llama-3.2-vision-11b"
AUDIO_PROMPT = 416
ZERO_LEAVES = ("b_q", "b_k", "b_v", "gate_attn", "gate_mlp")
# Flash kernel vs its plain version.  float32 (the CUDA-core route),
# |got - want| <= atol + rtol |want|: sums in another order (softmax over
# up to 2048 keys).  bfloat16 on the CUDA-core route: within one bf16 step
# of the plain version's bf16 output, |got - want| <= 1e-6 + 2^-7 |want|.
# bfloat16 on the tensor-core route: it rounds p to bf16 before p v, as
# every such kernel does, so it is held to the plain version's float32
# result (before its final rounding): its max abs error within twice that
# of one library call (F.scaled_dot_product_attention) on the same inputs
# and within an absolute ceiling for unit-normal inputs; and element by
# element within one bf16 step of |want| plus twice the library's max abs
# error in the same (batch, query, head) row, so that a row with a small
# output (late causal rows, ~2048 keys) is held to its own error level.
FLASH_TOL_F32 = (2e-5, 2e-5)
# The kernel with per-row positions (q_pos), at one rank's shapes of
# sequence-parallel attention: minicpm-2b's prefill_32k (36 heads, MHA, dh
# 64) over a model axis of 16 (2,048 of 32,768 rows a rank) and
# smollm-135m's (9 heads, 3 kv heads) over 4 (8,192 rows), chunks of
# 1,024 (striped: 64 and 256 rows of each chunk); B 1.
# name, B, S (the whole sequence), H, K, dh, n (model axis), chunk
FLASH_POSITIONS = (
    ("minicpm-2b_prefill_32k_model16", 1, 32768, 36, 36, 64, 16, 1024),
    ("smollm-135m_prefill_32k_model4", 1, 32768, 9, 3, 64, 4, 1024),
)
FLASH_TOL_BF16_CUDA_CORE = (1e-6, 2.0 ** -7)
FLASH_BF16_LIBRARY_FACTOR, FLASH_BF16_CEILING = 2.0, 0.04
FLASH_BF16_STEP = 2.0 ** -7
# The full-width float32 gate, kernel route vs plain route: max |logit
# difference| (logits are O(1); an attention fault moves them O(0.1)).
LM_GATE_TOL = 1e-3
# The training path: minicpm-2b whole (40 layers, d 2,304, 36 heads of 64
# (MHA), d_ff 5,760, vocab 122,753 padded to 122,880, tied embeddings,
# 2.72 B parameters) in bf16 on attn_impl "chunked" (the flash kernel's
# tensor-core route at dh 64 in every forward and remat recompute), remat,
# AdamW with float32 moments, MiniCPM's WSD schedule; train_4k's sequence
# length of 4,096, a global batch of 8 in micro-batches of 2 (four a
# step), one warm-up step and four timed steps on one repeated batch.  The
# checks cut only its depth (2 layers) and batch (2).  The flash Function's
# gradients are held to the plain version's autograd: float32 within
# FLASH_TOL_F32, bfloat16 by the forward's tensor-core rule with SDPA's
# backward as the library; the float32 2-layer model's loss and every
# gradient on the kernel route within TRAIN_GATE_TOL (relative to the
# leaf's max |want|) of the plain route's.
TRAIN_ARCH = "minicpm-2b"
TRAIN_B, TRAIN_S, TRAIN_MICRO, TRAIN_TIMED = 8, 4096, 2, 4
TRAIN_CHECK_B, TRAIN_CHECK_LAYERS = 2, 2
TRAIN_GATE_TOL = 1e-3
# the CLI's run: smollm-135m (the JAX system test's arch), 6 steps and then
# 9 on the same checkpoint directory; the kill-and-resume: 2 x 512 tokens
TRAIN_CLI_ARGS = ("--arch", "smollm-135m", "--batch", "8", "--seq", "1024",
                  "--save-every", "3", "--log-every", "1")
RESUME_B, RESUME_S = 2, 512
# The LM dry run (``launch/dryrun.py``: one step on fake tensors over a
# fake world, no card) of production cells at 16 x 16 (DRY_CELLS: arch,
# cell, optimized) and of ``train_step``'s own setup at a world of one,
# one after another in one process of their own, run by ``lm_dryrun``
# after ``train_step`` while nothing else runs (the card's host may have a
# single core: beside a timed phase they would slow it).  The world of
# one is held to the card: its predicted peak within DRY_PEAK_TOL of
# ``max_memory_allocated``, its operations within DRY_FLOPS_TOL of
# ``FlopCounterMode`` over one real step, and its roofline time (the
# largest of its terms) no longer than the fastest measured step: a bound.
# ``--multi-card`` holds the dry run of the same step at (2, 2) to rank 0
# of the real NCCL step.
DRY_CELLS = (("minicpm-2b", "prefill_32k", True), ("qwen2-1.5b", "train_4k", False))
DRY_PEAK_TOL, DRY_FLOPS_TOL = 0.15, 1e-3
DRY_TIMEOUT_S = 900
# A training step's dry run traces one and two layers and extrapolates to
# the full depth (``launch/dryrun.py``): the same counts and peak as the
# full depth (minicpm-2b's 40-layer world of one traced 48-53 s on the
# card's host).  A prefill runs at full depth: its peak, read from storages
# freed as Python frees them, is not linear in the depth.


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - T_START}), flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def same_bits(torch, a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def finite_max_abs(torch, a, b) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(torch.equal(torch.isfinite(a), torch.isfinite(b))):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def lag_batch(torch, ts_np, Lp, dev):
    from repro_torch.core import embedding

    x = torch.as_tensor(ts_np).to(dev)
    return embedding.lag_matrix(x, E_MAX, 1, Lp).contiguous()


def check_knn(torch, name, Vq, Vc, k, exclude_self, select_Es,
              dist_dtype="float32", col_offset=0, col_hi=None):
    """Kernel vs plain version on the card: idx equal, dist bit-equal
    (both with the float32 or the bfloat16 accumulator; with a column
    range, one library shard's tables)."""
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    rng = dict(col_offset=col_offset, col_hi=col_hi)
    ki, kd = knn_topk(Vq, Vc, k, exclude_self, select_Es, dist_dtype=dist_dtype,
                      **rng)
    torch.cuda.synchronize()
    ri, rd = knn_topk_ref(Vq, Vc, k, exclude_self, select_Es,
                          dist_dtype=dist_dtype, **rng)
    idx_eq = bool(torch.equal(ki, ri))
    bits_eq = same_bits(torch, kd, rd)
    err = finite_max_abs(torch, kd, rd)
    emit("check_knn", case=name, shape=list(Vq.shape) + [Vc.shape[-1]], k=k,
         exclude_self=exclude_self, select_Es=list(select_Es),
         dist_dtype=dist_dtype, col_offset=col_offset, col_hi=col_hi,
         masked_entries=int(torch.isinf(kd).sum()), idx_equal=idx_eq,
         dist_bits_equal=bits_eq, max_abs_err=err)
    if not (idx_eq and bits_eq):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"knn_topk kernel != plain version ({name}); first "
                             f"differing idx positions {bad}")
    return err


def check_knn_prefix(torch, name, Vq, Vc, k, exclude_self, buckets, lib_sizes,
                     col_ids, dist_dtype="float32"):
    """Prefix kernel vs plain version on the card: idx equal, dist
    bit-equal (float32 or bfloat16 accumulator)."""
    from repro_torch.kernels.knn_topk.ops import knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref

    ki, kd = knn_topk_prefix(Vq, Vc, k, exclude_self, buckets, lib_sizes,
                             col_ids=col_ids, dist_dtype=dist_dtype)
    torch.cuda.synchronize()
    ri, rd = knn_topk_prefix_ref(Vq, Vc, k, exclude_self, buckets, lib_sizes,
                                 col_ids=col_ids, dist_dtype=dist_dtype)
    idx_eq = bool(torch.equal(ki, ri))
    bits_eq = same_bits(torch, kd, rd)
    err = finite_max_abs(torch, kd, rd)
    emit("check_knn_prefix", case=name, shape=list(Vq.shape) + [Vc.shape[-1]],
         k=k, exclude_self=exclude_self, buckets=list(buckets),
         lib_sizes=list(lib_sizes), permuted=col_ids is not None,
         dist_dtype=dist_dtype, idx_equal=idx_eq, dist_bits_equal=bits_eq,
         max_abs_err=err)
    if not (idx_eq and bits_eq):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"knn_topk_prefix kernel != plain version ({name}); "
                             f"first differing idx positions {bad}")
    return err


def check_slab(torch, name, Vq, Vc, k, exclude_self, against_topk=False,
               expect_big=None, expect_route=None):
    """Slab kernel vs its plain version on the card: idx equal, dist bit-equal,
    the 3.0e38 entries of a k above the valid candidates and their padding
    and self ids included; with ``against_topk`` also against the knn_topk
    kernel at every E (k <= the valid candidates there).  ``expect_big``:
    the number of 3.0e38 entries the case must return; ``expect_route``:
    the route ("filter" or "search") every (row, lag) selection must take.
    Returns (max_abs_err, the route counts of its launch)."""
    from repro_torch.kernels.knn_slab.ops import (knn_slab, reset_route_counts,
                                                  route_counts)
    from repro_torch.kernels.knn_slab.ref import BIG, knn_slab_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk

    reset_route_counts()
    ki, kd = knn_slab(Vq, Vc, k, exclude_self)
    torch.cuda.synchronize()
    routes = route_counts()
    ri, rd = knn_slab_ref(Vq, Vc, k, exclude_self)
    idx_eq = bool(torch.equal(ki, ri))
    bits_eq = same_bits(torch, kd, rd)
    err = finite_max_abs(torch, kd, rd)
    n_big = int((kd == BIG).sum())
    topk_eq = None
    if against_topk:
        ti, td = knn_topk(Vq[None], Vc[None], k, exclude_self,
                          tuple(range(1, Vq.shape[0] + 1)))
        topk_eq = bool(torch.equal(ki, ti[0])) and same_bits(torch, kd, td[0])
    emit("check_slab", case=name, E_max=Vq.shape[0], Lq=Vq.shape[1],
         Lc=Vc.shape[1], k=k, exclude_self=exclude_self, idx_equal=idx_eq,
         dist_bits_equal=bits_eq, max_abs_err=err, big_entries=n_big,
         padding_ids=int((ki >= Vc.shape[1]).sum()), equal_to_knn_topk=topk_eq,
         routes=routes, expect_route=expect_route)
    selections = Vq.shape[0] * Vq.shape[1]
    routed = (routes["filter"] + routes["search"] == selections
              and (expect_route is None or routes[expect_route] == selections))
    if not (idx_eq and bits_eq and topk_eq in (None, True)
            and expect_big in (None, n_big) and routed):
        raise AssertionError(f"knn_slab kernel != plain version or knn_topk, "
                             f"or a selection off its route ({name}): {routes}")
    return err, routes


def reset_launches():
    """Every kernel's launch count to 0."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.kernels.knn_slab.ops import knn_slab, reset_route_counts
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix

    knn_topk.LAUNCHES = knn_topk_prefix.LAUNCHES = ccm_lookup.LAUNCHES = 0
    knn_slab.LAUNCHES = 0
    reset_route_counts()
    flash_attn.ROUTE_LAUNCHES = dict.fromkeys(flash_attn.ROUTE_LAUNCHES, 0)


def read_launches() -> dict:
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.launch.edm_fleet import launch_counts

    return {**launch_counts(), "knn_slab": knn_slab.LAUNCHES}


def bench_knn(torch, dev, smi):
    """The port's kNN selection bench (``python -m repro_torch.bench.run
    knn``) at its card sizes, every launch count set to 0 just before it
    and read just after: both engines' streaming and slab tables at each
    Lc, paired repetitions, the slab == stream spot checks, the working
    sets, the slab kernel's route counts.  Then at each Lc the slab kernel
    against its plain version (bit-equal, its routes) and, with CUDA
    events, both kernels' times beside the slab's plain version and
    bound."""
    from repro_torch.bench import run as brun
    from repro_torch.core import embedding
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.knn_slab.ops import knn_slab, route_counts
    from repro_torch.kernels.knn_slab.ref import knn_slab_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.launch.roofline import bound_ms, knn_counts, slab_counts

    sizes = brun.SIZES["knn"]["card"]
    reset_launches()
    t0 = time.perf_counter()
    log = io.StringIO()  # the bench's CSV rows
    with contextlib.redirect_stdout(log):
        res = brun.knn_selection_bench(brun.Bench(dev, ROOT / "build" / "bench"),
                                       **sizes)
    wall = time.perf_counter() - t0
    launches = read_launches()
    routes = route_counts()
    if not (launches["knn_slab"] > 0 and launches["knn_topk"] > 0):
        raise AssertionError(f"the knn bench missed a kernel: {launches}")
    if not (res["spot_check_cuda"] and res["spot_check_torch_reference"]):
        raise AssertionError("knn bench: slab == stream spot check missing")
    E, Lq, k = sizes["E_max"], sizes["Lq"], sizes["k"]
    pair = torch.as_tensor(dummy_brain(2, max(sizes["Lc_sweep"]) + E + 1,
                                       seed=3)).to(dev)
    Vq = embedding.lag_matrix(pair[0], E, 1, Lq).contiguous()
    all_E = tuple(range(1, E + 1))
    kernel_times = {}
    err = 0.0
    for Lc in sizes["Lc_sweep"]:
        Vc = embedding.lag_matrix(pair[1], E, 1, Lc).contiguous()
        e, lc_routes = check_slab(torch, f"bench_Lc{Lc}", Vq, Vc, k, False)
        err = max(err, e)
        ms = time_ms(torch, lambda: knn_slab(Vq, Vc, k, False), 10)
        plain = time_ms(torch, lambda: knn_slab_ref(Vq, Vc, k, False), 3)
        stream = time_ms(torch, lambda: knn_topk(Vq[None], Vc[None], k, False,
                                                 all_E), 10)
        bound, by = bound_ms(*slab_counts(E, Lq, Lc, k))
        kernel_times[str(Lc)] = dict(
            kernel_ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
            share_of_bound=bound / ms, knn_topk_ms=stream,
            knn_topk_bound_ms=bound_ms(*knn_counts(1, E, E, Lq, Lc, k))[0],
            routes=lc_routes)
    out = dict(wall_s=wall, launches=launches, routes=routes, E_max=E, Lq=Lq, k=k,
               engines=res["engines"], phase1=res["phase1"],
               kernel_times=kernel_times, max_abs_err=err)
    emit("bench_knn", smi=smi, **out)
    return out


def dryrun_phase(torch, dev, smi):
    """``python -m repro_torch.launch.edm_dryrun`` for Fish1_Normo and
    Subject11 at their own N and L, one timed chunk each, the launch
    counts set to 0 just before each and read just after; the JSONs go to
    build/dryrun/ (the ``roofline`` bench reads them there)."""
    from repro_torch.configs.edm_datasets import DATASETS
    from repro_torch.launch import edm_dryrun

    out = {}
    d = ROOT / "build" / "dryrun"
    d.mkdir(parents=True, exist_ok=True)
    for name in ("fish1_normo", "subject11"):
        reset_launches()
        t0 = time.perf_counter()
        rep = edm_dryrun.dryrun(DATASETS[name], dev, chunks=1, seed=0)
        wall = time.perf_counter() - t0
        launches = read_launches()
        (d / f"{name}.json").write_text(json.dumps(rep, indent=1))
        keep = {k: rep[k] for k in (
            "N", "L", "chunk_rows", "n_chunks", "n_buckets",
            "lookup_launches_per_chunk", "setup_s", "chunk_s", "memory",
            "roofline", "roofline_whole_run", "whole_run_extrapolated_s",
            "chunk_share_of_bound", "rho_finite")}
        emit("dryrun", dataset=name, smi=smi, wall_s=wall, launches=launches,
             **keep)
        if not (rep["rho_finite"] and launches["knn_topk"] > 0
                and launches["ccm_lookup"] > 0):
            raise AssertionError(f"dry run of {name}: rho finite "
                                 f"{rep['rho_finite']}, launches {launches}")
        out[name] = dict(rep, launches=launches)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def same_npy_bits(a_path, b_path, rows=1024) -> bool:
    """Two stored float arrays (memmapped) equal bit for bit."""
    import numpy as np

    a, b = np.load(a_path, mmap_mode="r"), np.load(b_path, mmap_mode="r")
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.names is not None:  # the edge list: a structured array
        return a.tobytes() == b.tobytes()
    return all(np.array_equal(a[r : r + rows].view(np.uint32),
                              b[r : r + rows].view(np.uint32))
               for r in range(0, a.shape[0], rows))


def tied_lags(torch, dev, S, L, seed):
    """(S, E_MAX, L) lags quantised to quarter steps: many equal
    distances, and more once bfloat16 rounds them."""
    import numpy as np

    x = np.random.default_rng(seed).standard_normal((S, E_MAX, L))
    return torch.as_tensor((np.round(x * 4) / 4).astype(np.float32)).to(dev)


def run_cli(torch, dev, argv):
    """One run of the port's CLI with its progress lines kept off
    stdout (their last two are printed): (summary, launches by kernel,
    peak device bytes), the launch counts and the peak set to 0 just
    before it."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix
    from repro_torch.launch import edm_run

    knn_topk.LAUNCHES = knn_topk_prefix.LAUNCHES = ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        summary = edm_run.main(argv)
    for ln in log.getvalue().strip().splitlines()[-2:]:
        print(ln, flush=True)
    launches = {"knn_topk": knn_topk.LAUNCHES,
                "knn_topk_prefix": knn_topk_prefix.LAUNCHES,
                "ccm_lookup": ccm_lookup.LAUNCHES}
    return summary, launches, torch.cuda.max_memory_allocated(dev)


def phase_walls(summary) -> dict:
    return {k: summary[k] for k in ("wall_s", "phase1_s", "phase2_s", "assemble_s")}


def check_prng(torch, dev):
    """The port's threefry draws on the card equal the CPU's bit for bit
    (integer ops only; the uniforms compared as bits)."""
    from repro_torch.inference import prng

    n_cmp = 0
    for seed in (0, 1, 2**31 - 1):
        kc, kd = prng.prng_key(seed), prng.prng_key(seed, dev)
        ids = torch.arange(2048)
        pairs = {
            "split": (prng.split(kc, 20), prng.split(kd, 20)),
            "fold_in": (prng.fold_in(kc, ids), prng.fold_in(kd, ids.to(dev))),
            "bits": (prng.random_bits(kc, 8508), prng.random_bits(kd, 8508)),
            "uniform": (prng.uniform(prng.split(kc, 20), 726, 0.0, prng.TWO_PI_F32),
                        prng.uniform(prng.split(kd, 20), 726, 0.0, prng.TWO_PI_F32)),
            "permutation_1430": (prng.permutation(kc, 1430), prng.permutation(kd, 1430)),
            "permutation_8508": (prng.permutation(kc, 8508), prng.permutation(kd, 8508)),
        }
        for what, (a, b) in pairs.items():
            b = b.cpu()
            same = (same_bits(torch, a, b) if a.dtype == torch.float32
                    else bool(torch.equal(a, b)))
            if not same:
                raise AssertionError(f"prng {what} (seed {seed}) differs between "
                                     "the card and the CPU")
            n_cmp += a.numel()
    emit("check_prng", seeds=[0, 1, 2**31 - 1], values_compared=n_cmp, equal=True)


def sig_near_ties(torch, ts, optE, rho, cfg, sig, dev):
    """(trend, p) near-tie masks (N, N) of a significance run: pairs whose
    rho curve has two sizes within NEAR_TIE, or whose null rho lies
    within NEAR_TIE of the observed rho for some surrogate — computed in
    chunks with the plain engine."""
    import numpy as np

    from repro_torch.core import ccm
    from repro_torch.inference import convergence
    from repro_torch.inference.pipeline import SignificanceChunkRunner

    r = SignificanceChunkRunner(ts, optE, cfg, sig, device=dev)
    inv = np.argsort(r.order)
    seg = tuple(enumerate(r.plan.counts))
    seg_m = tuple((b, c * r.m) for b, c in seg)
    S = len(sig.lib_sizes)
    iu = np.triu_indices(S, 1)
    trend_tie = np.zeros((r.N, r.N), bool)
    p_tie = np.zeros((r.N, r.N), bool)
    for row0 in range(0, r.N, cfg.lib_block):
        rows = r.rows(row0, cfg.lib_block)
        cidx, cw = convergence.conv_block_tables(rows, cfg, r.plan, sig.lib_sizes,
                                                 r.col_ids)
        curves = torch.stack([
            ccm.ccm_row_lookup_bucketed(cidx[:, s], cw[:, s], r.fut_sorted, cfg, seg)
            for s in range(S)
        ]).cpu().numpy()[..., inv]
        gaps = np.abs(curves[iu[1]] - curves[iu[0]])
        trend_tie[row0 : row0 + rows.shape[0]] = (gaps <= NEAR_TIE).any(0)
        fidx, fw = ccm.ccm_row_tables_bucketed(rows, cfg, r.plan)
        null = ccm.ccm_row_lookup_bucketed(fidx, fw, r.fut_surr, cfg, seg_m)
        null = null.cpu().numpy().reshape(rows.shape[0], r.N, r.m)[:, inv]
        obs = np.asarray(rho[row0 : row0 + rows.shape[0]])
        p_tie[row0 : row0 + rows.shape[0]] = (
            np.abs(null - obs[..., None]) <= NEAR_TIE).any(-1)
    return trend_tie, p_tie


def check_lookup(torch, name, idx, w, Y, segs=None):
    """Kernel vs plain version: |diff| <= 1e-6 * max|Y| (see docs/PORT.md);
    ``segs`` ((table_row, count), ...) for the segmented form."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref

    got = ccm_lookup(idx, w, Y, segs)
    torch.cuda.synchronize()
    want = ccm_lookup_ref(idx, w, Y, segs)
    err = float((got - want).abs().max())
    tol = 1e-6 * float(Y.abs().max())
    emit("check_lookup", case=name, idx_shape=list(idx.shape), B=Y.shape[0],
         Lp=Y.shape[1], segments=None if segs is None else len(segs),
         max_abs_err=err, tol=tol, bit_equal=same_bits(torch, got, want))
    if not err <= tol:
        raise AssertionError(f"ccm_lookup kernel != plain version ({name}): "
                             f"{err} > {tol}")
    return err


def _device_time_by_kernel(prof):
    """[(device us, kernel name, calls)] from a finished profile, largest
    first.  Kernels run on one stream, so their device times add up
    without overlap."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # CPU ops also carry their kernels' device time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.key, ev.count))
    return sorted(rows, reverse=True)


def profile_busy(torch, run, top=8, cpu=True):
    """Wall time, device-busy share and the ``top`` device kernels of one
    traced call of ``run``; ``cpu=False`` traces the device alone (a
    training step's host events take the profiler a minute to sort)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if cpu else []
    torch.cuda.synchronize()
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_time_by_kernel(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    return dict(wall_s=wall, device_busy_s=busy_s, device_busy_share=busy_s / wall,
                top=[{"name": k[:90], "device_s": us / 1e6, "calls": c}
                     for us, k, c in rows[:top]])


def profile_paths(torch, dev, n, smi):
    """Trace one in-process run of each path (no store) with
    torch.profiler: the main path (the map), then the significance stage
    on that map.  Emits per path the device's busy share of the wall
    time and the device time by kernel."""
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig, run_significance

    ts = dummy_brain(n, FISH1_L, seed=5)
    cfg = EDMConfig(E_max=E_MAX)
    sig = SignificanceConfig(lib_sizes=SIG_LIB_SIZES, n_surrogates=SIG_M,
                             alpha=0.05, seed=0)
    warm = run_causal_inference(ts[: 2 * LIB_BLOCK], cfg, device=dev)
    run_significance(ts[: 2 * LIB_BLOCK], warm.optE, warm.rho, cfg, sig, device=dev)
    torch.cuda.synchronize()
    timings: dict = {}
    out = {}
    for phase, run in (
        ("profile", lambda: out.update(
            cmap=run_causal_inference(ts, cfg, device=dev, timings=timings))),
        ("profile_significance", lambda: run_significance(
            ts, out["cmap"].optE, out["cmap"].rho, cfg, sig, device=dev)),
    ):
        busy = profile_busy(torch, run, top=12)
        extra = timings if phase == "profile" else {
            "surrogates": SIG_M, "lib_sizes": list(SIG_LIB_SIZES)}
        emit(phase, N=n, L=FISH1_L, **extra, **busy, smi=smi)


def profile_phase2(torch, dev, ts, optE, smi):
    """Phase 2 of the main path at the smoke's N, traced with
    torch.profiler (device activity only, so the host keeps its pace):
    the device time of the lookup launches summed from the trace, beside
    the kNN launches and everything else (the Pearson after each lookup
    leads the rest), and the device's busy share of phase 2."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ccm
    from repro_torch.core.pipeline import Phase2Runner
    from repro_torch.core.types import EDMConfig

    cfg = EDMConfig(E_max=E_MAX)
    N = ts.shape[0]
    ts_fut = ccm.all_futures(torch.as_tensor(ts), cfg).numpy()
    rho = np.zeros((N, N), np.float32)
    plan = [(r, min(cfg.lib_block, N - r)) for r in range(0, N, cfg.lib_block)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        Phase2Runner(ts, ts_fut, optE, cfg, dev).run(plan, rho=rho)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"ccm_lookup": [0.0, 0], "knn_topk": [0.0, 0], "other": [0.0, 0]}
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        g = ("ccm_lookup" if "ccm_lookup_kernel" in ev.key else
             "knn_topk" if "knn_topk_kernel" in ev.key else "other")
        groups[g][0] += us / 1e6
        groups[g][1] += ev.count
        rows.append((us, ev.key, ev.count))
    busy = sum(v[0] for v in groups.values())
    if not (np.isfinite(rho).all() and groups["ccm_lookup"][1] > 0):
        raise AssertionError("traced phase 2 ran no lookup or gave non-finite rho")
    emit("profile_phase2", N=N, L=ts.shape[1], wall_s=wall, device_busy_s=busy,
         device_busy_share=busy / wall,
         device_s={g: v[0] for g, v in groups.items()},
         kernels={g: v[1] for g, v in groups.items()},
         top=[{"name": k[:90], "device_s": us / 1e6, "calls": c}
              for us, k, c in sorted(rows, reverse=True)[:12]], smi=smi)


def autotune_phase(torch, dev, smi, main_dir):
    """The recorded-timing autotuner on the card at AUTOTUNE_N x 1450,
    E_max 20, the cuda engine, eight ``edm_run`` runs in this order (each
    with its launch counts and peak set to 0 just before it; EDM_HISTORY
    unset, so each store keeps its own history): C ``--no-telemetry``;
    A ``--autotune`` (records, writes tuned.json); B ``--autotune
    --tune-from A`` (A's recommendation applied); then telemetry off and
    on in turns at the default shapes, C2, E, C3, E2; D ``--no-telemetry
    --lib-block SLOPE_LIB_BLOCK``.  Held: the eight maps byte-equal; C
    leaves no telemetry/ and no history.jsonl; tuned.json equal to a
    fresh ``autotune.recommend(A)``; B ran A's recommendation.  Printed:
    each run's walls, phase-2 s, peak device bytes and kernel launches,
    the recommendation and its evidence, the telemetry cost (the mean of
    A, E, E2 against that of C, C2, C3: the same shapes), and
    the device memory a tuned shape needs by the peak's slope in library
    rows (C to D): B's (against its measured peak) and that of the
    host-only recommendation of ``main_dir`` (the main path's store at
    the smoke's N, whose run recorded its telemetry).  Last, M: that
    recommendation applied at the main path's N (``--autotune --tune-from
    main_dir``), its ``lib_block`` capped to the card's free memory
    (``autotune.fit_lib_block``): its map byte-equal to ``main_dir``'s,
    its measured peak below the card's memory.  B and M each run
    min(recommended rows, the printed cap)."""
    import os

    import numpy as np

    from repro_torch.runtime import autotune

    n = AUTOTUNE_N
    base = ["--synthetic", f"{n}x{FISH1_L}", "--e-max", str(E_MAX)]
    root = ROOT / "build" / "smoke_autotune"
    shutil.rmtree(root, ignore_errors=True)
    order = ("C", "A", "B", "C2", "E", "C3", "E2", "D")
    on, off = ("A", "E", "E2"), ("C", "C2", "C3")
    dirs = {k: root / k for k in order}
    argv = {"A": ["--autotune"],
            "B": ["--autotune", "--tune-from", str(dirs["A"])],
            "E": [], "E2": [],
            "D": ["--no-telemetry", "--lib-block", str(SLOPE_LIB_BLOCK)],
            **{k: ["--no-telemetry"] for k in off}}
    saved = os.environ.pop("EDM_HISTORY", None)
    gc.collect()
    torch.cuda.empty_cache()  # B's one chunk takes tens of GB
    runs = {}
    try:
        for key in order:
            t0 = time.perf_counter()
            s, launches, peak = run_cli(torch, dev, [*base, *argv[key], "--out",
                                                     str(dirs[key])])
            runs[key] = dict(argv=argv[key], cli_wall_s=time.perf_counter() - t0,
                             **phase_walls(s), lib_block=s["lib_block"],
                             target_tile=s["target_tile"],
                             applied=s["autotune"]["applied"],
                             lib_block_cap=s["autotune"]["lib_block_cap"],
                             peak_device_bytes=peak, launches=launches)
        # M: the main path's own store's recommendation applied at its N,
        # under the cap (uncapped, a chunk of every row: PERF.md)
        main_N = json.loads((main_dir / "causal_map" / "meta.json").read_text())[
            "shape"][0]
        dirs["M"] = root / "M"
        argv["M"] = ["--synthetic", f"{main_N}x{FISH1_L}", "--e-max", str(E_MAX),
                     "--autotune", "--tune-from", str(main_dir)]
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        s, launches, peak = run_cli(torch, dev, [*argv["M"], "--out", str(dirs["M"])])
        runs["M"] = dict(argv=argv["M"], cli_wall_s=time.perf_counter() - t0,
                         **phase_walls(s), lib_block=s["lib_block"],
                         target_tile=s["target_tile"], applied=s["autotune"]["applied"],
                         lib_block_cap=s["autotune"]["lib_block_cap"],
                         peak_device_bytes=peak, launches=launches)
        del s
    finally:
        if saved is not None:
            os.environ["EDM_HISTORY"] = saved
    maps = {k: d / "causal_map" / "data.npy" for k, d in dirs.items()}
    equal = {k: same_npy_bits(maps["A"], maps[k]) for k in order if k != "A"}
    main_equal = same_npy_bits(main_dir / "causal_map" / "data.npy", maps["M"])
    tuned = json.loads((dirs["A"] / "tuned.json").read_text())
    again = autotune.recommend(dirs["A"])
    rec = tuned["recommend"]
    off_clean = not (dirs["C"] / "telemetry").exists() and not (
        dirs["C"] / "history.jsonl").exists()
    on_kept = all((dirs[k] / f).exists() for k in "AB"
                  for f in ("telemetry/main.jsonl", "history.jsonl"))
    # device memory of a phase-2 chunk grows linearly in its library rows:
    # the slope from C (LIB_BLOCK) to D (SLOPE_LIB_BLOCK), at n and at the
    # main path's N (the series and futures the device holds grow with N)
    slope = (runs["D"]["peak_device_bytes"] - runs["C"]["peak_device_bytes"]) / (
        SLOPE_LIB_BLOCK - LIB_BLOCK)
    Lp = FISH1_L - E_MAX  # 1430
    total = torch.cuda.get_device_properties(dev).total_memory

    def need(rows, N):
        # + the series and futures of N - n more columns, and the chunk's
        # rho rows (its blocks and their join) N - n columns wider
        return int(runs["C"]["peak_device_bytes"] + slope * (rows - LIB_BLOCK)
                   + (N - n) * (FISH1_L + Lp) * 4 + 2 * rows * (N - n) * 4)

    def tables(rows, N, buckets):
        # the bucketed tables of a chunk: idx int32 + w float32 (+ the
        # kernel's float32 distances, until the weights are made)
        k = max(buckets) + 1
        return {"idx_w": rows * len(buckets) * Lp * k * 8,
                "idx_w_dist": rows * len(buckets) * Lp * k * 12}

    t0 = time.perf_counter()
    main_tuned = autotune.recommend(main_dir)
    host_s = time.perf_counter() - t0
    main_meta = json.loads((main_dir / "causal_map" / "meta.json").read_text())
    main_buckets = sorted(set(main_meta["optE"]))
    a_meta = json.loads((dirs["A"] / "causal_map" / "meta.json").read_text())
    a_buckets = sorted(set(a_meta["optE"]))
    rows_n = rec.get("chunk_rows", LIB_BLOCK)
    rows_main = main_tuned["recommend"].get("chunk_rows", LIB_BLOCK)
    def cost(key):  # telemetry on against off, the same shapes
        base = sum(runs[k][key] for k in off) / len(off)
        d = sum(runs[k][key] for k in on) / len(on) - base
        return {key: d, key.replace("_s", "_pct"): 100.0 * d / base}
    emit("autotune", N=n, L=FISH1_L, E_max=E_MAX, runs=runs, byte_equal_to_A=equal, no_telemetry_leaves_nothing=off_clean,
         telemetry_and_history_kept=on_kept, recommend=rec,
         evidence=tuned["evidence"], tuned_json_equals_recommend=tuned == again,
         telemetry_cost={**cost("cli_wall_s"), **cost("wall_s"),
                         **cost("phase2_s"),
                         "records_A": sum(1 for _ in open(
                             dirs["A"] / "telemetry" / "main.jsonl"))},
         peak_slope_bytes_per_row=slope, device_total_bytes=total,
         tuned_run={"N": n, "lib_block": rows_n,
                    "tables_bytes": tables(rows_n, n, a_buckets),
                    "peak_bytes_estimate": need(rows_n, n),
                    "peak_bytes_measured": runs["B"]["peak_device_bytes"],
                    "fits": need(rows_n, n) < total},
         main_store_host_only={"N": main_N, "seconds": host_s,
                               "recommend": main_tuned["recommend"],
                               "evidence": main_tuned["evidence"],
                               "lib_block": rows_main,
                               "tables_bytes": tables(rows_main, main_N,
                                                      main_buckets),
                               "peak_bytes_estimate": need(rows_main, main_N),
                               "fits": need(rows_main, main_N) < total},
         main_store_applied={"N": main_N, "lib_block": runs["M"]["lib_block"],
                             "lib_block_cap": runs["M"]["lib_block_cap"],
                             "capped": runs["M"]["lib_block"] < rows_main,
                             "peak_bytes_estimate": need(runs["M"]["lib_block"], main_N),
                             "peak_bytes_measured": runs["M"]["peak_device_bytes"],
                             "byte_equal_to_main_store": main_equal},
         smi=smi)
    def applied_ok(key, rows):  # the recommendation, capped on the card
        r = runs[key]
        return (r["lib_block_cap"] is not None
                and r["lib_block"] == min(rows, r["lib_block_cap"]))

    if not (all(equal.values()) and off_clean and on_kept and tuned == again
            and runs["B"]["applied"] == rec and applied_ok("B", rows_n)
            and main_equal and runs["M"]["applied"] == main_tuned["recommend"]
            and applied_ok("M", rows_main)
            and runs["M"]["peak_device_bytes"] < total):
        raise AssertionError(f"autotune: byte_equal {equal}, off_clean "
                             f"{off_clean}, on_kept {on_kept}, tuned.json == "
                             f"recommend {tuned == again}, B {runs['B']}, "
                             f"M {runs['M']} (equal to the main store {main_equal})")
    if min(min(r["launches"]["knn_topk"], r["launches"]["ccm_lookup"])
           for r in runs.values()) < 1:
        raise AssertionError(f"autotune: a run missed a kernel: {runs}")
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()  # B's chunk held tens of GB in this process
    return {k: r["launches"] for k, r in runs.items()}


def all_e_phase(torch, dev, smi):
    """The all-E phase 2 (--no-bucketed) at ALL_E_N x 1450, E_max 20,
    through the CLI untiled and in tiles of ALL_E_TILE (each with its
    launch counts set to 0 just before it): tiled == untiled byte for
    byte, and the cuda engine's map against torch-reference's on the
    card (optE equal, rho within 1e-5)."""
    import numpy as np

    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain

    n = ALL_E_N
    base = ["--synthetic", f"{n}x{FISH1_L}", "--e-max", str(E_MAX), "--no-bucketed"]
    runs = {}
    for name, extra in (("untiled", []), ("tiled", ["--target-tile", str(ALL_E_TILE)])):
        d = ROOT / "build" / f"smoke_all_e_{name}"
        shutil.rmtree(d, ignore_errors=True)
        summary, launches, peak = run_cli(torch, dev, base + extra + ["--out", str(d)])
        runs[name] = dict(dir=d, launches=launches, peak_device_bytes=peak,
                          **phase_walls(summary))
        if min(launches["knn_topk"], launches["ccm_lookup"]) < 1:
            raise AssertionError(f"all-E {name} run missed a kernel: {launches}")
    got = np.load(runs["untiled"]["dir"] / "causal_map" / "data.npy")
    byte_equal = same_npy_bits(runs["untiled"]["dir"] / "causal_map" / "data.npy",
                               runs["tiled"]["dir"] / "causal_map" / "data.npy")
    t0 = time.perf_counter()
    want = run_causal_inference(dummy_brain(n, FISH1_L),
                                EDMConfig(E_max=E_MAX, bucketed=False,
                                          engine="torch-reference"), device=dev)
    ref_s = time.perf_counter() - t0
    optE = json.loads((runs["untiled"]["dir"] / "causal_map" / "meta.json")
                      .read_text())["optE"]
    optE_eq = optE == want.optE.tolist()
    err = float(np.abs(got - want.rho).max())
    for r in runs.values():
        shutil.rmtree(r.pop("dir"), ignore_errors=True)
    out = dict(N=n, L=FISH1_L, E_max=E_MAX, tile=ALL_E_TILE, runs=runs,
               tiled_byte_equal=byte_equal, reference_device=str(dev),
               reference_wall_s=ref_s, optE_equal=optE_eq, rho_max_abs_err=err,
               tol=1e-5, smi=smi)
    emit("all_e", **out)
    if not (byte_equal and optE_eq and err <= 1e-5 and np.isfinite(got).all()):
        raise AssertionError("all-E phase 2: tiled != untiled or cuda != "
                             f"torch-reference ({byte_equal}, {optE_eq}, {err})")
    return out


def bf16_map_phase(torch, dev, smi):
    """The map with the bfloat16 accumulator (EDMConfig(dist_dtype=
    "bfloat16")) at BF16_N x 1450, E_max 20: the cuda engine (its launch
    counts set to 0 just before it; the kNN kernel must run) against
    torch-reference on the card — the first chunk's phase-1 and phase-2
    kNN tables bit-equal, optE equal, rho within 1e-5."""
    import dataclasses as dc

    import numpy as np

    from repro_torch import engine
    from repro_torch.core import ccm, embedding
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.knn_topk.ops import knn_topk

    ts = dummy_brain(BF16_N, FISH1_L, seed=14)
    cfg = EDMConfig(E_max=E_MAX, dist_dtype="bfloat16")
    ref_cfg = dc.replace(cfg, engine="torch-reference")
    knn_topk.LAUNCHES = ccm_lookup.LAUNCHES = 0
    t0 = time.perf_counter()
    got = run_causal_inference(ts, cfg, device=dev)
    wall = time.perf_counter() - t0
    launches = {"knn_topk": knn_topk.LAUNCHES, "ccm_lookup": ccm_lookup.LAUNCHES}
    want = run_causal_inference(ts, ref_cfg, device=dev)
    optE_eq = bool(np.array_equal(got.optE, want.optE))
    err = float(np.abs(got.rho - want.rho).max())
    f32 = run_causal_inference(ts, EDMConfig(E_max=E_MAX), device=dev)
    # the first chunk's tables from both engines
    rows = torch.as_tensor(ts[:LIB_BLOCK]).to(dev)
    Lp = cfg.n_points(FISH1_L)
    V = embedding.lag_matrix(rows, E_MAX, 1, Lp).contiguous()
    plan, _ = ccm.make_bucket_plan(got.optE)
    kb = plan.buckets[-1] + 1
    Lh = Lp // 2
    tables_equal = {}
    for name, args, kw in (
        ("phase1", (V[..., Lh:].contiguous(), V[..., :Lh].contiguous(), E_MAX + 1),
         dict(exclude_self=False)),
        ("phase2", (V, V, kb), dict(buckets=plan.buckets, exclude_self=True)),
    ):
        pair = []
        for c in (cfg, ref_cfg):
            eng = engine.get_engine(c.engine)
            fn = eng.knn_tables if name == "phase1" else eng.knn_tables_bucketed
            pair.append(fn(*args, cfg=c, **kw))
        (ki, kd), (ri, rd) = pair
        tables_equal[name] = bool(torch.equal(ki, ri)) and same_bits(torch, kd, rd)
    out = dict(N=BF16_N, L=FISH1_L, E_max=E_MAX, dist_dtype="bfloat16", wall_s=wall,
               launches=launches, tables_bit_equal=tables_equal,
               optE_equal=optE_eq, rho_max_abs_err=err, tol=1e-5,
               optE_equal_f32=bool(np.array_equal(got.optE, f32.optE)),
               rho_max_abs_diff_f32=float(np.abs(got.rho - f32.rho).max()), smi=smi)
    emit("bf16_map", **out)
    if not (all(tables_equal.values()) and optE_eq and err <= 1e-5
            and launches["knn_topk"] > 0 and np.isfinite(got.rho).all()):
        raise AssertionError(f"bf16 map: cuda != torch-reference ({out})")
    return out


# ---- the LM serving path --------------------------------------------------
FLASH_CASES = (
    # name, B, Sq, Sk, H, K, dh, causal, dtype
    ("serve_qwen2.5-3b", 4, 2048, 2048, 16, 2, 128, True, "bfloat16"),
    ("serve_dbrx-132b_rep6", 4, 2048, 2048, 48, 8, 128, True, "bfloat16"),
    ("smollm-135m_dh64_rep3", 2, 1024, 1024, 9, 3, 64, True, "bfloat16"),
    ("minicpm-2b_mha_dh64", 1, 512, 512, 36, 36, 64, True, "bfloat16"),
    ("float32_dh128", 2, 1024, 1024, 16, 2, 128, True, "float32"),
    ("sq_not_tile_multiple", 1, 2049, 2049, 16, 2, 128, True, "bfloat16"),
    ("noncausal_sk_not_tile_multiple_f32", 2, 300, 333, 8, 2, 128, False, "float32"),
    ("noncausal_sk_not_tile_multiple_bf16", 2, 300, 333, 8, 2, 128, False, "bfloat16"),
    ("test_kernels_1", 2, 128, 128, 4, 2, 64, True, "float32"),
    ("test_kernels_2", 1, 256, 256, 6, 6, 32, True, "float32"),
    ("test_kernels_3", 2, 64, 64, 8, 4, 16, False, "float32"),
    ("test_kernels_4", 1, 96, 96, 2, 1, 8, True, "float32"),
    ("bf16_dh16", 2, 300, 300, 4, 2, 16, True, "bfloat16"),
    ("zamba2-7b_dh112_mha", 1, 1024, 1024, 32, 32, 112, True, "bfloat16"),
    ("sq1_below_tile", 4, 1, 2048, 16, 2, 128, False, "bfloat16"),
    ("rep8_h32_k4", 1, 1000, 1000, 32, 4, 128, True, "bfloat16"),
    ("bf16_dh8_cuda_core", 1, 96, 96, 2, 1, 8, True, "bfloat16"),
    # the hybrid, audio and vlm serve shapes: zamba2's shared block (dh
    # 112), whisper's encoder (non-causal MHA, 1,500 frames: partial query
    # and key tiles), its decoder and cross-attention, the vlm's self and
    # cross-attention (1,601 patches: a partial key tile); the f32 gate's
    # route at the non-causal ones
    ("serve_zamba2-7b_dh112", 4, 2048, 2048, 32, 32, 112, True, "bfloat16"),
    ("serve_whisper_encoder", 4, 1500, 1500, 16, 16, 64, False, "bfloat16"),
    ("serve_whisper_decoder", 4, 416, 416, 16, 16, 64, True, "bfloat16"),
    ("serve_whisper_cross", 4, 416, 1500, 16, 16, 64, False, "bfloat16"),
    ("serve_vlm_self", 4, 2048, 2048, 32, 8, 128, True, "bfloat16"),
    ("serve_vlm_cross", 4, 2048, 1601, 32, 8, 128, False, "bfloat16"),
    ("whisper_encoder_f32", 1, 1500, 1500, 16, 16, 64, False, "float32"),
    ("whisper_cross_f32", 1, 416, 1500, 16, 16, 64, False, "float32"),
    ("vlm_cross_f32", 1, 2048, 1601, 32, 8, 128, False, "float32"),
    ("zamba2_dh112_f32", 1, 2048, 2048, 32, 32, 112, True, "float32"),
)


def qkv(torch, dev, B, Sq, Sk, H, K, dh, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dt)
                 for shape in ((B, Sq, H, dh), (B, Sk, K, dh), (B, Sk, K, dh)))


def sdpa(torch, q, k, v, causal):
    """One library call computing flash_attn's function: SDPA in
    (B, H, S, dh), GQA, top-left causal; back in (B, S, H, dh)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True).transpose(1, 2)


def check_flash(torch, dev):
    """Kernel vs plain version on the card at every case of FLASH_CASES,
    within the tolerance of its dtype and route (FLASH_TOL_F32,
    FLASH_TOL_BF16_CUDA_CORE, or the tensor-core rule).  Returns the
    largest error."""
    from repro_torch.kernels.flash_attn.ops import flash_attn, flash_route
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref

    worst = 0.0
    for i, (name, B, Sq, Sk, H, K, dh, causal, dtype) in enumerate(FLASH_CASES):
        q, k, v = qkv(torch, dev, B, Sq, Sk, H, K, dh, dtype, seed=100 + i)
        route = flash_route(q.device.type, q.dtype, dh)
        got = flash_attn(q, k, v, causal)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all())
        if route == "tensor_core":
            want = flash_attn_ref(q.float(), k.float(), v.float(), causal)
            diff = (got.float() - want).abs()
            lib_row = (sdpa(torch, q, k, v, causal).float() - want).abs().amax(-1)
            lib_err = float(lib_row.max())
            limit = min(FLASH_BF16_LIBRARY_FACTOR * lib_err, FLASH_BF16_CEILING)
            elem = (FLASH_BF16_STEP * want.abs()
                    + FLASH_BF16_LIBRARY_FACTOR * lib_row[..., None])
            # largest share of the element limit taken; <= 1 passes
            elem_share = float((diff / elem.clamp_min(1e-30)).max())
            err = float(diff.max())
            ok = finite and err <= limit and elem_share <= 1.0
            tol = dict(library_max_abs_err=lib_err, tol=limit,
                       elem_limit_share=elem_share)
        else:
            want = flash_attn_ref(q, k, v, causal)
            atol, rtol = FLASH_TOL_F32 if dtype == "float32" else FLASH_TOL_BF16_CUDA_CORE
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            ok = finite and bool((diff <= atol + rtol * want.float().abs()).all())
            tol = dict(atol=atol, rtol=rtol)
        emit("check_flash", case=name, B=B, Sq=Sq, Sk=Sk, H=H, K=K, dh=dh,
             causal=causal, dtype=dtype, route=route, max_abs_err=err, **tol,
             ok=ok)
        if not ok:
            raise AssertionError(f"flash_attn kernel != plain version ({name}): "
                                 f"max abs error {err}, {tol}")
        worst = max(worst, err)
    return worst


def time_flash(torch, dev, smi, arch=LM_ARCH, part="self"):
    """CUDA-event means at one attention of ``arch``'s serve prefill
    (``serve_flash_shapes``): kernel (the tensor-core route), plain
    version, and one library call (SDPA in (B, H, S, dh), transposed
    outside the timing)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn.ops import flash_attn, flash_route
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.launch.roofline import PEAK_BF16_FLOPS, bound_ms, flash_counts

    B, Sq, Sk, H, K, dh, causal = serve_flash_shapes(arch)[part]
    q, k, v = qkv(torch, dev, B, Sq, Sk, H, K, dh, "bfloat16", seed=7)
    ms = time_ms(torch, lambda: flash_attn(q, k, v, causal), 20)
    plain = time_ms(torch, lambda: flash_attn_ref(q, k, v, causal), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    want = flash_attn_ref(q.float(), k.float(), v.float(), causal)
    lib_err = float((sdpa().transpose(1, 2).float() - want).abs().max())
    err = float((flash_attn(q, k, v, causal).float() - want).abs().max())
    del want
    lib = time_ms(torch, sdpa, 20)
    bound, by = bound_ms(*flash_counts(B, Sq, Sk, H, K, dh, 2, causal), PEAK_BF16_FLOPS)
    out = dict(arch=arch, part=part, kernel_ms=ms, plain_ms=plain,
               library_ms=lib, max_abs_err=err, library_max_abs_err=lib_err,
               bound_ms=bound, bound_by=by, share_of_bound=bound / ms,
               route=flash_route(q.device.type, q.dtype, dh), B=B, Sq=Sq, Sk=Sk,
               H=H, K=K, dh=dh, dtype="bfloat16", causal=causal)
    emit("time_flash", smi=smi, **out)
    return out


def _positions_layouts(Sq_total: int, n: int, chunk: int) -> dict:
    """{layout: (rows a block, period)} of a rank's rows: striped (C / n
    rows of every chunk of C, ``attn_impl="chunked"``) and contiguous
    (Sq / n rows, ``"xla"``)."""
    return {"striped": (chunk // n, chunk), "contiguous": (Sq_total // n, Sq_total)}


def _positions_ok(torch, got, want_f32, lib_row, dtype):
    """flash's gates for a call with positions: float32 FLASH_TOL_F32;
    bfloat16 (tensor-core route) the check_flash rule against the plain
    version's float32 result, ``lib_row`` SDPA's row errors on the same
    inputs.  Returns (ok, max abs error, tolerance record)."""
    diff = (got.float() - want_f32).abs()
    err = float(diff.max())
    if dtype == "float32":
        atol, rtol = FLASH_TOL_F32
        return bool((diff <= atol + rtol * want_f32.abs()).all()), err, dict(atol=atol, rtol=rtol)
    lib_err = float(lib_row.max())
    limit = min(FLASH_BF16_LIBRARY_FACTOR * lib_err, FLASH_BF16_CEILING)
    elem = FLASH_BF16_STEP * want_f32.abs() + FLASH_BF16_LIBRARY_FACTOR * lib_row[..., None]
    share = float((diff / elem.clamp_min(1e-30)).max())
    return (err <= limit and share <= 1.0, err,
            dict(library_max_abs_err=lib_err, tol=limit, elem_limit_share=share))


def _masked_sdpa(torch, q, k, v, pos):
    """One library call at positions: SDPA with the boolean mask q_pos[i]
    >= j, (B, H, S, dh) in and out (GQA)."""
    import torch.nn.functional as F

    mask = pos[:, None] >= torch.arange(k.shape[-2], device=q.device)[None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def flash_positions(torch, dev, smi):
    """The flash kernel with per-row positions (q_pos) against its plain
    version at one rank's shapes of sequence-parallel attention
    (FLASH_POSITIONS): both routes (float32 on the CUDA cores, bfloat16 on
    the tensor cores), both layouts (striped and contiguous), the last
    rank's rows within flash's gates; every rank's rows, stitched, against
    the unsharded kernel within the same gates; and, bfloat16 striped,
    CUDA-event ms of the kernel, the plain version and SDPA with the
    positions' mask on the same rows, beside the bound from the positions.
    The launches with positions by route."""
    from repro_torch.kernels.flash_attn.ops import (ROUTES, block_positions, flash_attn,
                                                    flash_route, host_positions)
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.launch.roofline import PEAK_BF16_FLOPS, bound_ms, flash_counts
    from repro_torch.sharding.attention import seq_rank_rows, seq_stitch

    flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
    flash_attn.POSITION_LAUNCHES = dict.fromkeys(ROUTES, 0)
    out = {"cases": [], "times": {}}
    worst = 0.0
    for i, (name, B, S, H, K, dh, n, chunk) in enumerate(FLASH_POSITIONS):
        for dtype in ("float32", "bfloat16"):
            q, k, v = qkv(torch, dev, B, S, S, H, K, dh, dtype, seed=300 + i)
            whole = flash_attn(q, k, v, True)
            for layout, (block, period) in _positions_layouts(S, n, chunk).items():
                r = n - 1  # the last rank: the largest positions
                rows = seq_rank_rows(q, r, n, block, period).contiguous()
                pos = block_positions(S // n, block, period, r * block, dev)
                got = flash_attn(rows, k, v, True, pos)
                want = flash_attn_ref(rows.float(), k.float(), v.float(), True, pos)
                lib_row = None
                if dtype == "bfloat16":
                    lib = _masked_sdpa(torch, *(t.transpose(1, 2) for t in (rows, k, v)), pos)
                    lib_row = (lib.transpose(1, 2).float() - want).abs().amax(-1)
                    del lib
                ok, err, tol = _positions_ok(torch, got, want, lib_row, dtype)
                del want, lib_row
                # every rank's rows, stitched, against the unsharded kernel
                parts = [flash_attn(seq_rank_rows(q, j, n, block, period).contiguous(), k, v,
                                   True, block_positions(S // n, block, period, j * block, dev))
                         for j in range(n)]
                sdiff = (seq_stitch(parts, n, block, period).float() - whole.float()).abs()
                del parts
                atol, rtol = (FLASH_TOL_F32 if dtype == "float32"
                              else FLASH_TOL_BF16_CUDA_CORE)
                s_ok = bool((sdiff <= atol + rtol * whole.float().abs()).all())
                rec = dict(case=name, dtype=dtype, layout=layout, B=B, Sq=S // n, Sk=S,
                           H=H, K=K, dh=dh, n=n, rank=r, chunk=chunk,
                           route=flash_route("cuda", q.dtype, dh), max_abs_err=err, **tol,
                           stitched_max_abs_err=float(sdiff.max()),
                           stitched_tol=dict(atol=atol, rtol=rtol), ok=ok and s_ok)
                emit("flash_positions", **rec)
                out["cases"].append(rec)
                if not rec["ok"]:
                    raise AssertionError(f"flash_attn with positions ({name}, {dtype}, "
                                         f"{layout}): {rec}")
                worst = max(worst, err if dtype == "float32" else 0.0)
                del rows, got, sdiff
            if dtype == "bfloat16":  # the route sequence-parallel prefills take
                block, period = _positions_layouts(S, n, chunk)["striped"]
                rows = seq_rank_rows(q, n - 1, n, block, period).contiguous()
                pos = block_positions(S // n, block, period, (n - 1) * block, dev)
                ms = time_ms(torch, lambda: flash_attn(rows, k, v, True, pos), 10)
                plain = time_ms(torch, lambda: flash_attn_ref(rows, k, v, True, pos), 1)
                qt, kt, vt = (t.transpose(1, 2) for t in (rows, k, v))
                lib = time_ms(torch, lambda: _masked_sdpa(torch, qt, kt, vt, pos), 5)
                bound, by = bound_ms(*flash_counts(B, S // n, S, H, K, dh, 2, True,
                                                   q_pos=host_positions(pos)),
                                     PEAK_BF16_FLOPS)
                t = dict(kernel_ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by, share_of_bound=bound / ms)
                out["times"][name] = t
                emit("flash_positions_time", case=name, layout="striped", rank=n - 1, B=B,
                     Sq=S // n, Sk=S, H=H, K=K, dh=dh, dtype=dtype, smi=smi, **t)
                del rows, qt, kt, vt
            del q, k, v, whole
            torch.cuda.empty_cache()
    out["launches"] = dict(flash_attn.POSITION_LAUNCHES)
    out["max_abs_err_f32"] = worst
    emit("flash_positions", launches_by_route=out["launches"],
         launches_all_by_route=dict(flash_attn.ROUTE_LAUNCHES), smi=smi)
    return out


def train_tc_kw() -> dict:
    """``train_step``'s train config (TRAIN_* above) as keywords."""
    return dict(optimizer="adamw", moment_dtype="float32", schedule="wsd", remat=True,
                microbatch=TRAIN_MICRO, warmup_steps=1, total_steps=1 + TRAIN_TIMED)


def dry_spec(name, arch, cell, optimized=False, over=None, tc=None, mesh=None,
             extrapolate=False) -> dict:
    """A dry job's spec: ``cell`` a shape cell's name or (name, kind, seq,
    batch); ``mesh`` None (the production mesh), [] (one card) or [shape,
    names]; ``extrapolate``: from one and two repeating units; its JSON to
    build/dryrun/smoke_<name>.json."""
    return dict(name=name, arch=arch, cell=cell, optimized=optimized, over=over or {},
                tc=tc, mesh=mesh, extrapolate=extrapolate,
                out=str(ROOT / "build" / "dryrun" / f"smoke_{name}.json"))


def run_dry_jobs(specs, timeout=DRY_TIMEOUT_S) -> dict:
    """{name: the dry run's JSON} of ``specs``, run one after another in
    one process (no card: CUDA hidden, one thread), which this call waits
    for; a job that fails, or a process that outlives ``timeout`` (killed),
    raises."""
    import os

    logdir = ROOT / "build" / "dryrun"
    logdir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    for spec in specs:
        pathlib.Path(spec["out"]).unlink(missing_ok=True)
    log_path = logdir / "smoke_dry_jobs.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dry-job", json.dumps(specs)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
    out = {}
    for spec in specs:
        path = pathlib.Path(spec["out"])
        if rc != 0 or not path.exists():
            raise AssertionError(f"dry job {spec['name']}: rc {rc}\n"
                                 f"{log_path.read_text()[-3000:]}")
        out[spec["name"]] = json.loads(path.read_text())
    return out


def smoke_dry_specs() -> list:
    """The dry runs ``lm_dryrun`` reads: DRY_CELLS at 16 x 16, and
    ``train_step``'s setup (minicpm-2b whole, chunked, TRAIN_*) at a world
    of one."""
    return ([dry_spec(f"{a}__{c}{'__opt' if o else ''}", a, c, optimized=o,
                      extrapolate=c.startswith("train")) for a, c, o in DRY_CELLS]
            + [dry_spec("train_step_world1", TRAIN_ARCH,
                        ["train_step", "train", TRAIN_S, TRAIN_B],
                        over=dict(attn_impl="chunked"), tc=train_tc_kw(), mesh=[],
                        extrapolate=True)])


def dry_jobs(specs_json: str) -> int:
    """``--dry-job``: each spec of ``dry_spec`` in the JSON list, one after
    another, through launch/dryrun.py."""
    for spec in json.loads(specs_json):
        t0 = time.perf_counter()
        res = dry_job(spec)
        res["job_wall_s"] = time.perf_counter() - t0
        pathlib.Path(spec["out"]).write_text(json.dumps(res))
    return 0


def dry_job(spec: dict) -> dict:
    """One spec of ``dry_spec`` through launch/dryrun.py: its JSON."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell, TrainConfig, shape_cell
    from repro_torch.launch import dryrun as DR

    arch = spec["arch"]
    cfg = dataclasses.replace(get_config(arch), **spec["over"])
    cell = (shape_cell(spec["cell"]) if isinstance(spec["cell"], str)
            else ShapeCell(*spec["cell"]))
    kw = dict(cfg=cfg)
    if spec["optimized"]:
        kw = dict(cfg=DR.optimized_cfg(cfg, cell), policy_kw=DR.optimized_policy_kw(cfg, cell),
                  variant="optimized")
    kw["extrapolate"] = spec["extrapolate"]
    if spec["tc"] is not None:
        kw["tc"] = TrainConfig(**spec["tc"])
    if spec["mesh"] is not None:
        kw["mesh"] = ((), ()) if spec["mesh"] == [] else (tuple(spec["mesh"][0]),
                                                          tuple(spec["mesh"][1]))
    res = DR.dry_cell(arch, cell, **kw)
    print(DR.summary_line(res), flush=True)
    return res


def lm_dryrun(torch, smi, tstep) -> dict:
    """The dry runs of ``smoke_dry_specs``, run now: each production
    cell's trace seconds, peak and roofline terms; ``train_step``'s own
    setup at a world of one against the card (DRY_PEAK_TOL, DRY_FLOPS_TOL,
    its roofline time at most the fastest measured step)."""
    res = run_dry_jobs(smoke_dry_specs())
    out = {}
    for name, r in res.items():
        rl = r["roofline"]
        rec = dict(arch=r["arch"], cell=r["cell"], mesh=r["mesh"], variant=r["variant"],
                   attn_seq_shard=r["attn_seq_shard"], trace_s=r["trace_s"],
                   job_wall_s=r["job_wall_s"], memory=r["memory"],
                   flops_per_chip=rl["flops_per_chip"], bytes_per_chip=rl["bytes_per_chip"],
                   t_compute_s=rl["t_compute_s"], t_memory_s=rl["t_memory_s"],
                   t_collective_s=rl["t_collective_s"], bottleneck=rl["bottleneck"],
                   collectives=r["collectives"], links=rl["links"],
                   useful_flops_ratio=r["useful_flops_ratio"])
        if name == "train_step_world1":
            peak, flops = tstep["peak_device_bytes"], tstep["flops_counted_one_step"]
            t_bound = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
            rec.update(measured_peak_bytes=peak, counted_flops=flops,
                       peak_rel_err=r["memory"]["peak_bytes_per_device"] / peak - 1.0,
                       flops_rel_err=rl["flops_per_chip"] / flops - 1.0,
                       t_bound_s=t_bound, measured_step_s=min(tstep["step_s"]))
            rec["ok"] = (abs(rec["peak_rel_err"]) <= DRY_PEAK_TOL
                         and abs(rec["flops_rel_err"]) <= DRY_FLOPS_TOL
                         and t_bound <= rec["measured_step_s"])
        emit("lm_dryrun", job=name, smi=smi, **rec)
        out[name] = rec
        if rec.get("ok") is False:
            raise AssertionError(f"the dry run of train_step's setup misses the card: {rec}")
    return out


def lm_config(arch=LM_ARCH, n_layers=None, **kw):
    """``arch`` at full width on the kernel route, its depth cut to
    ``n_layers`` where given."""
    from repro_torch.configs import get_config

    if n_layers is not None:
        kw["n_layers"] = n_layers
    return dataclasses.replace(get_config(arch), attn_impl="chunked", **kw)


def serve_prompt(cfg) -> int:
    return AUDIO_PROMPT if cfg.family == "audio" else SERVE_S


def serve_flash_shapes(arch) -> dict:
    """{part: (B, Sq, Sk, H, K, dh, causal)} of the attentions a serve
    prefill of ``arch`` launches the flash kernel for: every family's
    causal self-attention; the audio encoder's (frames x frames, not
    causal); the cross-attention of audio and vlm (prompt x frames or
    patches)."""
    cfg = lm_config(arch)
    S, nf = serve_prompt(cfg), cfg.n_frontend_tokens
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    out = {"self": (SERVE_B, S, S, *heads, True)}
    if cfg.family == "audio":
        out["encoder"] = (SERVE_B, nf, nf, *heads, False)
    if cfg.family in ("audio", "vlm"):
        out["cross"] = (SERVE_B, S, nf, *heads, False)
    return out


def want_flash(T, cfg) -> int:
    """Flash launches of one prefill (or forward) of ``cfg``: one an
    attention layer (dense, moe), none (ssm), one a shared-block
    application (hybrid), encoder + decoder self + cross layers (audio),
    the self and cross layers (vlm: n_layers)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return T._hybrid_counts(cfg)[0]
    if cfg.family == "audio":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def frontend(torch, T, cfg, B, dev, seed=0) -> dict:
    """The batch's audio frames or image patches, 0.1 N(0, 1) float32 from
    a seeded generator on the card (none for the other families)."""
    key = T.FRONTEND.get(cfg.family)
    if key is None:
        return {}
    g = torch.Generator(dev).manual_seed(seed)
    return {key: 0.1 * torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                                   generator=g, device=dev)}


def nonzero_zero_leaves(torch, params, dev, seed=1) -> list:
    """Draw the leaves JAX initialises at zero and that switch a branch off
    (ZERO_LEAVES: the LoRA b, the vlm gates) non-zero: b N(0, 0.02), gates
    0.3 + 0.6 U(0, 1); each drawn whole (a DTensor parameter keeps the
    rank's slice: the same values as one process's).  Returns the leaf
    names it drew."""
    from repro_torch.sharding import place as PL

    g = torch.Generator(dev).manual_seed(seed)
    drawn = set()
    with torch.no_grad():
        for name, prm in params.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in ZERO_LEAVES:
                continue
            r = torch.empty(prm.shape, dtype=torch.float32, device=dev)
            if leaf.startswith("gate"):
                r = 0.3 + 0.6 * r.uniform_(generator=g)
            else:
                r = r.normal_(0.0, 0.02, generator=g)
            if PL.is_sharded(prm):
                r = PL.local(PL.place(r.to(prm.dtype), prm.device_mesh, prm.placements))
            PL.local(prm).copy_(r)
            drawn.add(leaf)
    return sorted(drawn)


def grown_cache(T, cfg, cache, B, S, S_new, dev):
    """A prefill's cache made room for decode steps: a cache of S_new
    positions with the prefill's S written on the sequence axis of every
    self-attention k / v (axis 2; the vlm's axis 3, behind its unit and
    layer axes); the cross keys and values, Mamba2 states and x0 as they
    are; ssm, the whole state as it is (it has no length)."""
    if cfg.family == "ssm":
        return cache
    big = T.init_cache(cfg, B, S_new, device=dev)
    axis = 3 if cfg.family == "vlm" else 2
    src, dst = (cache["attn"], big["attn"]) if cfg.family == "hybrid" else (cache, big)
    for name in ("k", "v"):
        dst[name].narrow(axis, 0, S).copy_(src[name])
    for name in cache:
        if name not in ("k", "v", "attn"):
            big[name] = cache[name]
    return big


def top1_mismatches(torch, got, want, vocab, tol):
    """(mismatching positions outside near-ties, near-ties): a near-tie is
    a position whose plain-route top-2 logits lie within 2 tol."""
    g = got[..., :vocab].reshape(-1, vocab)
    w = want[..., :vocab].reshape(-1, vocab)
    top2 = w.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 2 * tol
    bad = g.argmax(-1) != w.argmax(-1)
    return int((bad & ~tie).sum()), int(tie.sum())


def lm_serve(torch, dev, smi, arch=LM_ARCH, n_layers=None, phase="lm_serve"):
    """``arch`` at full width in bf16 (depth ``n_layers`` where given)
    through make_prefill_step (four requests of ``serve_prompt`` tokens,
    with their audio frames or image patches; the flash kernel ``want_flash``
    times on the tensor-core route) and DECODE_STEPS greedy decode steps (no flash
    launch); the flash launch count and the MoE drop counts start at 0
    just before the prefill.  The LoRA b and gates are drawn non-zero
    first (``drawn_nonzero``).  Then the kernel route vs the plain route
    on one request, reported, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attn.ops import ROUTES, flash_attn
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg = lm_config(arch, n_layers)
    V, S = cfg.vocab_size, serve_prompt(cfg)
    n_flash = want_flash(T, cfg)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    drawn = nonzero_zero_leaves(torch, params, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.as_tensor(TokenStream(V, SERVE_B, S, seed=0).batch_at(0)["tokens"])
    front = frontend(torch, T, cfg, SERVE_B, dev)
    prefill_step = make_prefill_step(cfg, device=dev)
    decode = make_decode_step(cfg, device=dev)
    with torch.inference_mode():
        # warm-up at a short prompt: cuBLAS handles, the kernel's library
        _, c = prefill_step(params, {"tokens": tokens[:, :128], **front})
        warm = grown_cache(T, cfg, c, SERVE_B, 128, 130, dev)
        decode(params, {"token": tokens[:, 128:129], "pos": 128}, warm)
        del c, warm
        torch.cuda.synchronize()

        flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
        MOE.reset_drop_counts(params)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, {"tokens": tokens, **front})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_routes = dict(flash_attn.ROUTE_LAUNCHES)
        routed, dropped = MOE.drop_counts(params)
        if tuple(logits.shape) != (SERVE_B, S, cfg.padded_vocab):
            raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
        prefill_finite = bool(torch.isfinite(logits).all())
        tok = logits[:, -1, :V].argmax(-1)
        del logits
        big = grown_cache(T, cfg, cache, SERVE_B, S, S + DECODE_STEPS, dev)
        del cache
        out_tokens, finite = [tok], torch.ones((), dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(DECODE_STEPS):
            ld, big = decode(params, {"token": tok[:, None], "pos": S + t}, big)
            tok = ld[:, 0, :V].argmax(-1)
            finite &= torch.isfinite(ld).all()
            out_tokens.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        by_route = dict(flash_attn.ROUTE_LAUNCHES)
        decode_routes = {r: by_route[r] - prefill_routes[r] for r in ROUTES}
        decode_routed, decode_dropped = (n - m for n, m in zip(MOE.drop_counts(params),
                                                               (routed, dropped)))
        peak = torch.cuda.max_memory_allocated(dev)

        # where the time goes: one traced prefill, and four decode steps
        # that rewrite the last four slots of the cache
        last = S + DECODE_STEPS - 4
        busy = {
            "prefill": profile_busy(torch, lambda: prefill_step(
                params, {"tokens": tokens, **front})),
            "decode_4_steps": profile_busy(torch, lambda: [
                decode(params, {"token": tok[:, None], "pos": last + i}, big)
                for i in range(4)]),
        }
        del big, ld
        if not (prefill_finite and bool(finite)):
            raise AssertionError("non-finite logits on the serving path")
        if prefill_routes != {**dict.fromkeys(ROUTES, 0), "tensor_core": n_flash} \
                or any(decode_routes.values()):
            raise AssertionError(f"prefill launched the flash kernels {prefill_routes} "
                                 f"and decode {decode_routes}, not the tensor-core "
                                 f"route once per attention ({n_flash}) and "
                                 f"none in decode")
        if decode_dropped:
            raise AssertionError(f"decode dropped {decode_dropped} MoE assignments")

        # bf16: the kernel route against the plain route on one request;
        # for MoE, each layer's share of tokens routed to another expert set
        one = {"tokens": tokens[:1], **{k: v[:1] for k, v in front.items()}}
        moes = [m for m in params.modules() if isinstance(m, MOE.MoE)]
        fk, _ = T.forward(params, one, cfg)
        routes_k = [m.last_experts.sort(-1).values for m in moes]
        fp, _ = T.forward(params, one, dataclasses.replace(cfg, attn_impl="xla"))
        bf16_routing_differs = [float((a != m.last_experts.sort(-1).values).any(-1)
                                      .float().mean()) for a, m in zip(routes_k, moes)]
        del routes_k
        bf16_err = float((fk - fp).abs().max())
        bf16_bad, bf16_ties = top1_mismatches(torch, fk, fp, V, LM_GATE_TOL)
        bf16_logit_absmax = float(fp.abs().max())
        del fk, fp
    del params
    torch.cuda.empty_cache()
    gen = torch.stack(out_tokens, 1).cpu()
    out = dict(arch=arch, family=cfg.family, n_layers=cfg.n_layers,
               n_layers_full=get_config(arch).n_layers, params=n_params,
               dtype=cfg.dtype, attn_impl=cfg.attn_impl, B=SERVE_B, prompt=S,
               frontend_tokens=cfg.n_frontend_tokens or None,
               drawn_nonzero=drawn, decode_steps=DECODE_STEPS, init_s=init_s,
               prefill_s=prefill_s, prefill_tokens_per_s=SERVE_B * S / prefill_s,
               decode_ms_per_step=decode_s / DECODE_STEPS * 1e3,
               decode_tokens_per_s=SERVE_B * DECODE_STEPS / decode_s,
               peak_device_bytes=peak,
               launches={"flash_attn": sum(by_route.values())},
               launches_by_route=by_route, launches_prefill=prefill_routes,
               launches_decode=decode_routes,
               generated_distinct=int(gen.unique().numel()),
               bf16_kernel_vs_plain_max_abs=bf16_err,
               bf16_logit_absmax=bf16_logit_absmax,
               bf16_top1_mismatches=bf16_bad, bf16_top1_near_ties=bf16_ties,
               profile=busy, smi=smi)
    if cfg.n_experts:
        out.update(moe_prefill_assignments=routed, moe_prefill_dropped=dropped,
                   moe_prefill_dropped_share=dropped / routed,
                   moe_decode_dropped=decode_dropped,
                   bf16_kernel_vs_plain_routing_differs_by_layer=bf16_routing_differs)
    emit(phase, **out)
    return out


def lm_check(torch, dev, smi, arch=LM_ARCH, n_layers=None, phase="lm_check"):
    """The gate: ``arch`` in float32 (TF32 off; depth ``n_layers`` where
    given; the LoRA b and gates drawn non-zero), one request of
    ``serve_prompt`` + 1 tokens (with its audio frames or image patches),
    the kernel route (chunked: the flash kernel ``want_flash`` times, on
    the CUDA-core route) against the plain route (xla): every position's
    logits within LM_GATE_TOL and top-1 equal outside near-ties.  Then
    prefill (the prompt) against forward, and the decode of the next
    token against forward at that position."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attn.ops import ROUTES, flash_attn
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    cfg = lm_config(arch, n_layers, dtype="float32")
    V, S = cfg.vocab_size, serve_prompt(cfg)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    drawn = nonzero_zero_leaves(torch, params, dev)
    toks = torch.as_tensor(TokenStream(V, 1, S + 1, seed=0).batch_at(0)["tokens"])
    front = frontend(torch, T, cfg, 1, dev)
    with torch.inference_mode():
        flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
        fk, _ = T.forward(params, {"tokens": toks, **front}, cfg)
        flash_launches = dict(flash_attn.ROUTE_LAUNCHES)
        fp, _ = T.forward(params, {"tokens": toks, **front},
                          dataclasses.replace(cfg, attn_impl="xla"))
        route_err = float((fk - fp).abs().max())
        last_err = float((fk[:, S - 1] - fp[:, S - 1]).abs().max())
        bad, ties = top1_mismatches(torch, fk, fp, V, LM_GATE_TOL)
        logit_absmax = float(fp.abs().max())
        del fp
        pl, cache = make_prefill_step(cfg, device=dev)(params,
                                                       {"tokens": toks[:, :S], **front})
        prefill_err = float((pl - fk[:, :S]).abs().max())
        del pl
        big = grown_cache(T, cfg, cache, 1, S, S + 1, dev)
        del cache
        ld, _ = make_decode_step(cfg, device=dev)(
            params, {"token": toks[:, S : S + 1], "pos": S}, big)
        decode_err = float((ld[:, 0] - fk[:, S]).abs().max())
        decode_top1 = bool(ld[0, 0, :V].argmax() == fk[0, S, :V].argmax())
        del big, ld, fk
    del params
    torch.cuda.empty_cache()
    ok = (route_err <= LM_GATE_TOL and bad == 0 and prefill_err <= LM_GATE_TOL
          and decode_err <= LM_GATE_TOL
          and flash_launches == {**dict.fromkeys(ROUTES, 0),
                                 "cuda_core": want_flash(T, cfg)})
    out = dict(arch=arch, family=cfg.family, n_layers=cfg.n_layers, dtype="float32",
               tf32=False, B=1, positions=S + 1,
               frontend_tokens=cfg.n_frontend_tokens or None, drawn_nonzero=drawn,
               tol=LM_GATE_TOL,
               kernel_vs_plain_max_abs=route_err,
               kernel_vs_plain_last_prompt_position=last_err,
               logit_absmax=logit_absmax, top1_mismatches=bad, top1_near_ties=ties,
               prefill_vs_forward_max_abs=prefill_err,
               decode_vs_forward_max_abs=decode_err, decode_top1_equal=decode_top1,
               flash_launches_forward=flash_launches, ok=ok, smi=smi)
    emit(phase, **out)
    if not ok:
        raise AssertionError(f"LM float32 gate failed: {out}")
    return out


# ---- the training path ---------------------------------------------------
def flash_grads(torch, fn, q, k, v, do):
    """(o, dq, dk, dv) of ``fn(q, k, v)`` against the cotangent ``do``."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def train_check(torch, dev, smi):
    """The flash Function (kernel forward, plain chunked backward) at
    minicpm-2b's training shape against the plain version's autograd, f32
    (cuda_core) and bf16 (tensor_core), with one Function backward timed;
    then minicpm-2b at full width cut to 2 layers in f32: the loss and
    every gradient of one step on the kernel route (chunked) against the
    plain route (xla)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attn.ops import ROUTES, FlashAttnFn, flash_attn, flash_route
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.launch.roofline import PEAK_BF16_FLOPS, bound_ms, flash_counts
    from repro_torch.models import transformer as T

    cfg = lm_config(TRAIN_ARCH)
    B, S, H, K, dh = TRAIN_CHECK_B, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    chunk = cfg.attn_chunk
    fn = lambda a, b, c: FlashAttnFn.apply(a, b, c, True, chunk)
    plain = lambda a, b, c: flash_attn_ref(a, b, c, True)
    out = {}
    for i, dtype in enumerate(("float32", "bfloat16")):
        q, k, v = qkv(torch, dev, B, S, S, H, K, dh, dtype, seed=300 + i)
        do = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(310 + i),
                         device=dev).to(q.dtype)
        flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
        got = flash_grads(torch, fn, q, k, v, do)
        launches = dict(flash_attn.ROUTE_LAUNCHES)
        case = dict(dtype=dtype, route=flash_route("cuda", q.dtype, dh), launches=launches)
        ok = launches[case["route"]] == 1 and sum(launches.values()) == 1
        if dtype == "float32":
            want = flash_grads(torch, plain, q, k, v, do)
            atol, rtol = FLASH_TOL_F32
            for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
                d = (g - w).abs()
                case[f"{name}_max_abs_err"] = float(d.max())
                ok &= bool(torch.isfinite(g).all()) and bool((d <= atol + rtol * w.abs()).all())
            case.update(atol=atol, rtol=rtol)
        else:
            want = flash_grads(torch, plain, q.float(), k.float(), v.float(), do.float())
            lib = flash_grads(torch, lambda a, b, c: sdpa(torch, a, b, c, True), q, k, v, do)
            for name, g, w, lb in zip(("o", "dq", "dk", "dv"), got, want, lib):
                diff = (g.float() - w).abs()
                lib_row = (lb.float() - w).abs().amax(-1)
                lib_err = float(lib_row.max())
                limit = min(FLASH_BF16_LIBRARY_FACTOR * lib_err, FLASH_BF16_CEILING)
                elem = FLASH_BF16_STEP * w.abs() + FLASH_BF16_LIBRARY_FACTOR * lib_row[..., None]
                share = float((diff / elem.clamp_min(1e-30)).max())
                err = float(diff.max())
                case.update({f"{name}_max_abs_err": err, f"{name}_library_max_abs_err": lib_err,
                             f"{name}_tol": limit, f"{name}_elem_limit_share": share})
                ok &= bool(torch.isfinite(g).all()) and err <= limit and share <= 1.0
            del lib
            # one Function backward at this shape (a layer's micro-batch),
            # CUDA events: forward + backward less the forward
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            fwd_ms = time_ms(torch, lambda: fn(qr, kr, vr), 3)
            both_ms = time_ms(torch, lambda: torch.autograd.grad(fn(qr, kr, vr),
                                                                 (qr, kr, vr), do), 3)
            ops, nbytes = flash_counts(B, S, S, H, K, dh, 2, True)
            # a backward's products: 2.5 times the forward's (dv, dp, dq, dk
            # and the recomputed q k), twice its bytes
            bwd_bound, bwd_by = bound_ms(2.5 * ops, 2 * nbytes, PEAK_BF16_FLOPS)
            case.update(forward_ms=fwd_ms, backward_ms=both_ms - fwd_ms,
                        backward_bound_ms=bwd_bound, backward_bound_by=bwd_by)
            del qr, kr, vr
        case["ok"] = ok
        emit("train_check", case="flash_grads", B=B, S=S, H=H, K=K, dh=dh, causal=True,
             chunk=chunk, smi=smi, **case)
        if not ok:
            raise AssertionError(f"FlashAttnFn grads != plain version's ({dtype}): {case}")
        out[dtype] = case
        del q, k, v, do, got, want
        torch.cuda.empty_cache()

    # the 2-layer f32 model: kernel route vs plain route, loss and grads
    cfg2 = lm_config(TRAIN_ARCH, TRAIN_CHECK_LAYERS, dtype="float32")
    tc = TrainConfig(remat=True)
    params = T.init_params(cfg2, torch.Generator(dev).manual_seed(0), device=dev)
    toks = TokenStream(cfg2.vocab_size, TRAIN_CHECK_B, TRAIN_S, seed=1).batch_at(0)["tokens"]
    res = {}
    for impl in ("chunked", "xla"):
        c = dataclasses.replace(cfg2, attn_impl=impl)
        flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
        loss, _ = T.loss_fn(params, {"tokens": toks}, c, tc)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        res[impl] = (loss.item(), grads, dict(flash_attn.ROUTE_LAUNCHES))
        del loss
    (lk, gk, launch_k), (lx, gx, launch_x) = res["chunked"], res["xla"]
    names = [n for n, _ in params.named_parameters()]
    rel = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for n, a, b in zip(names, gk, gx)}
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    loss_rel = abs(lk - lx) / abs(lx)
    # the kernel once a layer in the forward and once in its remat recompute
    want_launches = {**dict.fromkeys(ROUTES, 0), "cuda_core": 2 * TRAIN_CHECK_LAYERS}
    ok = (finite and loss_rel <= TRAIN_GATE_TOL and rel[worst] <= TRAIN_GATE_TOL
          and launch_k == want_launches and not any(launch_x.values()))
    gate = dict(arch=TRAIN_ARCH, n_layers=TRAIN_CHECK_LAYERS, dtype="float32", tf32=False,
                B=TRAIN_CHECK_B, S=TRAIN_S, remat=True, loss_chunked=lk, loss_xla=lx,
                loss_rel_diff=loss_rel, grad_leaves=len(names),
                grad_max_rel_diff=rel[worst], grad_worst_leaf=worst,
                flash_launches_chunked=launch_k, flash_launches_xla=launch_x,
                tol=TRAIN_GATE_TOL, ok=ok)
    emit("train_check", case="minicpm_2_layers_f32", smi=smi, **gate)
    del params, res, gk, gx
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"training gate, chunked vs xla: {gate}")
    out["gate"] = gate
    return out


def train_step_phase(torch, dev, smi, check):
    """minicpm-2b whole trained through make_train_step (TRAIN_* above):
    the warm-up step (its operations counted by ``FlopCounterMode``: the
    first step, as the dry run's), then TRAIN_TIMED timed steps with the
    flash launch count set to 0 before each; step seconds, tokens/s, the 6NT model-FLOP
    share of 989 TFLOP/s (remat's extra forward not counted; the 8NT share
    beside it), peak memory, one traced step's busy share, each step's
    loss.  Every loss finite and the last below the first."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attn.ops import ROUTES, flash_attn
    from repro_torch.launch.roofline import PEAK_BF16_FLOPS
    from repro_torch.launch.steps import TrainState, make_train_step

    cfg = lm_config(TRAIN_ARCH)
    tc = TrainConfig(optimizer="adamw", moment_dtype="float32", schedule="wsd",
                     remat=True, microbatch=TRAIN_MICRO, warmup_steps=1,
                     total_steps=1 + TRAIN_TIMED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = TrainState.create(cfg, tc, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    batch = {"tokens": TokenStream(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0).batch_at(0)["tokens"]}
    step = make_train_step(cfg, tc, device=dev)
    # the warm-up step, its operations counted (the dry run is held to them)
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with counter:
        state, m = step(state, batch)
    losses = [float(m["loss"])]
    warm_s = time.perf_counter() - t0
    counted_flops = counter.get_total_flops()
    step_s, launches, lrs, gnorms = [], [], [], []
    for _ in range(TRAIN_TIMED):
        flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        launches.append(dict(flash_attn.ROUTE_LAUNCHES))
        lrs.append(float(m["lr"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev)
    holder = [state]

    def traced():
        holder[0], _ = step(holder[0], batch)

    busy = profile_busy(torch, traced, top=10, cpu=False)
    del holder, state, m
    torch.cuda.empty_cache()

    tokens = TRAIN_B * TRAIN_S
    mean_s = sum(step_s) / len(step_s)
    flops_6nt = 6.0 * n_params * tokens
    per_layer_mb = 2 * cfg.n_layers * (TRAIN_B // TRAIN_MICRO)
    want = {**dict.fromkeys(ROUTES, 0), "tensor_core": per_layer_mb}
    bwd_ms = check["bfloat16"]["backward_ms"]
    n_bwd = cfg.n_layers * (TRAIN_B // TRAIN_MICRO)
    out = dict(arch=TRAIN_ARCH, n_layers=cfg.n_layers, params=n_params, dtype=cfg.dtype,
               attn_impl=cfg.attn_impl, remat=tc.remat, optimizer=tc.optimizer,
               moment_dtype=tc.moment_dtype, schedule=tc.schedule, B=TRAIN_B, S=TRAIN_S,
               microbatch=TRAIN_MICRO, init_s=init_s, warmup_step_s=warm_s,
               step_s=step_s, step_s_mean=mean_s, tokens_per_s=tokens / mean_s,
               model_flops_6NT=flops_6nt,
               mfu_6NT_of_989=flops_6nt / mean_s / PEAK_BF16_FLOPS,
               mfu_8NT_with_remat_of_989=flops_6nt * 8 / 6 / mean_s / PEAK_BF16_FLOPS,
               peak_device_bytes=peak, flops_counted_one_step=counted_flops,
               losses=losses, lr=lrs, grad_norm=gnorms,
               flash_launches_per_step=launches,
               flash_backward_ms_one=bwd_ms,
               flash_backward_share_of_step=n_bwd * bwd_ms / 1e3 / mean_s,
               flash_backward_bound_share_of_step=n_bwd
               * check["bfloat16"]["backward_bound_ms"] / 1e3 / mean_s,
               profile_one_step=busy, smi=smi)
    emit("train_step", **out)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite and falling")
    if any(n != want for n in launches):
        raise AssertionError(f"flash launches a step {launches}, not {want}")
    return out


def leaves_equal(torch, a, b) -> bool:
    """Every leaf of two training states equal bit for bit."""
    from repro_torch.checkpoint.manager import _flatten

    fa, fb = _flatten(a), _flatten(b)
    return set(fa) == set(fb) and all(
        fa[k].dtype == fb[k].dtype and torch.equal(
            fa[k].detach().reshape(-1).view(torch.uint8),
            fb[k].detach().reshape(-1).view(torch.uint8)) for k in fa)


def train_cli(torch, dev, smi):
    """The train CLI's ``main`` (``python -m repro_torch.launch.train``'s
    code, called in this process to spare two processes' start on the
    card; smollm-135m, TRAIN_CLI_ARGS) for 6 steps, then for 9 on the same
    checkpoint directory, which must resume from step 6; then minicpm-2b
    at full width cut to 2 layers in bf16 (dense: every op of its step
    deterministic on the card): 6 steps straight against 3 steps, a
    checkpoint, a restore and 3 more, every leaf bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainState, make_train_step

    torch.cuda.empty_cache()
    ckpt_dir = ROOT / "build" / "smoke_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    runs = {}
    for n in (6, 9):
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            _, step_n, _ = train.main([*TRAIN_CLI_ARGS, "--steps", str(n),
                                       "--ckpt-dir", str(ckpt_dir)])
        torch.cuda.synchronize()
        lines = log.getvalue().strip().splitlines()
        runs[n] = dict(step=step_n, seconds=time.perf_counter() - t0,
                       resumed=[ln for ln in lines if ln.startswith("resumed from")],
                       last=lines[-1] if lines else None)
        print("\n".join(lines[-3:]), flush=True)
        torch.cuda.empty_cache()
    ok_cli = (runs[6]["step"] == 6 and runs[9]["step"] == 9 and not runs[6]["resumed"]
              and runs[9]["resumed"] == ["resumed from step 6"]
              and runs[6]["last"].startswith("done at step 6; final loss ")
              and runs[9]["last"].startswith("done at step 9; final loss ")
              and math.isfinite(float(runs[9]["last"].rsplit(" ", 1)[1])))

    cfg = lm_config(TRAIN_ARCH, TRAIN_CHECK_LAYERS)
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10, remat=True)
    stream = TokenStream(cfg.vocab_size, RESUME_B, RESUME_S, seed=0)
    ck = CheckpointManager(ROOT / "build" / "smoke_train_resume", keep_last=2)
    for s_ in ck.all_steps():
        shutil.rmtree(ck.dir / f"step_{s_:08d}")
    s0 = TrainState.create(cfg, tc, torch.Generator(dev).manual_seed(0), device=dev)
    ck.save(0, s0, blocking=True)
    step = make_train_step(cfg, tc, device=dev)
    sA = s0
    for i in range(6):
        sA, _ = step(sA, stream.batch_at(i))
    sB = ck.restore(0, sA)
    for i in range(3):
        sB, _ = step(sB, stream.batch_at(i))
    ck.save(3, sB, blocking=True)
    del sB  # "crash"
    n_restored, sB = ck.restore_latest(sA)
    for i in range(3, 6):
        sB, _ = step(sB, stream.batch_at(i))
    same = n_restored == 3 and leaves_equal(torch, sA, sB)
    del s0, sA, sB
    torch.cuda.empty_cache()
    retry = retry_case(torch, dev)
    out = dict(cli=runs, cli_ok=ok_cli, resume_arch=TRAIN_ARCH,
               resume_n_layers=TRAIN_CHECK_LAYERS, resume_dtype=cfg.dtype,
               resume_B=RESUME_B, resume_S=RESUME_S, resume_restored_step=n_restored,
               resume_bit_exact=same, retry=retry, smi=smi)
    emit("train_cli", **out)
    if not (ok_cli and same and retry["bit_exact"]):
        raise AssertionError(f"train_cli failed: {out}")
    return out


def retry_case(torch, dev) -> dict:
    """The resilient loop's retry with no checkpoint on disk: the train
    CLI's smollm-135m smoke model and train config (4 steps, its batch and
    sequence), the step raising after its update on its second call,
    save_every past the run; the final state bit-equal to a clean run's.
    Then the pre-step host snapshot's cost: one ``take`` of the CLI's
    smollm-135m state (full width) timed to a synchronize, five times,
    its bytes and rate, and minicpm-2b's state (TRAIN_ARCH: 2.72 B
    parameters, bf16 with float32 moments) reckoned at that rate."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.runtime.fault import HostSnapshot, ResilientLoop

    n_steps = 4
    B, S = int(TRAIN_CLI_ARGS[3]), int(TRAIN_CLI_ARGS[5])
    cfg = get_config("smollm-135m", smoke=True)
    tc = TrainConfig(lr=3e-4, total_steps=n_steps, warmup_steps=max(1, n_steps // 20))
    stream = TokenStream(cfg.vocab_size, B, S, seed=tc.seed)
    step = make_train_step(cfg, tc, device=dev)
    calls = {"n": 0}

    def fails_after_update(st, batch):
        calls["n"] += 1
        out = step(st, batch)
        torch.cuda.synchronize()
        if calls["n"] == 2:
            raise RuntimeError("injected failure after the update")
        return out

    ck = ROOT / "build" / "smoke_retry_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    loop = ResilientLoop(fails_after_update, CheckpointManager(ck), save_every=100)
    got, n_done, _ = loop.run(TrainState.create(cfg, tc, device=dev), stream.batch_at,
                              n_steps=n_steps)
    clean = TrainState.create(cfg, tc, device=dev)
    for i in range(n_steps):
        clean, _ = step(clean, stream.batch_at(i))
    same = n_done == n_steps and calls["n"] == n_steps + 1 and leaves_equal(torch, got, clean)
    del got, clean
    # the snapshot's cost at the CLI's model
    full = get_config("smollm-135m")
    st = TrainState.create(full, tc, device=dev)
    snap = HostSnapshot()
    take_s = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap.take(st)
        torch.cuda.synchronize()
        take_s.append(time.perf_counter() - t0)
    nbytes = snap.bytes()
    fstep = make_train_step(full, tc, device=dev)
    batch = stream.batch_at(0)
    st, _ = fstep(st, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = fstep(st, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del st, snap
    torch.cuda.empty_cache()
    mean_take = sum(take_s[1:]) / len(take_s[1:])  # the first take pins its buffers
    minicpm_bytes = 2_724_000_000 * (2 + 4 + 4)
    return dict(arch=cfg.name, steps=n_steps, B=B, S=S, failed_call=2,
                calls=calls["n"], bit_exact=same, snapshot_takes=loop.snapshot.takes,
                snapshot_arch="smollm-135m", snapshot_bytes=nbytes,
                snapshot_take_s=take_s, snapshot_take_s_mean=mean_take,
                snapshot_GBps=nbytes / mean_take / 1e9, cli_step_s=step_s,
                snapshot_share_of_step=mean_take / step_s,
                minicpm_2b_bytes=minicpm_bytes,
                minicpm_2b_take_s_reckoned=minicpm_bytes / (nbytes / mean_take))


# ------------------------------------------------------------ LM sharding
# The sharded LM paths (sharding/, launch/mesh.py): a world of rank
# processes of this script (``--shard-rank JOB``) joined through the
# EDM_* contract.  ``lm_shard_check``: minicpm-2b at full width cut to 2
# layers in float32, one sharded train step (FSDP on data, TP on model)
# against the single-process step at JAX's sharded tolerances (loss rtol
# 2e-5, parameters rtol 2e-3 / atol 2e-5); qwen2.5-3b at full width cut
# to 2 layers in float32, 4 x 512 prompt tokens and 8 greedy decode
# steps against the single-process run within LM_GATE_TOL; the moe and
# ssm families the same way (below).  Four ranks
# cannot share card 0: NCCL refuses two ranks on one card, and gloo
# crashes (SIGSEGV, every rank) in the functional all-gather that DTensor
# issues on CUDA tensors (``_c10d_functional.all_gather_into_tensor``;
# PERF.md, PR 26).  So the default run checks one NCCL rank at mesh (1,
# 1) -- the same code, every redistribution and the kernel on the rank's
# local heads -- and ``--multi-card`` four NCCL ranks, a card each, at
# mesh (2, 2) for the step and (1, 4) and (2, 2) for serving, then
# ``lm_shard_multi``: minicpm-2b whole (TRAIN_* above) at mesh (2, 2),
# and qwen2.5-3b whole at mesh (1, 4), 4 x 2,048 prompt tokens and 32
# decode steps; the moe and ssm runs below.
SHARD_TIMEOUT_S, MULTI_TIMEOUT_S = 900, 2400
SHARD_TRAIN_B, SHARD_TRAIN_S = 4, 256
SHARD_SERVE_B, SHARD_SERVE_S, SHARD_DECODE = 4, 512, 8
SHARD_MESHES = ((1, 4), (2, 2))
SHARD_TRAIN_TOL = dict(loss_rtol=2e-5, rtol=2e-3, atol=2e-5)
MULTI_TIMED = 3
# The moe and ssm families sharded (``lm_shard_check``, beside the dense
# checks above): dbrx-132b at full width in float32, one Adafactor step
# at 1 layer (4.5 B parameters, 18 GB, its gradients as much again) and
# serving at 2 layers; mamba2-2.7b at full width, 2 layers in float32,
# one AdamW step and serving; the state created shard by shard
# (``TrainState.create(policy=)``, ``place.init_sharded``); the loss
# within 1e-6 relative of the single-process step, every parameter within
# SHARD_TRAIN_TOL, the logits within LM_GATE_TOL, the routed and dropped
# counts summed over the ranks equal to the single process's.  With
# ``--multi-card`` each at meshes (1, 4) (expert-parallel: four of dbrx's
# 16 experts and 20 of mamba2's 80 SSD heads a rank) and (2, 2) (FSDP;
# the step's one MoE group of 1,024 tokens spans both data shards).
SHARD_MOE_TRAIN_LAYERS, SHARD_MOE_SERVE_LAYERS, SHARD_SSM_LAYERS = 1, 2, 2
SHARD_FAMILY_LOSS_RTOL = 1e-6
# ``lm_shard_multi``'s moe and ssm runs: dbrx-132b whole (40 layers,
# 131.6 B parameters, 263 GB in bf16: 65.8 GB a card at (1, 4), four of
# its 16 experts a card) served at (1, 4), 4 x 2,048 prompt tokens and 32
# greedy decode steps; dbrx-132b trained at (1, 4), its depth cut to
# MULTI_MOE_TRAIN_LAYERS (27.3 B parameters; 13.7 GB a card and its
# gradients as much), Adafactor, bf16, remat, train_4k's 4,096 tokens a
# sequence with its batch of 256 cut to MULTI_MOE_TRAIN_B; mamba2-2.7b
# whole trained at (2, 2) (AdamW, cosine, remat, 8 x 4,096 tokens in
# micro-batches of 2) and served at (1, 4) (4 x 2,048 and 32 decode
# steps).
MULTI_MOE_TRAIN_LAYERS, MULTI_MOE_TRAIN_B = 8, 4
MULTI_DECODE_STEPS = 32  # the four-card serving runs' greedy decode steps
# The hybrid, audio and vlm families sharded (``lm_shard_check``):
# zamba2-7b at full width cut to one unit (2 Mamba2 blocks and the shared
# block with the unit's LoRA: 3 of 81 layers), whisper-medium whole (0.88
# B: 24 encoder and 24 decoder layers over 1,500 frames; serving
# AUDIO_PROMPT tokens) and llama-3.2-vision-11b cut to one unit (4 self
# blocks and the gated cross block over 1,601 patches: 2.14 B
# parameters, 8.6 GB in float32, where AdamW's state would be ~34 GB, so
# one Adafactor step), each in float32, created shard by shard, the LoRA
# b and the gates drawn non-zero first (ZERO_LEAVES), against one process:
# the loss within SHARD_FAMILY_LOSS_RTOL, every parameter within
# SHARD_TRAIN_TOL, the logits within LM_GATE_TOL.  For every run of
# ``lm_shard_check``: each rank's flash launches by route equal to the one
# process's, and creation's peak above the local state by at most one
# leaf drawn whole (float32, its largest), plus CREATE_SLACK_BYTES of
# allocator rounding.  ``lm_shard_multi``'s runs of these families:
# llama-3.2-vision-11b whole trained at (2, 2) (bf16, AdamW, remat, train_4k's
# 4,096 tokens a sequence with its batch cut to MULTI_NEW_TRAIN_B, in
# micro-batches of TRAIN_MICRO, 1,601 patches a sequence; ~117 GB of state,
# ~29 GB a card) and served at (1, 4) (4 x 2,048 prompt tokens, 32 decode
# steps over the image cache on kv heads: 4 does not divide 1,601);
# whisper-medium whole served at (1, 4) (1,500 frames, 416 prompt tokens,
# 32 decode steps over the cross cache along the frames, 375 a card);
# zamba2-7b whole served at (1, 4) (4 x 2,048, 32 decode steps) and
# trained at (2, 2) (4 x 4,096, micro-batches of 2).  Each trains a
# warm-up step and MULTI_NEW_TIMED timed steps (the time limit is
# MULTI_TIMEOUT_S: timed steps are cut, never widths).
SHARD_HYBRID_LAYERS, SHARD_VLM_LAYERS = 3, 5
CREATE_SLACK_BYTES = 256 << 20
MULTI_NEW_TRAIN_B, MULTI_NEW_TIMED = 4, 2


def run_shard_world(world, job, tag, backend, ids=None, timeout=SHARD_TIMEOUT_S):
    """``world`` processes of ``chip_smoke.py --shard-rank job``, one a rank,
    joined through the EDM_* contract on localhost (rank r on card
    ``ids[r]``, else card r) on ``backend``; every rank is killed at the
    time limit.  Returns the ranks' records and return codes.

    The free port is picked before the ranks start, so another socket
    can take it in between (a client's connect to it may bind it as its
    own source port): where rank 0 could not listen on it, the world
    never formed, and it is started once more on a new port."""
    recs, rcs = _shard_world(world, job, tag, backend, ids, timeout)
    if "EADDRINUSE" in recs[0].get("log_tail", ""):
        recs, rcs = _shard_world(world, job, tag, backend, ids, timeout)
    return recs, rcs


def _shard_world(world, job, tag, backend, ids, timeout):
    """One start of :func:`run_shard_world`'s world."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = ROOT / "build" / f"smoke_shard_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = []
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "EDM_COORDINATOR": f"localhost:{port}", "EDM_NUM_PROCESSES": str(world),
               "EDM_PROCESS_ID": str(r), "EDM_SHARD_BACKEND": backend}
        env.pop("EDM_LOCAL_DEVICE_IDS", None)
        if ids is not None:
            env["EDM_LOCAL_DEVICE_IDS"] = str(ids[r])
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank", job,
             "--shard-out", str(out)], env=env, stdout=logs[r], stderr=subprocess.STDOUT))
    t_end = time.time() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, t_end - time.time())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()
    recs = []
    for r in range(world):
        f = out / f"rank{r}.json"
        recs.append(json.loads(f.read_text()) if f.exists() else
                    {"log_tail": (out / f"rank{r}.log").read_text()[-3000:]})
    return recs, rcs


def _flash_counts():
    from repro_torch.kernels.flash_attn.ops import ROUTES, flash_attn

    flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
    return flash_attn.ROUTE_LAUNCHES


def shard_meshes(world: int):
    """(the dense train step's mesh, the meshes of the other checks) of a
    world of ranks."""
    if world == 1:
        return (1, 1), ((1, 1),)
    return (2, 2), SHARD_MESHES


def _world_counts(torch, dev, model) -> list:
    """The MoE layers' (routed, dropped) assignments summed over every rank."""
    import torch.distributed as dist

    from repro_torch.models import moe as MOE

    c = torch.tensor(MOE.drop_counts(model), dtype=torch.int64, device=dev)
    dist.all_reduce(c)
    return [int(v) for v in c.tolist()]


def _cache_leaves(cache, prefix=""):
    """(path, tensor) of a cache, its nested dicts (the hybrid's ``ssm`` and
    ``attn``) joined with ':'."""
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{prefix}{k}:")
        else:
            yield prefix + k, v


def _local_bytes(tensors) -> int:
    from repro_torch.sharding.place import local

    return sum(local(t).numel() * local(t).element_size() for t in tensors)


def _opt_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _opt_tensors(v)
    else:
        yield tree


def _leaf_bytes(cfg) -> int:
    """Bytes of ``cfg``'s largest parameter drawn whole in float32 (as
    ``init_leaf`` draws it)."""
    import torch

    from repro_torch.models import transformer as T

    return 4 * max(p.numel() for p in T.LM(cfg, torch.device("meta")).parameters())


def shard_train_check(torch, dev, rank, arch, n_layers, optimizer, meshes,
                      loss_rtol, over=None) -> dict:
    """One train step of ``arch`` (full width, ``n_layers``, float32; audio
    frames or image patches from ``frontend``) at each mesh, the state
    created shard by shard, against the single-process step (rank 0 runs
    it first, alone on its card), the ZERO_LEAVES drawn non-zero in both:
    the loss within ``loss_rtol`` relative, every parameter within
    SHARD_TRAIN_TOL, the summed routed and dropped counts equal;
    creation's peak above the local state by at most one leaf drawn
    whole.  ``over``: config overrides (``attn_seq_shard``)."""
    import torch.distributed as dist

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.sharding import place as PL
    from repro_torch.sharding.policy import ShardingPolicy

    gen = lambda: torch.Generator(dev).manual_seed(0)
    cfg = lm_config(arch, n_layers, dtype="float32", **(over or {}))
    tc = TrainConfig(optimizer=optimizer, remat=False, lr=1e-3, warmup_steps=1,
                     total_steps=5)
    batch = {"tokens": TokenStream(cfg.vocab_size, SHARD_TRAIN_B, SHARD_TRAIN_S,
                                   seed=0).batch_at(0)["tokens"],
             **frontend(torch, T, cfg, SHARD_TRAIN_B, dev)}
    step = make_train_step(cfg, tc, device=dev)
    if rank == 0:
        ref = TrainState.create(cfg, tc, gen(), device=dev)
        nonzero_zero_leaves(torch, ref.params, dev)
        MOE.reset_drop_counts(ref.params)
        counts = _flash_counts()
        ref, m = step(ref, batch)
        ref_launches = dict(counts)
        ref_loss = float(m["loss"])
        ref_counts = list(MOE.drop_counts(ref.params))
        ref_params = {k: p.detach().cpu() for k, p in ref.params.named_parameters()}
        del ref, m
        torch.cuda.empty_cache()
    dist.barrier()
    out = {"arch": arch, "n_layers": n_layers, "dtype": "float32", "optimizer": optimizer,
           "B": SHARD_TRAIN_B, "S": SHARD_TRAIN_S, "meshes": {}}
    for shape in meshes:
        pol = ShardingPolicy(mesh=make_local_mesh(model=shape[1], device=dev), fsdp=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        st = TrainState.create(cfg, tc, gen(), device=dev, policy=pol)
        rec = {"create_peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
               "local_state_bytes": _local_bytes(list(st.params.parameters())
                                                 + list(_opt_tensors(st.opt))),
               "leaf_bytes": _leaf_bytes(cfg),
               "placement": st.params.placement_record["n_sharded"]}
        rec["create_ok"] = (rec["create_peak_bytes"] - rec["local_state_bytes"]
                            <= rec["leaf_bytes"] + CREATE_SLACK_BYTES)
        nonzero_zero_leaves(torch, st.params, dev)
        MOE.reset_drop_counts(st.params)
        counts = _flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        rec.update(step_s=time.perf_counter() - t0, flash_launches=dict(counts),
                   loss=float(m["loss"]), counts=_world_counts(torch, dev, st.params))
        worst = float("-inf")
        for k, p in st.params.named_parameters():
            whole = PL.full(p).detach()
            if rank == 0:
                want = ref_params[k].to(dev)
                excess = ((whole - want).abs() - SHARD_TRAIN_TOL["atol"]
                          - SHARD_TRAIN_TOL["rtol"] * want.abs()).max()
                worst = max(worst, float(excess))
            del whole
        del st, m
        torch.cuda.empty_cache()
        if rank == 0:
            rel = abs(rec["loss"] - ref_loss) / abs(ref_loss)
            rec.update(ref_loss=ref_loss, loss_rel_diff=rel, params_worst_excess=worst,
                       ref_counts=ref_counts, loss_rtol=loss_rtol,
                       ref_flash_launches=ref_launches,
                       ok=(rel <= loss_rtol and worst <= 0.0
                           and rec["counts"] == ref_counts and rec["create_ok"]))
        out["meshes"]["x".join(map(str, shape))] = rec
    return out


def shard_serve_check(torch, dev, rank, arch, n_layers, meshes, over=None) -> dict:
    """``arch`` (full width, ``n_layers``, float32) served at each mesh
    (created shard by shard, the ZERO_LEAVES drawn non-zero):
    SHARD_SERVE_B x SHARD_SERVE_S prompt tokens (whisper: AUDIO_PROMPT)
    with their frames or patches, and SHARD_DECODE greedy decode steps
    over the sharded cache, against the single-process run (rank 0,
    first) within LM_GATE_TOL; the summed routed and dropped counts
    equal.  ``over``: config overrides (``attn_seq_shard``)."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.sharding import place as PL
    from repro_torch.sharding.policy import ShardingPolicy

    gen = lambda: torch.Generator(dev).manual_seed(0)
    cfg = lm_config(arch, n_layers, dtype="float32", **(over or {}))
    B, n = SHARD_SERVE_B, SHARD_DECODE
    S = AUDIO_PROMPT if cfg.family == "audio" else SHARD_SERVE_S
    toks = TokenStream(cfg.vocab_size, B, S, seed=1).batch_at(0)["tokens"]
    prompt = {"tokens": toks, **frontend(torch, T, cfg, B, dev, seed=1)}
    tok_file = ROOT / "build" / f"smoke_shard_serve_tokens_{arch}.pt"
    decode = make_decode_step(cfg, device=dev)
    if rank == 0:
        params = T.init_params(cfg, gen(), dev)
        nonzero_zero_leaves(torch, params, dev)
        MOE.reset_drop_counts(params)
        counts = _flash_counts()
        logits, cache = make_prefill_step(cfg, device=dev)(params, prompt)
        ref_launches = dict(counts)
        want = {"prefill": logits.cpu()}
        cache = grown_cache(T, cfg, cache, B, S, S + n, dev)
        tok = logits[:, -1:].argmax(-1)
        dec = []
        for i in range(n):
            dec.append(tok.cpu())
            lg, cache = decode(params, {"token": tok, "pos": S + i}, cache)
            want[f"decode{i}"] = lg.cpu()
            tok = lg.argmax(-1)
        ref_counts = list(MOE.drop_counts(params))
        torch.save(dec, tok_file)
        del params, cache, logits, lg
        torch.cuda.empty_cache()
    dist.barrier()
    dec = torch.load(tok_file)
    out = {"arch": arch, "n_layers": n_layers, "dtype": "float32", "B": B, "prompt": S,
           "decode_steps": n, "meshes": {}}
    for shape in meshes:
        pol = ShardingPolicy(mesh=make_local_mesh(model=shape[1], device=dev))
        params = PL.init_sharded(cfg, pol, gen())
        nonzero_zero_leaves(torch, params, dev)
        MOE.reset_drop_counts(params)
        counts = _flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(cfg, policy=pol, device=dev)(params, prompt)
        torch.cuda.synchronize()
        rec = {"prefill_s": time.perf_counter() - t0, "flash_launches": dict(counts),
               "cache_local": {k: list(PL.local(v).shape) for k, v in _cache_leaves(cache)}}
        errs = {"prefill": PL.full(logits)}
        cache = PL.grow_cache(cache, cfg, S + n, pol)
        for i in range(n):
            lg, cache = decode(params, {"token": dec[i].to(dev), "pos": S + i}, cache)
            errs[f"decode{i}"] = PL.full(lg)
        rec["counts"] = _world_counts(torch, dev, params)
        if rank == 0:
            rec["max_abs_err"] = {k: float((v.float().cpu() - want[k]).abs().max())
                                  for k, v in errs.items()}
            rec.update(ref_counts=ref_counts, ref_flash_launches=ref_launches,
                       ok=(max(rec["max_abs_err"].values()) <= LM_GATE_TOL
                           and rec["counts"] == ref_counts))
        out["meshes"]["x".join(map(str, shape))] = rec
        del params, cache, logits, lg, errs
        torch.cuda.empty_cache()
    return out


#: lm_shard_check's runs: (record key, kind, arch, n_layers, optimizer, loss rtol)
SHARD_CHECKS = (
    ("train", "train", TRAIN_ARCH, TRAIN_CHECK_LAYERS, "adamw", SHARD_TRAIN_TOL["loss_rtol"]),
    ("serve", "serve", LM_ARCH, 2, None, None),
    ("moe_train", "train", MOE_ARCH, SHARD_MOE_TRAIN_LAYERS, "adafactor",
     SHARD_FAMILY_LOSS_RTOL),
    ("moe_serve", "serve", MOE_ARCH, SHARD_MOE_SERVE_LAYERS, None, None),
    ("ssm_train", "train", SSM_ARCH, SHARD_SSM_LAYERS, "adamw", SHARD_FAMILY_LOSS_RTOL),
    ("ssm_serve", "serve", SSM_ARCH, SHARD_SSM_LAYERS, None, None),
    ("hybrid_train", "train", HYBRID_ARCH, SHARD_HYBRID_LAYERS, "adamw",
     SHARD_FAMILY_LOSS_RTOL),
    ("hybrid_serve", "serve", HYBRID_ARCH, SHARD_HYBRID_LAYERS, None, None),
    ("audio_train", "train", AUDIO_ARCH, None, "adamw", SHARD_FAMILY_LOSS_RTOL),
    ("audio_serve", "serve", AUDIO_ARCH, None, None, None),
    ("vlm_train", "train", VLM_ARCH, SHARD_VLM_LAYERS, "adafactor", SHARD_FAMILY_LOSS_RTOL),
    ("vlm_serve", "serve", VLM_ARCH, SHARD_VLM_LAYERS, None, None),
)


def shard_check_rank(torch, dev, rank, rec: dict) -> dict:
    """A rank of ``lm_shard_check`` (module comment above), its runs'
    records into ``rec``: the dense family's step (minicpm-2b, at the
    dense step's mesh) and serving (qwen2.5-3b), then the moe, ssm,
    hybrid, audio and vlm families' steps and serving, each against the
    single-process run; each rank reports its flash launches by route."""
    import torch.distributed as dist

    dense_mesh, meshes = shard_meshes(dist.get_world_size())
    for key, kind, arch, n_layers, opt, loss_rtol in SHARD_CHECKS:
        if kind == "train":
            rec[key] = shard_train_check(torch, dev, rank, arch, n_layers, opt,
                                         (dense_mesh,) if key == "train" else meshes,
                                         loss_rtol)
        else:
            rec[key] = shard_serve_check(torch, dev, rank, arch, n_layers, meshes)
    if rank == 0:
        rec["ok"] = all(m["ok"] for key, *_ in SHARD_CHECKS
                        for m in rec[key]["meshes"].values())
    return rec


def _timed_steps(torch, dist, step, st, batch, n_timed):
    """A warm-up step, then ``n_timed`` timed ones (each between barriers),
    the flash launches of each."""
    t0 = time.perf_counter()
    st, m = step(st, batch)
    losses = [float(m["loss"])]
    warm = time.perf_counter() - t0
    step_s, launches = [], []
    for _ in range(n_timed):
        counts = _flash_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        dist.barrier()
        step_s.append(time.perf_counter() - t0)
        launches.append(dict(counts))
    return st, {"warmup_step_s": warm, "step_s": step_s, "losses": losses,
                "flash_launches_per_step": launches}


def _sampler(rank):
    """Rank 0 samples every card's busy share over a window."""
    from repro_torch.runtime.device import BusySampler

    import torch

    return BusySampler(torch.cuda.device_count()) if rank == 0 else None


def _sampled(sampler):
    return sampler.stop() if sampler is not None else None


def multi_train(torch, dev, rank, cfg, tc, mesh_shape, B, S, sampler_on=True,
                n_timed=MULTI_TIMED) -> dict:
    """``cfg`` trained at ``mesh_shape`` (auto_policy), the state created
    shard by shard: a warm-up step and ``n_timed`` timed steps, each card's
    busy share sampled over them; the batch's frames or patches from
    ``frontend``."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.sharding.policy import auto_policy, estimate_params

    pol = auto_policy(cfg, make_local_mesh(model=mesh_shape[1], device=dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    st = TrainState.create(cfg, tc, torch.Generator(dev).manual_seed(0), device=dev,
                           policy=pol)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    create_peak = torch.cuda.max_memory_allocated(dev)
    batch = {"tokens": TokenStream(cfg.vocab_size, B, S, seed=0).batch_at(0)["tokens"],
             **frontend(torch, T, cfg, B, dev)}
    step = make_train_step(cfg, tc, device=dev)
    dist.barrier()
    sampler = _sampler(rank) if sampler_on else None
    st, rec = _timed_steps(torch, dist, step, st, batch, n_timed)
    rec.update(busy=_sampled(sampler), arch=cfg.name, n_layers=cfg.n_layers,
               params=estimate_params(cfg), dtype=cfg.dtype, mesh=list(mesh_shape),
               fsdp=pol.fsdp, optimizer=tc.optimizer, B=B, S=S, microbatch=tc.microbatch,
               create_s=create_s, create_peak_bytes=create_peak,
               peak_device_bytes=torch.cuda.max_memory_allocated(dev),
               placement={k: v for k, v in st.params.placement_record.items()
                          if k != "degraded"},
               degraded=len(st.params.placement_record["degraded"]))
    del st
    torch.cuda.empty_cache()
    return rec


def multi_serve(torch, dev, rank, cfg, mesh_shape, profile_decode=False) -> dict:
    """``cfg`` served at ``mesh_shape`` (created shard by shard): a warm-up
    prefill, the timed prefill of SERVE_B x ``serve_prompt`` tokens with
    their frames or patches (flash launches counted) and MULTI_DECODE_STEPS
    greedy decode steps, each card's busy share sampled over them; the MoE
    assignments routed and dropped."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.sharding import place as PL
    from repro_torch.sharding.policy import ShardingPolicy

    pol = ShardingPolicy(mesh=make_local_mesh(model=mesh_shape[1], device=dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = PL.init_sharded(cfg, pol, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    create_peak = torch.cuda.max_memory_allocated(dev)
    local_bytes = _local_bytes(params.parameters())
    S = serve_prompt(cfg)
    prompt = {"tokens": TokenStream(cfg.vocab_size, SERVE_B, S, seed=1).batch_at(0)["tokens"],
              **frontend(torch, T, cfg, SERVE_B, dev, seed=1)}
    prefill = make_prefill_step(cfg, policy=pol, device=dev)
    decode = make_decode_step(cfg, device=dev)
    prefill(params, prompt)  # warm-up
    MOE.reset_drop_counts(params)
    counts = _flash_counts()
    torch.cuda.synchronize()
    dist.barrier()
    sampler = _sampler(rank)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    flash = dict(counts)
    prefill_counts = _world_counts(torch, dev, params)
    cache = PL.grow_cache(cache, cfg, S + MULTI_DECODE_STEPS, pol)
    tok = PL.full(logits[:, -1:]).argmax(-1)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(MULTI_DECODE_STEPS):
        lg, cache = decode(params, {"token": tok, "pos": S + i}, cache)
        tok = PL.full(lg).argmax(-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / MULTI_DECODE_STEPS * 1e3
    busy = _sampled(sampler)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "mesh": list(mesh_shape), "B": SERVE_B, "prompt": S,
           "decode_steps": MULTI_DECODE_STEPS, "create_s": create_s,
           "create_peak_bytes": create_peak, "local_param_bytes": local_bytes,
           "prefill_s": prefill_s, "decode_ms_per_step": decode_ms, "flash_launches": flash,
           "prefill_counts": prefill_counts, "busy": busy,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
           "finite": bool(torch.isfinite(PL.local(lg)).all())}
    if profile_decode:  # where one sharded decode step's host time goes
        from torch.profiler import ProfilerActivity, profile

        grown = PL.grow_cache(cache, cfg, S + MULTI_DECODE_STEPS + 1, pol)
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode(params, {"token": tok, "pos": S + MULTI_DECODE_STEPS}, grown)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                      reverse=True)
        rec.update(traced_decode_s=traced_s,
                   traced_decode_device_busy_s=sum(
                       r[0] for r in _device_time_by_kernel(prof)) / 1e6,
                   traced_decode_host_top=[{"name": e.key[:80],
                                            "self_cpu_s": e.self_cpu_time_total / 1e6,
                                            "calls": e.count} for e in rows[:10]])
        del grown
    del params, cache, logits, lg
    torch.cuda.empty_cache()
    return rec


#: lm_shard_multi's runs in order: ("train", record key, arch, n_layers, mesh,
#: B, TrainConfig keywords, timed steps) or ("serve", record key, arch, a
#: traced decode), served at (1, 4)
_ADAMW_REMAT = dict(optimizer="adamw", moment_dtype="float32", remat=True,
                    microbatch=TRAIN_MICRO, warmup_steps=1)
MULTI_RUNS = (
    ("train", "train", TRAIN_ARCH, None, (2, 2), TRAIN_B,
     dict(_ADAMW_REMAT, schedule="wsd"), MULTI_TIMED),
    ("serve", "serve", LM_ARCH, True),
    ("serve", "moe_serve", MOE_ARCH, True),
    ("train", "moe_train", MOE_ARCH, MULTI_MOE_TRAIN_LAYERS, (1, 4), MULTI_MOE_TRAIN_B,
     dict(optimizer="adafactor", schedule="cosine", remat=True, warmup_steps=1),
     MULTI_TIMED),
    ("train", "ssm_train", SSM_ARCH, None, (2, 2), TRAIN_B,
     dict(_ADAMW_REMAT, schedule="cosine"), MULTI_TIMED),
    ("serve", "ssm_serve", SSM_ARCH, False),
    ("serve", "hybrid_serve", HYBRID_ARCH, False),
    ("serve", "audio_serve", AUDIO_ARCH, False),
    ("serve", "vlm_serve", VLM_ARCH, False),
    ("train", "hybrid_train", HYBRID_ARCH, None, (2, 2), MULTI_NEW_TRAIN_B,
     dict(_ADAMW_REMAT, schedule="cosine"), MULTI_NEW_TIMED),
    ("train", "vlm_train", VLM_ARCH, None, (2, 2), MULTI_NEW_TRAIN_B,
     dict(_ADAMW_REMAT, schedule="cosine"), MULTI_NEW_TIMED),
)


def shard_multi_rank(torch, dev, rank, rec: dict) -> dict:
    """A rank of ``lm_shard_multi``, its runs' records into ``rec`` (the
    runs of MULTI_RUNS): minicpm-2b whole trained at
    mesh (2, 2) and qwen2.5-3b whole served at (1, 4); dbrx-132b whole
    served at (1, 4) and trained at (1, 4) at MULTI_MOE_TRAIN_LAYERS;
    mamba2-2.7b whole trained at (2, 2) and served at (1, 4); zamba2-7b,
    whisper-medium and llama-3.2-vision-11b whole served at (1, 4), and
    zamba2-7b and llama-3.2-vision-11b whole trained at (2, 2) (module
    comment above)."""
    from repro_torch.configs.base import TrainConfig

    for kind, key, arch, *more in MULTI_RUNS:
        if kind == "serve":
            rec[key] = multi_serve(torch, dev, rank, lm_config(arch), (1, 4),
                                   profile_decode=more[0])
        else:
            n_layers, mesh, B, kw, n_timed = more
            tc = TrainConfig(total_steps=1 + n_timed, **kw)
            rec[key] = multi_train(torch, dev, rank, lm_config(arch, n_layers), tc, mesh,
                                   B, TRAIN_S, n_timed=n_timed)

    def run_ok(kind, key, arch) -> bool:  # finite; a flash launch a step but in ssm
        r = rec[key]
        if kind == "serve":
            return r["finite"]
        return (all(math.isfinite(x) for x in r["losses"])
                and (arch == SSM_ARCH
                     or all(sum(n.values()) > 0 for n in r["flash_launches_per_step"])))

    rec["ok"] = all(run_ok(kind, key, arch) for kind, key, arch, *_ in MULTI_RUNS)
    return rec


# ``lm_seq_multi`` (``--multi-card``): sequence-parallel attention across
# four cards.  smollm-135m whole (bf16; 9 heads, 3 kv heads: 4 divides
# neither) served at (1, 4), SEQ_SERVE_B x SEQ_SERVE_S prompt tokens with
# and without ``attn_seq_shard``, each timed, their logits within
# LM_GATE_TOL of each other; minicpm-2b at 2 layers in float32 with
# ``attn_seq_shard``: a train step and serving at (1, 4) against one
# process (``lm_shard_check``'s gates); and ``lm_shard_multi``'s minicpm-2b
# step at (2, 2) (TRAIN_* above) on rank 0 -- one step under CommDebugMode
# and one under the dry run's DeviceCounter, the peak over creation and
# steps -- against the dry run of that step on a fake (2, 2) world: each
# collective kind's count (CommDebugMode's) and bytes equal, the peak
# within DRY_PEAK_TOL.
SEQ_ARCH, SEQ_SERVE_B, SEQ_SERVE_S, SEQ_TIMED = "smollm-135m", 4, 8192, 3


def _coll_kinds(counts: dict) -> dict:
    """CommDebugMode's counts by collective operator -> by JAX's kind."""
    from repro_torch.launch.dryrun import _COLL_KINDS

    out = {}
    for op, n in counts.items():
        kind = _COLL_KINDS.get(getattr(op, "__name__", str(op)).split(".")[-1], str(op))
        out[kind] = out.get(kind, 0) + n
    return out


def seq_serve_compare(torch, dev, rank) -> dict:
    """smollm-135m whole served at (1, 4) with and without
    ``attn_seq_shard``: a warm-up and SEQ_TIMED timed prefills each, the
    flash launches (with positions) of one; the largest logit difference
    over every rank's local shard."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attn.ops import ROUTES, flash_attn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.sharding import place as PL
    from repro_torch.sharding.policy import ShardingPolicy

    pol = ShardingPolicy(mesh=make_local_mesh(model=4, device=dev))
    base = lm_config(SEQ_ARCH)
    params = PL.init_sharded(base, pol, torch.Generator(dev).manual_seed(0))
    prompt = {"tokens": TokenStream(base.vocab_size, SEQ_SERVE_B, SEQ_SERVE_S,
                                    seed=2).batch_at(0)["tokens"]}
    out, logits = {}, {}
    for tag, flag in (("plain", False), ("seq_shard", True)):
        step = make_prefill_step(dataclasses.replace(base, attn_seq_shard=flag), pol, dev)
        lg, _ = step(params, prompt)  # warm-up
        del lg
        times = []
        for _ in range(SEQ_TIMED):
            counts = _flash_counts()
            flash_attn.POSITION_LAUNCHES = dict.fromkeys(ROUTES, 0)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            lg, cache = step(params, prompt)
            torch.cuda.synchronize()
            dist.barrier()
            times.append(time.perf_counter() - t0)
            del cache
        logits[tag] = PL.local(lg)
        out[tag] = dict(prefill_s=times, flash_launches=dict(counts),
                        position_launches=dict(flash_attn.POSITION_LAUNCHES))
    diff = (logits["plain"].float() - logits["seq_shard"].float()).abs().max()
    dist.all_reduce(diff, op=dist.ReduceOp.MAX)
    out.update(arch=SEQ_ARCH, B=SEQ_SERVE_B, S=SEQ_SERVE_S, mesh=[1, 4],
               max_abs_logit_diff=float(diff), tol=LM_GATE_TOL,
               ok=float(diff) <= LM_GATE_TOL and out["seq_shard"]["position_launches"]
               .get("tensor_core", 0) == base.n_layers)
    del params, logits, lg
    torch.cuda.empty_cache()
    return out


def counted_train_step(torch, dev, rank) -> dict:
    """``lm_shard_multi``'s minicpm-2b step at (2, 2): created shard by
    shard, a warm-up step, one step under CommDebugMode, one under the dry
    run's DeviceCounter; the peak over all of it."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.dryrun import DeviceCounter
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.sharding.policy import auto_policy

    cfg = lm_config(TRAIN_ARCH)
    tc = TrainConfig(**train_tc_kw())
    mesh = make_local_mesh(model=2, device=dev)
    pol = auto_policy(cfg, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    st = TrainState.create(cfg, tc, torch.Generator(dev).manual_seed(0), device=dev,
                           policy=pol)
    batch = {"tokens": TokenStream(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0).batch_at(0)["tokens"]}
    step = make_train_step(cfg, tc, device=dev)
    st, m = step(st, batch)
    comm = CommDebugMode()
    with comm:
        st, m = step(st, batch)
    counter = DeviceCounter(mesh)
    with counter:
        st, m = step(st, batch)
    torch.cuda.synchronize()
    rec = dict(arch=TRAIN_ARCH, mesh=[2, 2], fsdp=pol.fsdp, B=TRAIN_B, S=TRAIN_S,
               microbatch=TRAIN_MICRO, peak_device_bytes=torch.cuda.max_memory_allocated(dev),
               comm_counts=_coll_kinds(comm.get_comm_counts()),
               counted=counter.coll_summary(), counted_flops=counter.flops,
               loss=float(m["loss"]))
    del st, m
    torch.cuda.empty_cache()
    return rec


def seq_multi_rank(torch, dev, rank, rec: dict) -> dict:
    """A rank of ``lm_seq_multi`` (the comment above), its runs into ``rec``."""
    rec["serve_compare"] = seq_serve_compare(torch, dev, rank)
    over = {"attn_seq_shard": True}
    rec["train"] = shard_train_check(torch, dev, rank, TRAIN_ARCH, TRAIN_CHECK_LAYERS,
                                     "adamw", ((1, 4),), SHARD_TRAIN_TOL["loss_rtol"], over)
    rec["serve"] = shard_serve_check(torch, dev, rank, TRAIN_ARCH, TRAIN_CHECK_LAYERS,
                                     ((1, 4),), over)
    rec["counted_step"] = counted_train_step(torch, dev, rank)
    if rank == 0:
        rec["ok"] = (rec["serve_compare"]["ok"]
                     and all(m["ok"] for k in ("train", "serve")
                             for m in rec[k]["meshes"].values()))
    return rec


def lm_seq_multi(torch, smi) -> dict:
    """``--multi-card``: four NCCL ranks, a card each (the comment above),
    the dry run of the (2, 2) step after them."""
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        emit("lm_seq_multi", note=f"not run: {n_cards} card(s) visible, four needed",
             smi=smi)
        return None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs, rcs = run_shard_world(4, "seq", "seq", "nccl", ids=(0, 1, 2, 3),
                                timeout=MULTI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = dict(world=4, backend="nccl", rcs=rcs, wall_s=wall, smi=smi,
               errors=[r.get("error") or r.get("log_tail") for r in recs
                       if "error" in r or "log_tail" in r])
    ok = rcs == [0] * 4 and bool(recs[0].get("ok"))
    if rcs == [0] * 4:
        r0 = recs[0]
        out.update(serve_compare=r0["serve_compare"], train=r0["train"], serve=r0["serve"],
                   flash_launches_by_rank=[r["serve_compare"]["seq_shard"]["position_launches"]
                                           for r in recs])
        dry = run_dry_jobs([dry_spec(
            "train_step_2x2", TRAIN_ARCH, ["train_step", "train", TRAIN_S, TRAIN_B],
            over=dict(attn_impl="chunked"), tc=train_tc_kw(),
            mesh=[[2, 2], ["data", "model"]])])["train_step_2x2"]
        real = r0["counted_step"]
        pred_counts = {k: sum(ax.values()) for k, ax in dry["collectives"]["counts"].items()}
        pred_bytes = {k: sum(ax.values()) for k, ax in dry["collectives"]["bytes"].items()}
        real_bytes = {k: sum(ax.values()) for k, ax in real["counted"]["bytes"].items()}
        peak_rel = dry["memory"]["peak_bytes_per_device"] / real["peak_device_bytes"] - 1.0
        out["dryrun_2x2"] = dict(
            predicted_counts=pred_counts, commdebug_counts=real["comm_counts"],
            predicted_bytes=pred_bytes, counted_bytes=real_bytes,
            predicted_peak_bytes=dry["memory"]["peak_bytes_per_device"],
            measured_peak_bytes=real["peak_device_bytes"], peak_rel_err=peak_rel,
            predicted_flops=dry["roofline"]["flops_per_chip"],
            counted_flops=real["counted_flops"], trace_s=dry["trace_s"],
            links=dry["roofline"]["links"])
        ok = (ok and pred_counts == real["comm_counts"] and pred_bytes == real_bytes
              and abs(peak_rel) <= DRY_PEAK_TOL)
    else:  # the world failed: its dry run is not read
        for _, proc, log, _ in jobs.values():
            proc.kill()
            proc.wait()
            log.close()
    out["ok"] = ok
    emit("lm_seq_multi", **out)
    if not ok:
        raise AssertionError(f"lm_seq_multi failed: rcs {rcs}")
    return out


def shard_rank(job, out) -> int:
    """``--shard-rank``: this process is a rank of ``run_shard_world``."""
    import faulthandler
    import os
    import traceback

    import torch

    from repro_torch.runtime.platform import distributed_spec_from_env, init_distributed

    faulthandler.enable()  # a crash in a collective prints its Python stack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = distributed_spec_from_env()
    info = init_distributed(spec, backend=os.environ.get("EDM_SHARD_BACKEND") or None)
    rank = spec["process_id"]
    dev = torch.device(info["device"])
    rec = {"rank": rank, "device": str(dev), "backend": info["backend"]}
    try:
        fn = {"check": shard_check_rank, "multi": shard_multi_rank,
              "seq": seq_multi_rank}[job]
        fn(torch, dev, rank, rec)  # fills rec run by run: a failure keeps the runs before
        rc = 0
    except Exception:  # noqa: BLE001 -- reported, and the rank exits non-zero
        rec["error"] = traceback.format_exc()[-4000:]
        rc = 1
    pathlib.Path(out, f"rank{rank}.json").write_text(json.dumps(rec))
    import torch.distributed as dist

    dist.destroy_process_group()
    return rc


def lm_shard_check(torch, smi, world=1):
    """``world`` NCCL ranks, rank r on card r (module comment above): every
    check within its gate on rank 0, the flash kernel launched on every
    rank in each dense and moe run and never in an ssm run."""
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.device_count() < world:
        emit("lm_shard_check", world=world, note=f"not run: {world} cards needed, "
             f"{torch.cuda.device_count()} visible", smi=smi)
        return None
    ids = tuple(range(world))
    t0 = time.perf_counter()
    recs, rcs = run_shard_world(world, "check", f"check{world}", "nccl", ids=ids)
    r0 = recs[0]
    launches = [{f"{key}_{m}": v.get("flash_launches")
                 for key, *_ in SHARD_CHECKS
                 for m, v in r.get(key, {}).get("meshes", {}).items()} for r in recs]
    want = {f"{key}_{m}": v.get("ref_flash_launches")
            for key, *_ in SHARD_CHECKS for m, v in r0.get(key, {}).get("meshes", {}).items()}
    out = dict(world=world, backend="nccl", card_ids=list(ids), rcs=rcs,
               seconds=time.perf_counter() - t0,
               **{key: r0.get(key) for key, *_ in SHARD_CHECKS},
               flash_launches_by_rank=launches, one_process_flash_launches=want,
               errors=[r.get("error") or r.get("log_tail") for r in recs
                       if "error" in r or "log_tail" in r], smi=smi)
    emit("lm_shard_check", **out)
    if rcs != [0] * world or not r0.get("ok"):
        raise AssertionError(f"lm_shard_check failed: rcs {rcs}")
    for r, by_run in enumerate(launches):
        for name in want:
            n = by_run.get(name)
            if name.startswith("ssm_"):
                if n is None or sum(n.values()) != 0:
                    raise AssertionError(f"rank {r} {name}: a flash launch {n}")
            elif not n or sum(n.values()) == 0:
                raise AssertionError(f"rank {r} {name}: no flash launch {n}")
            if n != want[name]:
                raise AssertionError(f"rank {r} {name}: flash launches {n}, one "
                                     f"process's {want[name]}")
    return out


def active_params(cfg) -> int:
    """The parameters one token passes through: every parameter but the
    experts it is not routed to (top-k of E)."""
    from repro_torch.sharding.policy import estimate_params

    n = estimate_params(cfg)
    if cfg.n_experts:
        per = (3 if cfg.mlp_act == "swiglu" else 2) * cfg.d_model * cfg.d_ff
        n -= cfg.n_layers * per * (cfg.n_experts - cfg.experts_per_tok)
    return n


def _multi_train_summary(tr, one_card_loss=None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import PEAK_BF16_FLOPS

    t = tr[0]
    mean_s = max(sum(x["step_s"]) / len(x["step_s"]) for x in tr)
    tokens = t["B"] * t["S"]
    arch = t["arch"]
    cfg = dataclasses.replace(get_config(arch), n_layers=t["n_layers"])
    n_active = active_params(cfg)
    out = dict({k: t[k] for k in ("arch", "n_layers", "params", "dtype", "mesh", "fsdp",
                                  "optimizer", "B", "S", "microbatch", "placement",
                                  "degraded")},
               active_params=n_active,
               step_s_by_rank=[x["step_s"] for x in tr], step_s_mean=mean_s,
               warmup_step_s=[x["warmup_step_s"] for x in tr],
               tokens_per_s=tokens / mean_s,
               mfu_6NT_of_4x989=6.0 * n_active * tokens / mean_s / (4 * PEAK_BF16_FLOPS),
               create_s_by_rank=[x["create_s"] for x in tr],
               create_peak_bytes_by_rank=[x["create_peak_bytes"] for x in tr],
               peak_device_bytes_by_rank=[x["peak_device_bytes"] for x in tr],
               busy=t["busy"], losses=t["losses"],
               flash_launches_per_step_by_rank=[x["flash_launches_per_step"] for x in tr])
    if one_card_loss is not None:
        out.update(one_card_first_loss=one_card_loss,
                   first_loss_rel_diff=abs(t["losses"][0] - one_card_loss) / one_card_loss)
    return out


def _multi_serve_summary(sv) -> dict:
    s = sv[0]
    routed, dropped = s["prefill_counts"]
    out = dict({k: s[k] for k in ("arch", "n_layers", "dtype", "mesh", "B", "prompt",
                                  "decode_steps")},
               prefill_s_by_rank=[x["prefill_s"] for x in sv],
               decode_ms_per_step_by_rank=[x["decode_ms_per_step"] for x in sv],
               create_s_by_rank=[x["create_s"] for x in sv],
               create_peak_bytes_by_rank=[x["create_peak_bytes"] for x in sv],
               local_param_bytes_by_rank=[x["local_param_bytes"] for x in sv],
               peak_device_bytes_by_rank=[x["peak_device_bytes"] for x in sv],
               flash_launches_by_rank=[x["flash_launches"] for x in sv],
               busy=s["busy"], prefill_routed=routed, prefill_dropped=dropped,
               prefill_dropped_share=dropped / routed if routed else None)
    if "traced_decode_s" in s:
        out["traced_decode"] = dict(wall_s=s["traced_decode_s"],
                                    device_busy_s=s["traced_decode_device_busy_s"],
                                    host_top=s["traced_decode_host_top"])
    return out


def lm_shard_multi(torch, dev, smi):
    """``--multi-card``: the single-card minicpm-2b step's loss (the
    sharded steps' reference), then four ranks, a card each, over NCCL
    (module comment above), each card's busy share sampled over the world
    and over each run's timed window."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.runtime.device import BusySampler

    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        emit("lm_shard_multi", note=f"not run: {n_cards} card(s) visible, four needed",
             smi=smi)
        return None
    cfg = lm_config(TRAIN_ARCH)
    tc = TrainConfig(total_steps=1 + MULTI_TIMED, schedule="wsd", **_ADAMW_REMAT)
    gc.collect()
    torch.cuda.empty_cache()
    st = TrainState.create(cfg, tc, torch.Generator(dev).manual_seed(0), device=dev)
    batch = {"tokens": TokenStream(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0).batch_at(0)["tokens"]}
    st, m = make_train_step(cfg, tc, device=dev)(st, batch)
    one_card_loss = float(m["loss"])
    del st, m
    gc.collect()
    torch.cuda.empty_cache()
    busy = BusySampler(n_cards)
    t0 = time.perf_counter()
    recs, rcs = run_shard_world(4, "multi", "multi", "nccl", ids=(0, 1, 2, 3),
                                timeout=MULTI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    sampled = busy.stop()
    out = dict(world=4, backend="nccl", rcs=rcs, wall_s=wall, card_busy=sampled,
               errors=[r.get("error") or r.get("log_tail") for r in recs
                       if "error" in r or "log_tail" in r], smi=smi)
    ok = rcs == [0] * 4 and all(r.get("ok") for r in recs)
    if ok:
        for kind, key, *_ in MULTI_RUNS:
            if kind == "train":
                out[key] = _multi_train_summary([r[key] for r in recs],
                                                one_card_loss if key == "train" else None)
            else:
                out[key] = _multi_serve_summary([r[key] for r in recs])
    emit("lm_shard_multi", **out)
    if not ok:
        raise AssertionError(f"lm_shard_multi failed: rcs {rcs}")
    return out


# --------------------------------------------------------------- examples
def examples_phase(torch, dev, smi):
    """The port's two LM examples on the card: ``activations_ccm`` (40
    training steps of smollm-135m smoke, its neurons' series, the CCM map
    through ``knn_topk`` and ``ccm_lookup``, whose launch counts start at
    0 just before it and must not stay there), then ``train_lm --steps
    20 --token-range 64`` (the train CLI; tokens from [0, 64), a stream
    with structure), whose loss must fall from step 1 to step 20."""
    import numpy as np

    from repro_torch.examples import activations_ccm, train_lm

    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        got = activations_ccm.main([])
    torch.cuda.synchronize()
    act_s = time.perf_counter() - t0
    launches = read_launches()
    rho = got["rho"]
    act = dict(seconds=act_s, losses=[got["losses"][0], got["losses"][-1]],
               neurons=int(got["ts"].shape[0]), T=int(got["ts"].shape[1]),
               rho_finite=bool(np.isfinite(rho).all()),
               launches={k: launches[k] for k in ("knn_topk", "ccm_lookup")},
               last_lines=log.getvalue().strip().splitlines()[-2:])
    del got
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, step_n, metrics = train_lm.main(["--steps", "20", "--token-range", "64"])
    torch.cuda.synchronize()
    steps = [ln for ln in log.getvalue().splitlines() if ln.startswith("step ")]
    first = float(steps[0].split("loss=")[1].split()[0])
    tl = dict(seconds=time.perf_counter() - t0, step=step_n, first_loss=first,
              final_loss=metrics["loss"], lines=steps)
    emit("examples", activations_ccm=act, train_lm=tl, smi=smi)
    if not (act["rho_finite"] and launches["knn_topk"] > 0 and launches["ccm_lookup"] > 0
            and step_n == 20 and metrics["loss"] < first):
        raise AssertionError(f"examples failed: {act} {tl}")
    return act, tl


# ------------------------------------------------------------------ fleet
FLEET_ARTIFACTS = ("causal_map", "rho_conv", "rho_trend", "pvals", "edges")
FLEET_TIMEOUT_S = 900  # the limit of every wait on a fleet or a worker


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def worker_done_lines(text: str) -> dict:
    """{worker: its ``[wid] done in <s>s {json}`` records} from a fleet's
    log: launches, peak device bytes and stage seconds of each process
    that finished (a killed process prints none).  Found wherever they
    sit in the log, since several processes write to it."""
    import re

    done, dec = {}, json.JSONDecoder()
    for m in re.finditer(r"\] done in [0-9.]+s ", text):
        rec, _ = dec.raw_decode(text, m.end())
        done.setdefault(rec["worker"], []).append(rec)
    return done


def summed_launches(done: dict) -> dict:
    total: dict = {}
    for recs in done.values():
        for rec in recs:
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def per_worker(done: dict) -> dict:
    return {wid: [{"phase2_s": r["stages_s"].get("phase2"),
                   "sig_s": r["stages_s"].get("sig"),
                   "stages_s": r["stages_s"],
                   "peak_device_bytes": r["peak_device_bytes"],
                   "launches": r["launches"]} for r in recs]
            for wid, recs in sorted(done.items())}


def run_fleet_cli(argv, log_path, env_extra=None, watch=None):
    """``python -m repro_torch.launch.edm_run ... --workers W`` in a
    process group of its own (on a timeout the whole group, workers
    included, is killed), its log (the supervisor's and every worker's
    lines) kept in ``log_path``: (wall s, log text).  ``watch``: a path
    for the log of ``edm_fleet status --watch --interval 2`` over the
    fleet's store (``--out`` of argv), started as a side process once
    the store's fleet.json exists; it must exit 0 on its own once the run
    is complete."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.edm_run",
                             *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    side = None
    if watch is not None:
        spec = pathlib.Path(argv[argv.index("--out") + 1]) / "fleet.json"
        while not spec.exists() and proc.poll() is None:
            if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
                break
            time.sleep(0.05)
        with open(watch, "w") as f:
            side = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.edm_fleet", "status",
                 "--watch", "--interval", "2", "--out", str(spec.parent)],
                stdout=f, stderr=subprocess.STDOUT, env=env,
                start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=FLEET_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    finally:
        if side is not None and proc.returncode != 0:
            os.killpg(side.pid, signal.SIGKILL)
            side.wait()
    wall = time.perf_counter() - t0
    log_path.write_text(out)
    if proc.returncode != 0:
        raise AssertionError(f"fleet run {argv} exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    if side is not None:
        try:
            rc = side.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(side.pid, signal.SIGKILL)
            side.wait()
            raise AssertionError("status --watch did not end within 60 s of "
                                 "the fleet's end")
        if rc != 0:
            raise AssertionError(f"status --watch exited {rc}:\n"
                                 f"{pathlib.Path(watch).read_text()[-3000:]}")
    return wall, out


def supervisor_line(text: str) -> dict:
    """restarts / failed of the supervisor's ``fleet[W] ...`` line."""
    for ln in text.splitlines():
        if ln.startswith("fleet[") and "restarts " in ln:
            rest = ln.split("restarts ", 1)[1]
            restarts, failed = rest.split("; failed ")
            wall = float(ln.split(" in ", 1)[1].split("s ", 1)[0])
            return {"line": ln, "wall_s": wall, "restarts": json.loads(restarts),
                    "failed": json.loads(failed)}
    raise AssertionError("no supervisor summary line in the fleet log")


def span_split(out) -> dict:
    """Seconds and count of every (stage, span name) in the workers'
    telemetry, summed over workers, with the waits the spans record
    (``gather_s``: a drain's wait for the chunk's result; ``fsync_s``: a
    block write's fsync): where a fleet's time went.  ``chunk`` spans
    dispatch the kernels; ``drain`` spans wait for a result and write it
    (``write_block`` / ``write_tile``, ``manifest_commit``); the
    ``queue_*`` spans are the queue's claims, lease renewals, done
    markers and barrier waits.  ``<stage>/unattributed`` is each stage
    span less the union of the spans inside it (nested spans counted
    once), summed over workers: time no span covers."""
    from repro_torch.runtime import telemetry

    split: dict = {}
    # (worker, stage) -> stage spans and inner spans as (start, end)
    stage_iv: dict = {}
    inner_iv: dict = {}
    for stem, rec in telemetry.iter_store_records(out):
        if rec.get("kind") != "span":
            continue
        acc = split.setdefault(f"{rec['stage']}/{rec['name']}", {"s": 0.0, "n": 0})
        acc["s"] += rec["dur_s"]
        acc["n"] += 1
        for attr in ("gather_s", "fsync_s"):
            if attr in rec["attrs"]:
                acc[attr] = acc.get(attr, 0.0) + rec["attrs"][attr]
        iv = (rec["mono"] - rec["dur_s"], rec["mono"])
        key = (stem, rec["pid"], rec["stage"])
        (stage_iv if rec["name"] == "stage" else inner_iv).setdefault(
            key, []).append(iv)
    for key, stages in stage_iv.items():
        inner = sorted(inner_iv.get(key, []))
        for lo, hi in stages:
            covered, end = 0.0, lo
            for a, b in inner:
                a, b = max(a, end), min(b, hi)
                if b > a:
                    covered += b - a
                    end = b
            acc = split.setdefault(f"{key[2]}/unattributed", {"s": 0.0, "n": 0})
            acc["s"] += (hi - lo) - covered
            acc["n"] += 1
    return dict(sorted(split.items()))


def check_fleet_store(out, ref, artifacts, expect_complete=True):
    """Byte equality with the single-process store, status, fsck, leases."""
    from repro_torch.launch import edm_fleet
    from repro_torch.runtime import integrity

    equal = {a: same_npy_bits(ref / a / "data.npy", out / a / "data.npy")
             for a in artifacts}
    st = edm_fleet.fleet_status(out)
    rep = integrity.fsck_store(out)
    leases = sorted(p.name for p in (out / "queue").glob("*.lease"))
    res = {"byte_equal": equal, "status_complete": st["complete"],
           "fsck_clean": rep["clean"], "fsck_problems": rep["problems"],
           "stale_leases": leases,
           "telemetry_violations": st["telemetry"]["violations"]}
    if not all(equal.values()):
        raise AssertionError(f"fleet store {out} != single-process: {equal}")
    if not (st["complete"] == expect_complete and rep["clean"] and not leases):
        raise AssertionError(f"fleet store {out}: {res}")
    return res


@contextlib.contextmanager
def stdout_fd_to(path):
    """Point file descriptor 1 at ``path`` (processes started inside
    inherit it), then back."""
    import os

    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "ab") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def fleet_trace_phase(out, smi):
    """``python -m repro_torch.launch.edm_fleet trace --json --reconcile``
    over a finished fleet store: it exits 0 only where every stage's span
    total is within 1% of ``fleet_status``'s; trace.json (Chrome trace
    events) parses; each stage's six buckets and its critical-path unit
    are printed, with the queue's own spans summed beside them (they
    fall in ``queue_wait``)."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.edm_fleet", "trace", "--json",
         "--reconcile", "--out", str(out)], capture_output=True, text=True,
        timeout=FLEET_TIMEOUT_S, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"edm_fleet trace exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    tr = json.loads(proc.stdout)
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    rec = tr["reconcile"]
    worst = max(s["delta_pct"] for s in rec["stages"].values())
    split = span_split(out)
    emit("fleet_trace", store=out.name, seconds=wall, workers=tr["workers"],
         total_wall_s=tr["total_wall_s"], clock_shift_s=tr["clock_shift_s"],
         chrome_trace_events=len(events), reconcile_ok=rec["ok"],
         reconcile_worst_delta_pct=worst, reconcile=rec["stages"],
         stages={s: {k: st[k] for k in ("wall_s", "units", "chunks",
                                        "chunk_p50_s", "chunk_p95_s", "buckets")}
                 for s, st in tr["stages"].items()},
         critical_path=tr["critical_path"],
         queue_spans_s={k: v["s"] for k, v in split.items()
                        if k.split("/")[1].startswith("queue_")},
         smi=smi)
    if not (rec["ok"] and worst <= 1.0 and events and tr["critical_path"]):
        raise AssertionError(f"fleet trace: reconcile {rec}, {len(events)} "
                             "Chrome events")


def fleet_phases(torch, smi, n, sig_n, main_dir, main_launches, sig_dir,
                 sig_launches, wall_single, busy_single):
    """The fleet on the card: W worker processes, each with its own CUDA
    context, over one store.  main (--workers 2 at n), significance
    (--workers 2 at sig_n), kill (3 workers, units of 5 rows, w0
    SIGKILLed once a block is durable and relaunched under its id) and
    faults (--workers 3 --unit-rows 5 with EDM_FAULTS armed in the first
    generation of every worker; the supervisor relaunches each without
    it).  Each store byte-equal to the single-process one; the summed
    launches equal the single-process counts where no process died."""
    import os
    import signal

    from repro_torch.core.types import EDMConfig
    from repro_torch.data import store
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig
    from repro_torch.launch import edm_fleet
    from repro_torch.runtime.device import BusySampler

    mode = compute_mode()
    emit("fleet_card", compute_mode=mode, smi=smi,
         device_bytes_held_by_smoke=torch.cuda.memory_allocated(),
         device_bytes_reserved_by_smoke=torch.cuda.memory_reserved())
    logs = ROOT / "build" / "smoke_fleet_logs"
    logs.mkdir(parents=True, exist_ok=True)
    sig_argv = ["--lib-sizes", ",".join(map(str, SIG_LIB_SIZES)),
                "--surrogates", str(SIG_M), "--surrogate-kind", "phase",
                "--fdr", "0.05", "--seed", "0"]
    results = {}

    # ---- main path, two workers ------------------------------------------
    out = ROOT / "build" / "smoke_fleet_main"
    shutil.rmtree(out, ignore_errors=True)
    busy = BusySampler()
    try:
        wall, text = run_fleet_cli(["--synthetic", f"{n}x{FISH1_L}", "--e-max",
                                    str(E_MAX), "--workers", "2", "--out",
                                    str(out)], logs / "main.log")
    finally:
        busy = busy.stop()
    done = worker_done_lines(text)
    sums = summed_launches(done)
    chk = check_fleet_store(out, main_dir, ("causal_map",))
    sup = supervisor_line(text)
    equal_counts = all(sums.get(k) == v for k, v in main_launches.items())
    emit("fleet_main", N=n, L=FISH1_L, E_max=E_MAX, workers=2, wall_s=wall,
         supervisor_wall_s=sup["wall_s"], supervisor=sup["line"],
         card_busy_sampled=busy, single_process_card_busy_sampled=busy_single,
         restarts=sup["restarts"], failed=sup["failed"],
         workers_done=per_worker(done), launches_summed=sums,
         launches_single_process=main_launches,
         launches_equal_single_process=equal_counts,
         single_process_wall_s=wall_single["main"], spans=span_split(out),
         smi=smi, **chk)
    if not equal_counts or sup["failed"] or any(sup["restarts"].values()):
        raise AssertionError(f"fleet main path: launches {sums} vs "
                             f"{main_launches}, supervisor {sup}")
    results["main"] = sums
    fleet_trace_phase(out, smi)
    shutil.rmtree(out, ignore_errors=True)

    # ---- significance path, two workers ----------------------------------
    out = ROOT / "build" / "smoke_fleet_sig"
    shutil.rmtree(out, ignore_errors=True)
    watch_log = logs / "significance_watch.log"
    wall, text = run_fleet_cli(["--synthetic", f"{sig_n}x{FISH1_L}", "--e-max",
                                str(E_MAX), *sig_argv, "--workers", "2",
                                "--out", str(out)], logs / "significance.log",
                               watch=watch_log)
    done = worker_done_lines(text)
    sums = summed_launches(done)
    chk = check_fleet_store(out, sig_dir, FLEET_ARTIFACTS)
    sup = supervisor_line(text)
    watch = watch_log.read_text().splitlines()
    watch_lines = [ln for ln in watch if ln.startswith("watch: ")]
    emit("fleet_watch", alongside="fleet_significance", interval_s=2,
         refreshes=sum(ln.startswith("fleet ") for ln in watch),
         complete_seen=any("[COMPLETE]" in ln for ln in watch),
         watch_lines=len(watch_lines), first=watch_lines[:3],
         stragglers=[ln for ln in watch_lines if "STRAGGLER" in ln][:5],
         last=watch_lines[-3:], log=str(watch_log.relative_to(ROOT)))
    if not watch_lines or not any("[COMPLETE]" in ln for ln in watch):
        raise AssertionError("status --watch printed no watch: line or never "
                             "saw the run complete")
    equal_counts = all(sums.get(k) == v for k, v in sig_launches.items())
    emit("fleet_significance", N=sig_n, L=FISH1_L, workers=2, wall_s=wall,
         supervisor_wall_s=sup["wall_s"], supervisor=sup["line"],
         restarts=sup["restarts"], failed=sup["failed"],
         workers_done=per_worker(done), launches_summed=sums,
         launches_single_process=sig_launches,
         launches_equal_single_process=equal_counts,
         single_process_wall_s=wall_single["significance"],
         spans=span_split(out), smi=smi, **chk)
    if not equal_counts or sup["failed"] or any(sup["restarts"].values()):
        raise AssertionError(f"fleet significance: launches {sums} vs "
                             f"{sig_launches}, supervisor {sup}")
    results["significance"] = sums
    shutil.rmtree(out, ignore_errors=True)

    # ---- kill: three workers by hand, w0 SIGKILLed and relaunched --------
    out = ROOT / "build" / "smoke_fleet_kill"
    shutil.rmtree(out, ignore_errors=True)
    store.save_dataset(out / "dataset", dummy_brain(sig_n, FISH1_L),
                       {"synthetic": f"{sig_n}x{FISH1_L}"})
    sig = SignificanceConfig(lib_sizes=SIG_LIB_SIZES, n_surrogates=SIG_M,
                             alpha=0.05, surrogate="phase", seed=0)
    edm_fleet.init_fleet(out, out / "dataset", EDMConfig(E_max=E_MAX), sig,
                         unit_rows=5)
    log = logs / "kill.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("EDM_FAULTS", None)
    t0 = time.perf_counter()
    with stdout_fd_to(log):
        procs = {f"w{i}": edm_fleet.spawn_worker(out, f"w{i}", env=env)
                 for i in range(3)}
    try:
        while not list(out.glob("rows_*.npy")):
            if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
                raise AssertionError("kill run: no phase-2 block became durable")
            if any(p.poll() is not None for p in procs.values()):
                raise AssertionError("kill run: a worker exited before the kill")
            time.sleep(0.05)
        victim = procs["w0"]
        os.kill(victim.pid, signal.SIGKILL)
        rc_killed = victim.wait(timeout=60)
        t_kill = time.perf_counter() - t0
        blocks_at_kill = len(list(out.glob("rows_*.npy")))
        with stdout_fd_to(log):
            procs["w0"] = edm_fleet.spawn_worker(out, "w0", env=env)
        rcs = {wid: p.wait(timeout=max(1.0, FLEET_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
               for wid, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(rcs.values()) or rc_killed != -signal.SIGKILL:
        raise AssertionError(f"kill run: exit codes {rcs}, killed {rc_killed}")
    done = worker_done_lines(log.read_text())
    chk = check_fleet_store(out, sig_dir, FLEET_ARTIFACTS)
    sums = summed_launches(done)
    emit("fleet_kill", N=sig_n, workers=3, unit_rows=5, wall_s=wall,
         killed="w0", killed_at_s=t_kill, killed_rc=rc_killed,
         blocks_durable_at_kill=blocks_at_kill, exit_codes=rcs,
         workers_done=per_worker(done), launches_summed_done_lines=sums,
         launches_single_process=sig_launches,
         note="the killed process printed no done line: its launches are "
         "in no sum", smi=smi, **chk)
    results["kill_survivors"] = sums
    shutil.rmtree(out, ignore_errors=True)

    # ---- faults: the supervisor absorbs an armed crash -------------------
    out = ROOT / "build" / "smoke_fleet_faults"
    shutil.rmtree(out, ignore_errors=True)
    fault = "tile_pre_rename:crash@2"
    wall, text = run_fleet_cli(["--synthetic", f"{sig_n}x{FISH1_L}", "--e-max",
                                str(E_MAX), *sig_argv, "--workers", "3",
                                "--unit-rows", "5", "--out", str(out)],
                               logs / "faults.log", {"EDM_FAULTS": fault})
    done = worker_done_lines(text)
    sup = supervisor_line(text)
    chk = check_fleet_store(out, sig_dir, FLEET_ARTIFACTS)
    sums = summed_launches(done)
    emit("fleet_faults", N=sig_n, workers=3, unit_rows=5, faults=fault,
         wall_s=wall, supervisor_wall_s=sup["wall_s"], supervisor=sup["line"],
         restarts=sup["restarts"], failed=sup["failed"],
         workers_done=per_worker(done), launches_summed_done_lines=sums,
         launches_single_process=sig_launches,
         note="a crashed process printed no done line: its launches are "
         "in no sum", smi=smi, **chk)
    if sup["failed"] or not any(sup["restarts"].values()):
        raise AssertionError(f"fault run: the armed crash was not absorbed "
                             f"by a restart: {sup}")
    results["faults_survivors"] = sums
    shutil.rmtree(out, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# Several device slots, library-sharded kNN, the torch.distributed merge.
def pad_shard(torch, V, lo, hi, width):
    """Columns [lo, min(hi, Lc)) of V, padded with zeros to ``width``: one
    library shard as the sharded builders hand it to the kernel."""
    part = V[..., lo:max(lo, min(hi, V.shape[-1]))]
    return torch.nn.functional.pad(part, (0, width - part.shape[-1])).contiguous()


def check_knn_ranges(torch, V8, smi):
    """The knn_topk kernel's column range against its plain version, bit
    for bit, with both accumulators: a shard at an offset, a padded last
    shard, a shard wholly past Lc, and exclude_self across three shards
    whose tree merge equals the unsharded kernel table.  Returns the max
    abs errors (f32, bf16)."""
    from repro_torch.core import knn as tknn
    from repro_torch.kernels.knn_topk.ops import knn_topk

    all_E = tuple(range(1, E_MAX + 1))
    k = E_MAX + 1
    errs = {"float32": 0.0, "bfloat16": 0.0}
    Lc = V8.shape[-1]
    for dt in errs:
        sfx = "" if dt == "float32" else "_bf16"
        for name, lo, hi, width in (("shard_offset", 400, 800, 400),
                                    ("padded_last_shard", 1200, Lc, 300),
                                    ("shard_past_Lc", 1500, Lc, 100)):
            errs[dt] = max(errs[dt], check_knn(
                torch, name + sfx, V8, pad_shard(torch, V8, lo, hi, width), k,
                True, all_E, dt, col_offset=lo, col_hi=hi))
        shard = -(-Lc // 3)
        parts = []
        for s in range(3):
            lo, hi = s * shard, min((s + 1) * shard, Lc)
            Vc = pad_shard(torch, V8, lo, hi, shard)
            errs[dt] = max(errs[dt], check_knn(
                torch, f"exclude_self_shard{s}_of_3{sfx}", V8, Vc, k, True,
                all_E, dt, col_offset=lo, col_hi=hi))
            parts.append(knn_topk(V8, Vc, k, True, all_E, dist_dtype=dt,
                                  col_offset=lo, col_hi=hi))
        mi, md = tknn.merge_topk_tree([p[0] for p in parts], [p[1] for p in parts], k)
        ui, ud = knn_topk(V8, V8, k, True, all_E, dist_dtype=dt)
        eq = bool(torch.equal(mi, ui)) and same_bits(torch, md, ud)
        emit("check_knn", case="exclude_self_across_shards" + sfx,
             shape=list(V8.shape), shards=3, k=k, dist_dtype=dt,
             merged_equal_to_unsharded_kernel_table=eq, smi=smi)
        if not eq:
            raise AssertionError(f"three shards merged != unsharded ({dt})")
    return errs["float32"], errs["bfloat16"]


def sharded_knn_phase(torch, dev, smi):
    """Library-sharded tables at Subject11's length (L 8,528: Lp 8,508,
    E_max 20, k 21, exclude_self, one series): the sim path at 1, 2, 4 and
    8 shards and the local-device path over every visible card, each
    bit-equal to the unsharded kernel table; CUDA-event times of the
    unsharded build, each shard count's builds, its tree merge alone and
    the whole; the knn_topk launches of one pass of each."""
    from repro_torch.core import knn as tknn
    from repro_torch.core.pipeline import (
        _shard_table,
        knn_tables_library_sharded,
        knn_tables_library_sharded_sim,
    )
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.runtime.platform import local_devices

    Lp11 = SUBJECT11_L - (E_MAX - 1) - 1
    V = lag_batch(torch, dummy_brain(1, SUBJECT11_L, seed=3), Lp11, dev)
    cfg, k, all_E = EDMConfig(E_max=E_MAX), E_MAX + 1, tuple(range(1, E_MAX + 1))
    ui, ud = knn_topk(V, V, k, True, all_E)
    unsharded_ms = time_ms(torch, lambda: knn_topk(V, V, k, True, all_E), 5)
    runs = {}

    def record(name, fn, S, parts_fn=None):
        knn_topk.LAUNCHES = 0
        gi, gd = fn()
        torch.cuda.synchronize()
        launches = knn_topk.LAUNCHES
        eq = bool(torch.equal(gi, ui)) and same_bits(torch, gd, ud)
        r = {"shards": S, "bit_equal": eq, "launches": launches,
             "build_merge_ms": time_ms(torch, fn, 3)}
        if parts_fn is not None:
            parts = parts_fn()
            r["build_ms"] = time_ms(torch, parts_fn, 3)
            r["merge_ms"] = time_ms(torch, lambda: tknn.merge_topk_tree(
                [p[0] for p in parts], [p[1] for p in parts], k), 5)
        runs[name] = r
        if not (eq and launches == S):
            raise AssertionError(f"sharded kNN {name}: bit_equal {eq}, "
                                 f"{launches} knn_topk launches for {S} shards")

    for S in (1, 2, 4, 8):
        record(f"sim{S}", lambda S=S: knn_tables_library_sharded_sim(
            V, V, k, cfg, exclude_self=True, shards=S), S,
            lambda S=S: [_shard_table(V, V, k, cfg, True, s, S, dev)
                         for s in range(S)])
    devs = local_devices("cuda")
    record(f"devices{len(devs)}", lambda: knn_tables_library_sharded(
        V, V, k, cfg, exclude_self=True, devices=devs), len(devs))
    emit("sharded_knn", L=SUBJECT11_L, Lp=Lp11, E_max=E_MAX, k=k,
         exclude_self=True, unsharded_ms=unsharded_ms, runs=runs,
         devices=[str(d) for d in devs],
         note=None if len(devs) > 1 else
         "one card visible: the local-device path is one shard on cuda:0",
         smi=smi)
    return {name: r["launches"] for name, r in runs.items()}


def with_device_ids(ids, fn):
    """``fn()`` with EDM_LOCAL_DEVICE_IDS set to ``ids`` (None: unset), the
    variable put back after."""
    import os

    old = os.environ.pop("EDM_LOCAL_DEVICE_IDS", None)
    if ids is not None:
        os.environ["EDM_LOCAL_DEVICE_IDS"] = ids
    try:
        return fn()
    finally:
        os.environ.pop("EDM_LOCAL_DEVICE_IDS", None)
        if old is not None:
            os.environ["EDM_LOCAL_DEVICE_IDS"] = old


def multi_device_main(torch, dev, smi, n, ref_dir, one):
    """The main path over two row slots on card 0 (EDM_LOCAL_DEVICE_IDS=0,0)
    and, where several cards are visible, over all of them: data.npy equal
    byte for byte to the one-device run's (``ref_dir``), the store
    fsck-clean by the port's ``edm_fleet fsck``, the launches equal to the
    one-device run's; wall, launches and the busy share of each card.  The
    speedup is printed only where two cards or more ran."""
    from repro_torch.runtime import integrity
    from repro_torch.runtime.device import BusySampler

    n_cards = torch.cuda.device_count()
    runs = [("two_slots_card0", "0,0")]
    if n_cards > 1:
        runs.append((f"all_{n_cards}_cards", None))
    out = {}
    for name, ids in runs:
        d = ROOT / "build" / f"smoke_multi_{name}"
        shutil.rmtree(d, ignore_errors=True)
        busy = BusySampler(n_cards)
        try:
            summ, launches, peak = with_device_ids(ids, lambda: run_cli(torch, dev, [
                "--synthetic", f"{n}x{FISH1_L}", "--e-max", str(E_MAX),
                "--out", str(d)]))
        finally:
            busy = busy.stop()
        equal = same_npy_bits(ref_dir / "causal_map" / "data.npy",
                              d / "causal_map" / "data.npy")
        fsck = integrity.fsck_store(d)
        same_launches = all(launches[k] == one["launches"][k]
                            for k in ("knn_topk", "ccm_lookup"))
        out[name] = dict(devices=summ["devices"], **phase_walls(summ),
                         launches=launches, peak_device_bytes_card0=peak,
                         card_busy_sampled=busy, byte_equal_to_one_device=equal,
                         fsck_clean=fsck["clean"], launches_equal=same_launches)
        shutil.rmtree(d, ignore_errors=True)
        if not (equal and fsck["clean"] and same_launches):
            raise AssertionError(f"multi_device_main {name}: byte_equal {equal}, "
                                 f"fsck {fsck['clean']}, launches {launches}")
    speedup = None
    if n_cards > 1:
        speedup = one["wall_s"] / out[f"all_{n_cards}_cards"]["wall_s"]
    emit("multi_device_main", N=n, L=FISH1_L, E_max=E_MAX, lib_block=LIB_BLOCK,
         one_device=one, runs=out, visible_cards=n_cards, speedup=speedup,
         note=None if n_cards > 1 else
         "one card visible: the all-cards run is end_to_end; no speedup "
         "(two slots on one card measure the decomposition's overhead)",
         smi=smi)
    return out


def multi_device_significance(torch, dev, smi, n, ref_dir, one_launches):
    """The significance path over two row slots on card 0: all five
    artifacts byte-equal to the one-slot store (``ref_dir``), fsck-clean."""
    from repro_torch.runtime import integrity

    d = ROOT / "build" / "smoke_multi_sig"
    shutil.rmtree(d, ignore_errors=True)
    summ, launches, peak = with_device_ids("0,0", lambda: run_cli(torch, dev, [
        "--synthetic", f"{n}x{FISH1_L}", "--e-max", str(E_MAX),
        "--lib-sizes", ",".join(map(str, SIG_LIB_SIZES)),
        "--surrogates", str(SIG_M), "--surrogate-kind", "phase",
        "--fdr", "0.05", "--seed", "0", "--out", str(d)]))
    equal = {a: same_npy_bits(ref_dir / a / "data.npy", d / a / "data.npy")
             for a in FLEET_ARTIFACTS}
    fsck = integrity.fsck_store(d)
    emit("multi_device_significance", N=n, L=FISH1_L, slots=summ["devices"],
         wall_s=summ["wall_s"] + summ["significance_s"],
         significance_s=summ["significance_s"], launches=launches,
         launches_one_slot=one_launches, peak_device_bytes=peak,
         byte_equal_to_one_slot=equal, fsck_clean=fsck["clean"],
         edges=summ["edges"], smi=smi)
    shutil.rmtree(d, ignore_errors=True)
    if not (all(equal.values()) and fsck["clean"]):
        raise AssertionError(f"multi_device_significance: {equal}, fsck "
                             f"{fsck['clean']}")
    return launches


RANK_TIMEOUT_S = 240  # the limit of each rank process of the distributed phase
RANK_CODE = r"""
import json, pathlib, sys
import torch
import torch.distributed as dist
from repro_torch.core import embedding, pipeline
from repro_torch.core.types import EDMConfig
from repro_torch.data.synthetic import dummy_brain
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.runtime import platform

backend, out, L = sys.argv[1] or None, pathlib.Path(sys.argv[2]), int(sys.argv[3])
rank = int(__import__("os").environ["EDM_PROCESS_ID"])
try:
    info = platform.init_distributed(backend=backend)
except RuntimeError as e:  # two NCCL ranks on one card: refused
    (out / f"rank{rank}.json").write_text(json.dumps({"refused": str(e)}))
    sys.exit(0)
dev = torch.device(info["device"])
Lp = L - 20
V = embedding.lag_matrix(torch.as_tensor(dummy_brain(1, L, seed=3)).to(dev),
                         20, 1, Lp).contiguous()
cfg, all_E = EDMConfig(E_max=20), tuple(range(1, 21))
ui, ud = knn_topk(V, V, 21, True, all_E)
fn = lambda: pipeline.knn_tables_library_sharded(
    V, V, 21, cfg, exclude_self=True, group=dist.group.WORLD)
knn_topk.LAUNCHES = 0
si, sd = fn()
torch.cuda.synchronize(dev)
launches = knn_topk.LAUNCHES
eq = bool(torch.equal(si, ui)) and bool(torch.equal(sd.view(torch.int32),
                                                     ud.view(torch.int32)))
ms = []
for _ in range(3):
    dist.barrier()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize(dev)
    ms.append(a.elapsed_time(b))
(out / f"rank{rank}.json").write_text(json.dumps({
    "info": info, "bit_equal": eq, "launches": launches,
    "build_merge_ms": sorted(ms)[1], "shape": list(si.shape)}))
dist.destroy_process_group()
"""


def run_ranks(world, backend, ids, L, tag):
    """``world`` rank processes of RANK_CODE joined through the EDM_*
    contract on localhost (rank r's EDM_LOCAL_DEVICE_IDS = ids[r]); each
    has RANK_TIMEOUT_S, after which it is killed.  Returns the ranks'
    records and return codes."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = ROOT / "build" / f"smoke_dist_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = []
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "EDM_COORDINATOR": f"localhost:{port}",
               "EDM_NUM_PROCESSES": str(world), "EDM_PROCESS_ID": str(r),
               "EDM_LOCAL_DEVICE_IDS": str(ids[r])}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, backend or "", str(out), str(L)],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT))
    t_end = time.time() + RANK_TIMEOUT_S
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, t_end - time.time())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()
    recs = []
    for r in range(world):
        f = out / f"rank{r}.json"
        recs.append(json.loads(f.read_text()) if f.exists() else
                    {"log_tail": (out / f"rank{r}.log").read_text()[-2000:]})
    return recs, rcs


def distributed_phase(torch, smi):
    """``knn_tables_library_sharded`` across the ranks of a two-rank
    ``torch.distributed`` world joined through the EDM_* contract, at
    Subject11's length, tables bit-equal to the unsharded kernel table
    on every rank: on gloo with both ranks on card 0 (the merge stages
    its tables through host memory); on NCCL with one card a rank where
    two cards are visible (else said so); and the NCCL refusal of two
    ranks on one card, which must name the gloo route."""
    n_cards = torch.cuda.device_count()
    runs = {}
    cases = [("gloo_one_card", "gloo", (0, 0)),
             ("nccl_shared_card_refused", None, (0, 0))]
    if n_cards > 1:
        cases.append(("nccl_two_cards", "nccl", (0, 1)))
    for name, backend, ids in cases:
        recs, rcs = run_ranks(2, backend, ids, SUBJECT11_L, name)
        runs[name] = {"backend": backend or "nccl (default on cards)",
                      "rcs": rcs, "ranks": recs}
        if name == "nccl_shared_card_refused":
            ok = rcs == [0, 0] and all("gloo" in r.get("refused", "") for r in recs)
        else:
            ok = rcs == [0, 0] and all(r.get("bit_equal") for r in recs)
        runs[name]["ok"] = ok
        if not ok:
            emit("distributed", runs=runs, smi=smi)
            raise AssertionError(f"distributed phase {name} failed: {rcs} {recs}")
    emit("distributed", L=SUBJECT11_L, world=2, runs=runs,
         nccl_two_cards=("ran" if n_cards > 1 else
                         f"not run: {n_cards} card visible (NCCL needs a card "
                         "a rank)"), smi=smi)
    return {name: sum(r.get("launches", 0) for r in v["ranks"])
            for name, v in runs.items()}


# ----------------------------------------------------- rows across ranks
RANKS_TIMEOUT_S = 600  # the limit of a world of edm_run ranks
RANK_DONE = r"^rank (\d+)/(\d+) done in [0-9.]+s (\{.*\})$"


def run_edm_ranks(world, argv, tag, ids=None):
    """``world`` processes of ``python -m repro_torch.launch.edm_run
    argv``, one a rank, joined through the EDM_* contract on localhost
    (rank r's EDM_LOCAL_DEVICE_IDS = ids[r] where given, else card
    ``r % cards``), each in a session of its own; every rank
    still running at RANKS_TIMEOUT_S is killed.  Logs in
    build/smoke_ranks_<tag>/.  Returns (wall s, each rank's ``rank r/W
    done`` record); raises unless every rank exited 0."""
    import os
    import re
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    d = ROOT / "build" / f"smoke_ranks_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    logs, procs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "EDM_COORDINATOR": f"localhost:{port}",
               "EDM_NUM_PROCESSES": str(world), "EDM_PROCESS_ID": str(r)}
        env.pop("EDM_LOCAL_DEVICE_IDS", None)
        if ids is not None:
            env["EDM_LOCAL_DEVICE_IDS"] = str(ids[r])
        logs.append(open(d / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.edm_run", *argv], env=env,
            stdout=logs[r], stderr=subprocess.STDOUT, start_new_session=True))
    t_end = time.time() + RANKS_TIMEOUT_S
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, t_end - time.time())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    wall = time.perf_counter() - t0
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    for f in logs:
        f.close()
    texts = [(d / f"rank{r}.log").read_text() for r in range(world)]
    if rcs != [0] * world:
        raise AssertionError(f"ranks {tag} exited {rcs}:\n" + "\n".join(
            f"rank {r}: {t[-3000:]}" for r, t in enumerate(texts)))
    recs = []
    for t in texts:
        m = re.search(RANK_DONE, t, re.M)
        if m is None:
            raise AssertionError(f"ranks {tag}: a rank printed no done line")
        recs.append(json.loads(m.group(3)))
    return wall, recs


def ranks_phase(torch, smi, name, world, argv, ref, artifacts, one, ids=None):
    """One world of ``edm_run`` ranks against the one-process store
    ``ref`` (``one``: its wall and launches): every artifact byte-equal,
    fsck clean, the launches summed over the ranks equal to the one
    process's, each card's sampled busy share and each rank's record."""
    from repro_torch.runtime import integrity
    from repro_torch.runtime.device import BusySampler

    d = ROOT / "build" / f"smoke_{name}"
    shutil.rmtree(d, ignore_errors=True)
    n_cards = torch.cuda.device_count()
    busy = BusySampler(n_cards)
    try:
        wall, recs = run_edm_ranks(world, [*argv, "--out", str(d)], name, ids)
    finally:
        busy = busy.stop()
    equal = {a: same_npy_bits(ref / a / "data.npy", d / a / "data.npy")
             for a in artifacts}
    fsck = integrity.fsck_store(d)
    launches = {}
    for rec in recs:
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    same = all(launches[k] == v for k, v in one["launches"].items())
    per_rank = [{k: rec[k] for k in ("rank", "devices", "rows", "wall_s",
                                     "phase1_s", "phase2_s", "assemble_s",
                                     "significance_s", "peak_device_bytes",
                                     "launches")} for rec in recs]
    res = dict(world=world, backend="gloo",
               card_ids=list(ids) if ids else "process_id % cards",
               wall_s=wall, ranks_wall_s_max=max(r["wall_s"] + (
                   r["significance_s"] or 0.0) for r in recs),
               one_process=one, launches=launches, launches_equal=same,
               per_rank=per_rank, card_busy_sampled=busy,
               byte_equal_to_one_process=equal, fsck_clean=fsck["clean"])
    emit(name, argv=argv, smi=smi, **res)
    shutil.rmtree(d, ignore_errors=True)
    if not (all(equal.values()) and fsck["clean"] and same
            and launches["knn_topk"] > 0 and launches["ccm_lookup"] > 0):
        raise AssertionError(f"{name}: byte_equal {equal}, fsck {fsck['clean']}, "
                             f"launches {launches} against {one['launches']}")
    return res


def trends_phase(torch, dev, smi, refinalize_argv, refinalize_dir, outs):
    """The run history every ``edm_run`` and fleet run of the smoke kept
    in one file (EDM_HISTORY): ``edm_run`` again into the finished store
    ``refinalize_dir`` (a resume that computes nothing and finalizes
    again) replaces that run's record and adds none; ``python -m
    repro_torch.launch.edm_fleet trends --history FILE --json`` lists one
    record per finished run (no two of one (out, fingerprint)), every
    store of ``outs`` among them, and the text form renders."""
    import os

    from repro_torch.runtime import history

    path = pathlib.Path(os.environ["EDM_HISTORY"])
    before = history.load_history(path)
    t_before = {r["out"]: r["t"] for r in before}
    run_cli(torch, dev, [*refinalize_argv, "--out", str(refinalize_dir)])
    after = history.load_history(path)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.edm_fleet", "trends",
           "--history", str(path)]
    got = json.loads(subprocess.run([*cmd, "--json"], capture_output=True,
                                    text=True, check=True, timeout=120,
                                    env=env).stdout)
    text = subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120, env=env).stdout
    keys = [(r["out"], r["fingerprint"]) for r in after]
    mine = str(refinalize_dir.resolve())
    missing = [str(o) for o in outs if str(o.resolve()) not in t_before]
    ok = (len(set(keys)) == len(keys) == len(before) == len(got["runs"])
          and not missing and t_before.get(mine, 0) < max(
              r["t"] for r in after if r["out"] == mine)
          and f"history: {len(after)} run(s)" in text)
    emit("trends", history=str(path.relative_to(ROOT)), records=len(after),
         records_before_refinalize=len(before), distinct_runs=len(set(keys)),
         refinalized=str(refinalize_dir.relative_to(ROOT)), missing=missing,
         regressions=len(got["regressions"]), knobs=got["knobs"][:6],
         runs=[{k: r[k] for k in ("out", "N", "engine", "workers",
                                  "total_span_s", "rows_per_s", "chunk_p95_s")}
               for r in got["runs"]],
         text_lines=len(text.splitlines()), smi=smi)
    if not ok:
        raise AssertionError(f"trends: {len(before)} records before, "
                             f"{len(after)} after, {len(set(keys))} distinct, "
                             f"missing {missing}:\n{text[-3000:]}")


def engine_check_cli(smi):
    """``python -m repro_torch.engine.check --engine cuda``: every op of
    the cuda engine against torch-reference on the card, in a process of
    its own."""
    import ast
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.engine.check", "--engine", "cuda"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not proc.stdout.startswith("cuda {"):
        raise AssertionError(f"engine check exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    errs = {k: float(v) for k, v in ast.literal_eval(
        proc.stdout.strip().splitlines()[-1][len("cuda "):]).items()}
    emit("engine_check_cli", errs=errs, wall_s=wall, smi=smi)
    return errs


def extensions_phase(torch, dev, smi):
    """``repro_torch.core.extensions`` on the card: ``ccm_lagged`` over a
    batch of Fish1_Normo-length series through the cuda engine (one
    ``knn_topk`` launch, counted from 0 just before it) equal to its
    plain route (torch-reference on the card), and the S-Map sweep on the
    card against the CPU within 1e-5; host-clock times with a sync."""
    from repro_torch.core import extensions as ext
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.knn_topk.ops import knn_topk

    xs, ys = dummy_brain(64, FISH1_L, seed=5), dummy_brain(64, FISH1_L, seed=6)
    cfg, E = EDMConfig(E_max=E_MAX), 12

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    ext.ccm_lagged(xs, ys, E, cfg, device=dev)  # warm-up
    knn_topk.LAUNCHES = 0
    got, ms = timed(lambda: ext.ccm_lagged(xs, ys, E, cfg, device=dev))
    launches = knn_topk.LAUNCHES
    ref_cfg = dataclasses.replace(cfg, engine="torch-reference")
    want, plain_ms = timed(lambda: ext.ccm_lagged(xs, ys, E, ref_cfg, device=dev))
    equal = bool(torch.equal(got, want))
    sweep, smap_ms = timed(lambda: ext.smap_theta_sweep(xs[:8], 2, cfg, device=dev))
    smap_err = float((sweep.cpu() - ext.smap_theta_sweep(xs[:8], 2, cfg,
                                                         device="cpu")).abs().max())
    emit("extensions", series=64, L=FISH1_L, E_max=E_MAX, E=E,
         ccm_lagged_ms=ms, ccm_lagged_plain_ms=plain_ms,
         launches={"knn_topk": launches}, equal_to_plain_route=equal,
         rho_finite=bool(torch.isfinite(got).all()), smap_series=8,
         smap_ms=smap_ms, smap_max_abs_err_vs_cpu=smap_err, tol=1e-5, smi=smi)
    if not (equal and launches == 1 and smap_err <= 1e-5):
        raise AssertionError(f"extensions: equal {equal}, launches {launches}, "
                             f"smap err {smap_err}")
    return {"knn_topk": launches}


# The wide kernels (the routes past the fast path): k 48, 96 and 128 at
# Fish1_Normo's phase-1 shape (E_max 20, a k_override), E_max 40 (k 41:
# phase 1's 40 lists, four windows of 12; a phase-2 bucket set spanning
# past lag 32, two windows), the significance path's prefix shape at the
# same k and at E_max 40 with 70 library sizes (two launches a window),
# and at k 21 with 30 buckets and 70 sizes (the wide route at one slot a
# lane), the lookup at the same k, past 64 segments and just past the two
# staged rows and the one; and the map at E_max 40 at CHECK_N series
# against torch-reference.
WIDE_KS = (48, 96, 128)
WIDE_E = 40
WIDE_BUCKETS = (3, 5, 8, 12, 20, 33, 40)
WIDE_SIG_SIZES = tuple(range(50, 1400, 20)) + (1400, 1410)  # 70 sizes
WIDE_K_SIZES = (150, 200, 400, 800, 1430)  # the first at least k + 1
# A recording past the two staged target rows of the lookup (29,056 points
# on an H100; one staged row up to 58,112): N 32 series of 36,020 frames at
# E_max 20 (Lp 36,000, an hour of imaging at 10 Hz), and the lookup at its
# Lp against its library call.
LONG_N, LONG_L = 32, 36020


def _wide_time(torch, fn, plain, counts, launches, **shape):
    """CUDA-event times of one call of a wide case beside its plain
    version and its bound (``launch/roofline.py``)."""
    from repro_torch.launch.roofline import bound_ms

    ms = time_ms(torch, fn, 5)
    plain_ms = time_ms(torch, plain, 1)
    bound, by = bound_ms(*counts)
    return dict(kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                share_of_bound=bound / ms, launches_per_call=launches, **shape)


def _launches_of(fn, counter):
    before = counter.LAUNCHES
    fn()
    return counter.LAUNCHES - before


def wide_tables_phase(torch, dev, smi):
    """Phase ``wide_tables``: the three EDM kernels past the fast path
    against their plain versions (tables bit-equal in float32 and
    bfloat16, the lookup within 1e-6 max|Y|), timed beside their bounds;
    the map at E_max 40 on ``cuda`` (launch counts from 0 just before it)
    equal to ``torch-reference``'s within the engine check's tolerances."""
    import torch.nn.functional as F

    from repro_torch.core import embedding
    from repro_torch.core import knn as tknn
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import prng
    from repro_torch.inference.convergence import subsample_permutation
    from repro_torch.kernels.ccm_lookup.ops import _lib as lookup_lib
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref
    from repro_torch.launch.roofline import knn_counts, lookup_counts, prefix_counts

    import numpy as np

    t0 = time.perf_counter()
    ts8 = dummy_brain(LIB_BLOCK, FISH1_L, seed=1)
    Lp = FISH1_L - (E_MAX - 1) - 1
    Lh = Lp // 2
    V8 = lag_batch(torch, ts8, Lp, dev)
    Vq1, Vc1 = V8[..., Lh:].contiguous(), V8[..., :Lh].contiguous()
    Lp40 = FISH1_L - (WIDE_E - 1) - 1  # 1410
    V40 = embedding.lag_matrix(torch.as_tensor(ts8).to(dev), WIDE_E, 1,
                               Lp40).contiguous()
    x = np.random.default_rng(WIDE_E).standard_normal((3, WIDE_E, 400))
    Vtie = torch.as_tensor((np.round(x * 4) / 4).astype(np.float32)).to(dev)
    all_E, all_E40 = tuple(range(1, E_MAX + 1)), tuple(range(1, WIDE_E + 1))
    err = {"knn_topk": 0.0, "knn_topk_prefix": 0.0, "ccm_lookup": 0.0}
    times = {name: {} for name in err}  # kernel -> case -> times

    # ---- knn_topk: k past 32, E past 32, both accumulators
    knn_cases = [(f"phase1_k{k}", Vq1, Vc1, k, False, all_E) for k in WIDE_KS]
    knn_cases += [("phase1_E40_k41", V40[..., Lp40 // 2:].contiguous(),
                   V40[..., :Lp40 // 2].contiguous(), WIDE_E + 1, False, all_E40),
                  ("phase2_E40_k41", V40, V40, WIDE_E + 1, True, WIDE_BUCKETS)]
    for name, Vq, Vc, k, excl, sel in knn_cases:
        err["knn_topk"] = max(err["knn_topk"],
                              check_knn(torch, f"wide_{name}", Vq, Vc, k, excl, sel),
                              check_knn(torch, f"wide_{name}_bf16", Vq, Vc, k, excl,
                                        sel, "bfloat16"))
        n = _launches_of(lambda: knn_topk(Vq, Vc, k, excl, sel), knn_topk)
        times["knn_topk"][name] = _wide_time(
            torch, lambda: knn_topk(Vq, Vc, k, excl, sel),
            lambda: knn_topk_ref(Vq, Vc, k, excl, sel),
            knn_counts(Vq.shape[0], sel[-1], len(sel), Vq.shape[-1], Vc.shape[-1], k),
            n, S=Vq.shape[0], Lq=Vq.shape[-1], Lc=Vc.shape[-1], k=k,
            select_Es=list(sel))
    # tie-heavy lags past lag 32 at k 128, and a column range at k 64
    err["knn_topk"] = max(
        err["knn_topk"],
        check_knn(torch, "wide_tied_k128_E40", Vtie, Vtie, 128, True, (2, 20, 33, 40)),
        check_knn(torch, "wide_tied_k70_E40_bf16", Vtie, Vtie, 70, True, all_E40,
                  "bfloat16"),
        check_knn(torch, "wide_column_range_k64", V40, V40[..., 700:].contiguous(),
                  64, True, WIDE_BUCKETS, col_offset=700, col_hi=Lp40))

    # ---- knn_topk_prefix: the significance path's shape at the same k, and
    # E_max 40 with 70 library sizes (two launches a window)
    perm_key = prng.split(prng.prng_key(0, dev), 2)[0]
    col_ids = subsample_permutation(perm_key, Lp)
    col_ids40 = subsample_permutation(perm_key, Lp40)
    bsel = (3, 5, 8, 12)
    prefix_cases = [(f"sig_k{k}", V8, k, bsel, WIDE_K_SIZES, col_ids) for k in WIDE_KS]
    prefix_cases.append(("sig_E40_k41_70_sizes", V40, WIDE_E + 1, WIDE_BUCKETS,
                         WIDE_SIG_SIZES, col_ids40))
    # k within the fast width, 30 buckets, 70 sizes: two runs, so the wide
    # route at one slot a lane, two windows a run
    prefix_cases.append(("sig_E30_k21_70_sizes", V40, E_MAX + 1, tuple(range(1, 31)),
                         WIDE_SIG_SIZES, col_ids40))
    for name, V, k, b, sizes, cids in prefix_cases:
        err["knn_topk_prefix"] = max(
            err["knn_topk_prefix"],
            check_knn_prefix(torch, f"wide_{name}", V, V, k, True, b, sizes, cids),
            check_knn_prefix(torch, f"wide_{name}_bf16", V, V, k, True, b, sizes, cids,
                             "bfloat16"))
        n = _launches_of(lambda: knn_topk_prefix(V, V, k, True, b, sizes,
                                                 col_ids=cids), knn_topk_prefix)
        times["knn_topk_prefix"][name] = _wide_time(
            torch, lambda: knn_topk_prefix(V, V, k, True, b, sizes, col_ids=cids),
            lambda: knn_topk_prefix_ref(V, V, k, True, b, sizes, col_ids=cids),
            prefix_counts(V.shape[0], b[-1], len(b), V.shape[-1], sizes[-1],
                          len(sizes), k),
            n, B=V.shape[0], Lq=V.shape[-1], k=k, buckets=list(b),
            n_sizes=len(sizes))
    err["knn_topk_prefix"] = max(err["knn_topk_prefix"], check_knn_prefix(
        torch, "wide_tied_k128_E40_natural", Vtie, Vtie, 128, True, (2, 20, 33, 40),
        (129, 200, 333, 400), None))

    # ---- ccm_lookup: the chunk's 8 tables at the same k (the staged kernel
    # in chunks of 32), past 64 segments, just past the two staged rows
    Y = torch.as_tensor(dummy_brain(TARGET_BLOCK, FISH1_L, seed=2)
                        [:, E_MAX : E_MAX + Lp]).to(dev).contiguous()
    YT = Y.t().contiguous()
    for k in WIDE_KS:
        idx, sqd = knn_topk(V8, V8, k, True, (E_MAX,))
        idx, w = tknn.tables_with_weights_bucketed(idx, sqd, (E_MAX,))
        idx, w = idx[:, 0].contiguous(), w[:, 0].contiguous()
        err["ccm_lookup"] = max(err["ccm_lookup"],
                                check_lookup(torch, f"wide_chunk_tables_k{k}", idx, w, Y))
        il, wl = idx.reshape(-1, k).long(), w.reshape(-1, k)
        case = _wide_time(torch, lambda: ccm_lookup(idx, w, Y),
                          lambda: ccm_lookup_ref(idx, w, Y),
                          lookup_counts(LIB_BLOCK, TARGET_BLOCK, Lp, Lp, k), 1,
                          S=LIB_BLOCK, B=TARGET_BLOCK, Lq=Lp, Lp=Lp, k=k)
        case["library_ms"] = time_ms(torch, lambda: F.embedding_bag(
            il, YT, per_sample_weights=wl, mode="sum"), 5)
        times["ccm_lookup"][f"chunk_tables_k{k}"] = case
    del idx, w, sqd, il, wl
    rng = np.random.default_rng(30)
    counts = rng.integers(0, 30, 150)
    segs = tuple((i % 4, int(c)) for i, c in enumerate(counts))
    for name, k, Lp_, segs_, S_ in (("150_segments_k41", 41, Lp, segs, 8),
                                    ("Lp_past_two_stages", 21,
                                     lookup_lib().ccm_lookup_max_lp(2) + 1,
                                     ((0, 40), (1, 24)), 2),
                                    ("Lp_past_one_stage_k70", 70,
                                     lookup_lib().ccm_lookup_max_lp(1) + 1,
                                     ((0, 20), (1, 12)), 2)):
        B_ = sum(c for _, c in segs_)
        ri = torch.as_tensor(rng.integers(0, Lp_, (S_, 4, 700, k)).astype(np.int32)).to(dev)
        rw = torch.as_tensor(rng.uniform(0, 1, (S_, 4, 700, k)).astype(np.float32)).to(dev)
        rY = torch.as_tensor(rng.standard_normal((B_, Lp_)).astype(np.float32)).to(dev)
        n = _launches_of(lambda: ccm_lookup(ri, rw, rY, segs_), ccm_lookup)
        err["ccm_lookup"] = max(err["ccm_lookup"], check_lookup(
            torch, f"wide_{name}", ri, rw, rY, segs_))
        times["ccm_lookup"][name] = dict(launches_per_call=n, segments=len(segs_),
                                           Lp=Lp_, k=k)
    del ri, rw, rY

    # ---- the map at E_max 40 on the kernels against torch-reference
    ts = dummy_brain(CHECK_N, FISH1_L, seed=4)
    knn_topk.LAUNCHES = knn_topk_prefix.LAUNCHES = ccm_lookup.LAUNCHES = 0
    t1 = time.perf_counter()
    got = run_causal_inference(ts, EDMConfig(E_max=WIDE_E, engine="cuda"), device=dev)
    map_s = time.perf_counter() - t1
    launches = {"knn_topk": knn_topk.LAUNCHES, "ccm_lookup": ccm_lookup.LAUNCHES}
    want = run_causal_inference(ts, EDMConfig(E_max=WIDE_E, engine="torch-reference"),
                                device=dev)
    optE_eq = bool(np.array_equal(got.optE, want.optE))
    rho_err = float(np.abs(got.rho - want.rho).max())
    emit("wide_tables", E_max=WIDE_E, map_N=CHECK_N, map_L=FISH1_L, map_s=map_s,
         map_launches=launches, optE_equal=optE_eq, rho_max_abs_err=rho_err,
         tol=1e-5, optE_max=int(np.max(got.optE)), max_abs_err=err, times=times,
         seconds=time.perf_counter() - t0, smi=smi)
    if not (optE_eq and rho_err <= 1e-5):
        raise AssertionError(f"wide_tables: the E_max {WIDE_E} map on cuda != "
                             f"torch-reference (optE equal {optE_eq}, rho {rho_err})")
    if min(launches.values()) < 1:
        raise AssertionError(f"wide_tables: the E_max {WIDE_E} map missed a "
                             f"kernel: {launches}")
    return {"launches": launches, "max_abs_err": err, "times": times}


def long_recording_phase(torch, dev, smi):
    """Phase ``long_recording``: a map of LONG_N series of LONG_L frames
    (Lp 36,000, past the lookup's two staged target rows) whole on
    ``cuda``, launch counts from 0 just before it; one series' tables and
    one chunk's lookup at that length against the plain versions; the
    lookup at Lp 36,000 (8 tables, B 2,048, k 21) timed beside its bound
    and ``F.embedding_bag``."""
    import torch.nn.functional as F

    from repro_torch.core import ccm as tccm
    from repro_torch.core import knn as tknn
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref
    from repro_torch.launch.roofline import bound_ms, lookup_counts

    import numpy as np

    t0 = time.perf_counter()
    Lp = LONG_L - (E_MAX - 1) - 1  # 36,000
    ts = dummy_brain(LONG_N, LONG_L, seed=11)
    knn_topk.LAUNCHES = ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    walls = {}
    res = run_causal_inference(ts, EDMConfig(E_max=E_MAX, engine="cuda"), device=dev,
                               timings=walls)
    map_s = time.perf_counter() - t1
    launches = {"knn_topk": knn_topk.LAUNCHES, "ccm_lookup": ccm_lookup.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    rho = np.asarray(res.rho)
    if rho.shape != (LONG_N, LONG_N) or not np.isfinite(rho).all():
        raise AssertionError(f"long_recording: map shape {rho.shape}, finite "
                             f"{np.isfinite(rho).all()}")
    if min(launches.values()) < 1:
        raise AssertionError(f"long_recording: the map missed a kernel: {launches}")
    buckets = tuple(int(b) for b in np.unique(res.optE))
    kb = buckets[-1] + 1

    # one series' phase-2 tables and one chunk's lookup, against the plain
    # versions (the plain tables in tiles of 4,096 candidates)
    V = lag_batch(torch, ts[:LIB_BLOCK], Lp, dev)
    ki, kd = knn_topk(V[:1], V[:1], kb, True, buckets)
    ri, rd = knn_topk_ref(V[:1], V[:1], kb, True, buckets, tile_c=4096)
    tables_equal = bool(torch.equal(ki, ri)) and same_bits(torch, kd, rd)
    del ki, kd, ri, rd
    plan, order = tccm.make_bucket_plan(np.asarray(res.optE))
    idx, sqd = knn_topk(V, V, kb, True, buckets)
    idx, w = tknn.tables_with_weights_bucketed(idx, sqd, buckets)
    Yc = torch.as_tensor(ts[order][:, E_MAX : E_MAX + Lp]).to(dev).contiguous()
    segs = tuple(enumerate(plan.counts))
    lookup_err = check_lookup(torch, "long_recording_chunk", idx, w, Yc, segs)
    del idx, w, sqd, Yc

    # the lookup at Lp 36,000: 8 tables, B 2,048, k 21 (the gather route)
    idx, sqd = knn_topk(V, V, E_MAX + 1, True, (E_MAX,))
    idx, w = tknn.tables_with_weights_bucketed(idx, sqd, (E_MAX,))
    idx, w = idx[:, 0].contiguous(), w[:, 0].contiguous()
    del sqd, V
    Y = torch.as_tensor(dummy_brain(TARGET_BLOCK, LONG_L, seed=12)
                        [:, E_MAX : E_MAX + Lp]).to(dev).contiguous()
    lookup_err = max(lookup_err, check_lookup(torch, "long_recording_Lp36000",
                                              idx, w, Y))
    ms = time_ms(torch, lambda: ccm_lookup(idx, w, Y), 3)
    plain = time_ms(torch, lambda: ccm_lookup_ref(idx, w, Y), 1)
    YT = Y.t().contiguous()
    il, wl = idx.reshape(-1, E_MAX + 1).long(), w.reshape(-1, E_MAX + 1)
    lib = time_ms(torch, lambda: F.embedding_bag(il, YT, per_sample_weights=wl,
                                                 mode="sum"), 3)
    bound, by = bound_ms(*lookup_counts(LIB_BLOCK, TARGET_BLOCK, Lp, Lp, E_MAX + 1))
    del idx, w, Y, YT, il, wl
    gc.collect()
    torch.cuda.empty_cache()
    lookup = dict(kernel_ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                  bound_by=by, share_of_bound=bound / ms, S=LIB_BLOCK,
                  B=TARGET_BLOCK, Lq=Lp, Lp=Lp, k=E_MAX + 1)
    emit("long_recording", N=LONG_N, L=LONG_L, Lp=Lp, E_max=E_MAX, map_s=map_s,
         walls=walls,
         launches=launches, peak_device_bytes=peak, buckets=list(buckets),
         rho_absmax=float(np.abs(rho).max()), tables_equal=tables_equal,
         lookup_max_abs_err=lookup_err, lookup_Lp36000=lookup,
         seconds=time.perf_counter() - t0, smi=smi)
    if not tables_equal:
        raise AssertionError("long_recording: knn_topk != plain version at Lp "
                             f"{Lp}")
    return {"launches": launches, "lookup": lookup, "max_abs_err": lookup_err}


# The key-select route (k past 128): phase 1's shape at k 160, 256 and 715
# (k == Lc with the self excluded), phase 2's shape at k 200 over four
# buckets, one library shard at k 160, E_max 160 at k 161; the prefix
# kernel at k 160 and 256 over five library sizes (the first at least
# k + 1, the plain version's rule); the lookup at k 160 and 256, and at
# Lp 36,000 on one staged row; the map at k_override 200.
DEEP_KS = (160, 256)
DEEP_E = 160
DEEP_SIZES = (260, 400, 700, 1000, 1430)
DEEP_MAP_K = 200


def deep_tables_phase(torch, dev, smi):
    """Phase ``deep_tables``: the EDM kernels past 128 neighbours (the
    kNN kernels' key-select route) against their plain versions -- tables
    bit-equal in float32 and bfloat16, the lookup within 1e-6 max|Y| --
    each timed with CUDA events beside its bound, its plain version (and
    ``F.embedding_bag`` for the lookup); the map at k_override 200 on
    ``cuda`` (launch counts from 0 just before it) against
    ``torch-reference`` within the engine check's tolerances."""
    import torch.nn.functional as F

    from repro_torch.core import embedding
    from repro_torch.core import knn as tknn
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import prng
    from repro_torch.inference.convergence import subsample_permutation
    from repro_torch.kernels.ccm_lookup.ops import _lib as lookup_lib
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref
    from repro_torch.launch.roofline import (
        knn_counts,
        lookup_counts,
        prefix_counts,
        segmented_counts,
    )

    import numpy as np

    t0 = time.perf_counter()
    ts8 = dummy_brain(LIB_BLOCK, FISH1_L, seed=1)
    Lp = FISH1_L - (E_MAX - 1) - 1  # 1430
    Lh = Lp // 2
    V8 = lag_batch(torch, ts8, Lp, dev)
    Vq1, Vc1 = V8[..., Lh:].contiguous(), V8[..., :Lh].contiguous()
    Lp160 = FISH1_L - (DEEP_E - 1) - 1  # 1290
    V160 = embedding.lag_matrix(torch.as_tensor(ts8).to(dev), DEEP_E, 1,
                                Lp160).contiguous()
    all_E, all_E160 = tuple(range(1, E_MAX + 1)), tuple(range(1, DEEP_E + 1))
    err = {"knn_topk": 0.0, "knn_topk_prefix": 0.0, "ccm_lookup": 0.0}
    times = {name: {} for name in err}

    # ---- knn_topk: the key-select route
    h160 = Lp160 // 2
    knn_cases = [(f"phase1_k{k}", Vq1, Vc1, k, False, all_E, "float32") for k in DEEP_KS]
    knn_cases += [
        ("phase1_k256_bf16", Vq1, Vc1, 256, False, all_E, "bfloat16"),
        ("k_eq_Lc_715_self", Vc1, Vc1, Lh, True, all_E, "float32"),
        ("phase2_buckets_k200", V8, V8, DEEP_MAP_K, True, (3, 8, 15, 20), "float32"),
        ("phase1_E160_k161", V160[..., h160:].contiguous(), V160[..., :h160].contiguous(),
         DEEP_E + 1, False, all_E160, "float32"),
    ]
    for name, Vq, Vc, k, excl, sel, dt in knn_cases:
        err["knn_topk"] = max(err["knn_topk"], check_knn(
            torch, f"deep_{name}", Vq, Vc, k, excl, sel, dt))
        n = _launches_of(lambda: knn_topk(Vq, Vc, k, excl, sel, dist_dtype=dt), knn_topk)
        times["knn_topk"][name] = _wide_time(
            torch, lambda: knn_topk(Vq, Vc, k, excl, sel, dist_dtype=dt),
            lambda: knn_topk_ref(Vq, Vc, k, excl, sel, dist_dtype=dt),
            knn_counts(Vq.shape[0], sel[-1], len(sel), Vq.shape[-1], Vc.shape[-1], k),
            n, S=Vq.shape[0], Lq=Vq.shape[-1], Lc=Vc.shape[-1], k=k,
            n_sel=len(sel), dist_dtype=dt)
    ki, kd = knn_topk(Vc1, Vc1, Lh, True, all_E)  # k == Lc: (+inf, self) last
    self_last = bool(torch.equal(
        ki[..., -1], torch.arange(Lh, device=dev, dtype=torch.int32).expand_as(
            ki[..., -1]))) and bool(torch.isinf(kd[..., -1]).all())
    del ki, kd
    if not self_last:
        raise AssertionError("deep_tables: k == Lc did not end in (+inf, self)")
    # one library shard: columns 700.. of the phase-2 library
    err["knn_topk"] = max(err["knn_topk"], check_knn(
        torch, "deep_column_range_k160", V8, V8[..., 700:].contiguous(), 160, True,
        (3, 8, 15, 20), col_offset=700, col_hi=Lp))

    # ---- knn_topk_prefix: the significance path's shape at k 160 and 256
    perm_key = prng.split(prng.prng_key(0, dev), 2)[0]
    col_ids = subsample_permutation(perm_key, Lp)
    bsel = (3, 5, 8, 12)
    for k in DEEP_KS:
        for dt in ("float32", "bfloat16"):
            name = f"sig_k{k}" + ("_bf16" if dt == "bfloat16" else "")
            err["knn_topk_prefix"] = max(err["knn_topk_prefix"], check_knn_prefix(
                torch, f"deep_{name}", V8, V8, k, True, bsel, DEEP_SIZES, col_ids, dt))
            fn = (lambda k=k, dt=dt: knn_topk_prefix(V8, V8, k, True, bsel, DEEP_SIZES,
                                                     col_ids=col_ids, dist_dtype=dt))
            n = _launches_of(fn, knn_topk_prefix)
            times["knn_topk_prefix"][name] = _wide_time(
                torch, fn,
                lambda k=k, dt=dt: knn_topk_prefix_ref(
                    V8, V8, k, True, bsel, DEEP_SIZES, col_ids=col_ids, dist_dtype=dt),
                prefix_counts(LIB_BLOCK, bsel[-1], len(bsel), Lp, DEEP_SIZES[-1],
                              len(DEEP_SIZES), k),
                n, B=LIB_BLOCK, Lq=Lp, k=k, buckets=list(bsel),
                lib_sizes=list(DEEP_SIZES), dist_dtype=dt)

    # ---- ccm_lookup at k 160 and 256: the chunk's 8 tables, B 2,048
    Y = torch.as_tensor(dummy_brain(TARGET_BLOCK, FISH1_L, seed=2)
                        [:, E_MAX : E_MAX + Lp]).to(dev).contiguous()
    YT = Y.t().contiguous()
    for k in DEEP_KS:
        idx, sqd = knn_topk(V8, V8, k, True, (E_MAX,))
        idx, w = tknn.tables_with_weights_bucketed(idx, sqd, (E_MAX,))
        idx, w = idx[:, 0].contiguous(), w[:, 0].contiguous()
        err["ccm_lookup"] = max(err["ccm_lookup"], check_lookup(
            torch, f"deep_chunk_tables_k{k}", idx, w, Y))
        il, wl = idx.reshape(-1, k).long(), w.reshape(-1, k)
        case = _wide_time(torch, lambda: ccm_lookup(idx, w, Y),
                          lambda: ccm_lookup_ref(idx, w, Y),
                          lookup_counts(LIB_BLOCK, TARGET_BLOCK, Lp, Lp, k), 1,
                          S=LIB_BLOCK, B=TARGET_BLOCK, Lq=Lp, Lp=Lp, k=k)
        case["library_ms"] = time_ms(torch, lambda: F.embedding_bag(
            il, YT, per_sample_weights=wl, mode="sum"), 5)
        times["ccm_lookup"][f"chunk_tables_k{k}"] = case
    del idx, w, sqd, il, wl, Y, YT
    # Lp 36,000: past the two staged rows, one staged row at a time
    rng = np.random.default_rng(31)
    Lp_long = 36000
    if not lookup_lib().ccm_lookup_max_lp(2) < Lp_long <= lookup_lib().ccm_lookup_max_lp(1):
        raise AssertionError("deep_tables: Lp 36,000 is not on the one-row route")
    segs = ((0, 20), (1, 12))
    ri = torch.as_tensor(rng.integers(0, Lp_long, (2, 2, 700, 160)).astype(np.int32)).to(dev)
    rw = torch.as_tensor(rng.uniform(0, 1, (2, 2, 700, 160)).astype(np.float32)).to(dev)
    rY = torch.as_tensor(rng.standard_normal((32, Lp_long)).astype(np.float32)).to(dev)
    err["ccm_lookup"] = max(err["ccm_lookup"], check_lookup(
        torch, "deep_Lp36000_k160_one_row", ri, rw, rY, segs))
    times["ccm_lookup"]["Lp36000_k160"] = _wide_time(
        torch, lambda: ccm_lookup(ri, rw, rY, segs),
        lambda: ccm_lookup_ref(ri, rw, rY, segs),
        segmented_counts(2, ((0, 32, segs),), 700, Lp_long, 160),
        _launches_of(lambda: ccm_lookup(ri, rw, rY, segs), ccm_lookup),
        S=2, B=32, Lq=700, Lp=Lp_long, k=160, segments=len(segs))
    del ri, rw, rY

    # ---- the map at k_override 200 on the kernels against torch-reference
    ts = dummy_brain(CHECK_N, FISH1_L, seed=4)
    knn_topk.LAUNCHES = ccm_lookup.LAUNCHES = 0
    knn_topk.ROUTE_LAUNCHES = dict.fromkeys(knn_topk.ROUTE_LAUNCHES, 0)
    t1 = time.perf_counter()
    cfg = EDMConfig(E_max=E_MAX, k_override=DEEP_MAP_K, engine="cuda")
    got = run_causal_inference(ts, cfg, device=dev)
    map_s = time.perf_counter() - t1
    launches = {"knn_topk": knn_topk.LAUNCHES, "ccm_lookup": ccm_lookup.LAUNCHES}
    by_route = dict(knn_topk.ROUTE_LAUNCHES)
    want = run_causal_inference(ts, dataclasses.replace(cfg, engine="torch-reference"),
                                device=dev)
    optE_eq = bool(np.array_equal(got.optE, want.optE))
    rho_err = float(np.abs(got.rho - want.rho).max())
    emit("deep_tables", k_override=DEEP_MAP_K, E_max=E_MAX, map_N=CHECK_N,
         map_L=FISH1_L, map_s=map_s, map_launches=launches,
         map_knn_launches_by_route=by_route, optE_equal=optE_eq,
         rho_max_abs_err=rho_err, tol=1e-5, k_eq_Lc_self_last=self_last,
         max_abs_err=err, times=times, seconds=time.perf_counter() - t0, smi=smi)
    if not (optE_eq and rho_err <= 1e-5):
        raise AssertionError(f"deep_tables: the k_override {DEEP_MAP_K} map on cuda "
                             f"!= torch-reference (optE equal {optE_eq}, rho {rho_err})")
    if min(launches.values()) < 1 or by_route["key_select"] != launches["knn_topk"]:
        raise AssertionError(f"deep_tables: the k_override {DEEP_MAP_K} map missed the "
                             f"key-select route: {launches}, {by_route}")
    return {"launches": launches, "launches_by_route": by_route, "max_abs_err": err,
            "times": times}


def bench_gate_phase(torch, dev, smi):
    """Phase ``bench_gate``: the port bench's ``--check`` regression gate
    on the card at ``--tiny``: ``knn significance`` without ``--check``
    writes the baselines (after a first run that warms those shapes);
    ``--check`` against them passes
    (CHECK_summary.json ``passed: true``); against an empty directory it
    prints SKIP rows and exits 0; against a baseline with one gated field
    divided by 10 it retries once and exits nonzero."""
    from repro_torch.bench import run as brun

    t0 = time.perf_counter()
    out = ROOT / "build" / "smoke_bench_gate"
    shutil.rmtree(out, ignore_errors=True)
    empty, doctored = out / "empty", out / "doctored"
    empty.mkdir(parents=True)
    doctored.mkdir()
    log = io.StringIO()

    def gate_rows():
        return [r for r in log.getvalue().splitlines() if r.startswith("gate,")]

    # The benches time single calls of well under a millisecond at --tiny.
    # This process holds every earlier phase's objects, so a full
    # collection inside a timed call takes longer than the call; the
    # bench run as a process of its own has no such heap.  The objects
    # alive now are moved out of the collector's reach for the phase.
    gc.collect()
    gc.freeze()
    try:
        with contextlib.redirect_stdout(log):
            # a first run at these shapes warms them (allocations, launch
            # caches), so the baselines are taken as warm as the check
            brun.main(["knn", "significance", "--tiny", "--out", str(out / "warm")])
            brun.main(["knn", "significance", "--tiny", "--out", str(out)])
            passed = brun.main(["knn", "significance", "--check", "--tiny",
                                "--out", str(out)])
            skipped = brun.main(["significance", "--check", "--tiny", "--out",
                                 str(out), "--baselines", str(empty)])
        sig = json.loads((out / "BENCH_significance.json").read_text())
        sig["one_sweep_chunk_s"] /= 10
        (doctored / "BENCH_significance.json").write_text(json.dumps(sig))
        with contextlib.redirect_stdout(log):
            try:
                brun.main(["significance", "--check", "--tiny", "--out", str(out),
                           "--baselines", str(doctored)])
                regression_exit = 0
            except SystemExit as e:
                regression_exit = e.code
    except SystemExit as e:
        emit("bench_gate", failed=str(e.code), rows=gate_rows(),
             log=log.getvalue().splitlines()[-40:], smi=smi)
        raise AssertionError(f"bench_gate: {e.code}") from None
    finally:
        gc.unfreeze()
    rows = gate_rows()
    summary = json.loads((out / "fresh" / "CHECK_summary.json").read_text())
    res = dict(pass_rows=len(passed["gates"]), passed=passed["passed"],
               skip_rows=sum("SKIP_no_committed_baseline" in r for r in rows),
               skip_passed=skipped["passed"],
               regression_exit_nonzero=regression_exit not in (0, None),
               retry_row=any(r.startswith("gate,retry,") for r in rows),
               regression_failed=summary["failed"],
               fresh_card=json.loads((out / "fresh" / "BENCH_significance.json")
                                     .read_text())["card"])
    emit("bench_gate", **res, rows=rows, seconds=time.perf_counter() - t0, smi=smi)
    if not (res["passed"] and res["pass_rows"] > 0 and res["skip_passed"]
            and res["skip_rows"] >= 1 and res["regression_exit_nonzero"]
            and res["retry_row"] and summary["failed"] == ["significance"]):
        raise AssertionError(f"bench_gate: {res}")
    return res


def flash_grid_phase(torch, dev, smi):
    """Phase ``flash_grid``: the flash kernel past 65,535 batch-heads on the
    CUDA-core route (B * H = 65,540: two launches of grid.y), float32,
    against the plain version; and a bfloat16 call on the tensor-core
    route cut into chunks of 2 query tiles, bit-equal to one launch."""
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref

    t0 = time.perf_counter()
    B, S, H, K, dh = 16385, 16, 4, 2, 32
    q, k, v = qkv(torch, dev, B, S, S, H, K, dh, "float32", seed=7)
    before = dict(ops.flash_attn.ROUTE_LAUNCHES)
    got = ops.flash_attn(q, k, v, True)
    launches = ops.flash_attn.ROUTE_LAUNCHES["cuda_core"] - before["cuda_core"]
    want = flash_attn_ref(q, k, v, True)
    atol, rtol = FLASH_TOL_F32
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.abs()).all())
    ms = time_ms(torch, lambda: ops.flash_attn(q, k, v, True), 3)
    del q, k, v, got, want, diff
    qb, kb, vb = qkv(torch, dev, 3, 700, 700, 4, 2, 64, "bfloat16", seed=8)
    one = ops.flash_attn(qb, kb, vb, True)
    ops.GRID_Y_MAX = 2
    try:
        chunked = ops.flash_attn(qb, kb, vb, True)
    finally:
        ops.GRID_Y_MAX = 65535
    tc_equal = bool(torch.equal(one, chunked))
    emit("flash_grid", B=B, Sq=S, Sk=S, H=H, K=K, dh=dh, batch_heads=B * H,
         route="cuda_core", launches=launches, max_abs_err=err, atol=atol, rtol=rtol,
         ok=ok, kernel_ms=ms, tensor_core_chunks_of_2_bit_equal=tc_equal,
         seconds=time.perf_counter() - t0, smi=smi)
    if not (ok and tc_equal and launches == 1):
        raise AssertionError(f"flash_grid: B * H {B * H}: ok {ok}, err {err}, "
                             f"tensor-core chunks equal {tc_equal}")
    return {"max_abs_err": err, "kernel_ms": ms}


def wide_line(cases, tag: str = "wide") -> dict:
    """The kernels line's keys of one kernel's timed wide (or deep) cases:
    per case its ms, plain ms, bound ms and launches a call."""
    cases = {c: t for c, t in cases.items() if "kernel_ms" in t}
    return {f"ms_{tag}": {c: t["kernel_ms"] for c, t in cases.items()},
            f"plain_ms_{tag}": {c: t["plain_ms"] for c, t in cases.items()},
            f"bound_ms_{tag}": {c: t["bound_ms"] for c, t in cases.items()},
            f"launches_per_call_{tag}": {c: t["launches_per_call"]
                                         for c, t in cases.items()}}



def multi_card_only(torch, dev, smi, n) -> int:
    """``--multi-card``: the main path at ``n`` series on card 0 alone
    (EDM_LOCAL_DEVICE_IDS=0, the reference), then ``multi_device_main``
    (two slots on card 0, every visible card), ``ranks_cards`` (one gloo
    ``edm_run`` rank a card), ``sharded_knn`` and ``distributed`` (NCCL
    with a card a rank where two are visible)."""
    ref = ROOT / "build" / "smoke_out_card0"
    shutil.rmtree(ref, ignore_errors=True)
    summ, launches, _ = with_device_ids("0", lambda: run_cli(torch, dev, [
        "--synthetic", f"{n}x{FISH1_L}", "--e-max", str(E_MAX), "--out", str(ref)]))
    emit("end_to_end_card0", N=n, **phase_walls(summ), launches=launches, smi=smi)
    one = {"wall_s": summ["wall_s"], "launches": launches}
    multi_device_main(torch, dev, smi, n, ref, one)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:  # one rank a card: each card its own dispatcher
        gc.collect()
        torch.cuda.empty_cache()
        ranks_phase(torch, smi, "ranks_cards", n_cards, [
            "--synthetic", f"{n}x{FISH1_L}", "--e-max", str(E_MAX)], ref,
            ("causal_map",), one)
    else:
        emit("ranks_cards", note="not run: one card visible (one rank a "
             "card needs two or more)", smi=smi)
    shutil.rmtree(ref, ignore_errors=True)
    sharded_knn_phase(torch, dev, smi)
    distributed_phase(torch, smi)
    lm_shard_check(torch, smi, world=4)
    lm_shard_multi(torch, dev, smi)
    lm_seq_multi(torch, smi)
    print(smi, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8192,
                    help="series in the main-path run (Fish1_Normo has 53,053)")
    ap.add_argument("--sig-n", type=int, default=1024,
                    help="series in the significance-path run")
    ap.add_argument("--only", default=None,
                    help="run only these phases after the build, comma-separated: "
                    "train_cli, lm_shard_check, lm_shard_check4, examples, "
                    "lm_shard_multi, lm_seq_multi, flash_positions, lm_dryrun, "
                    "wide_tables, long_recording, deep_tables, bench_gate, "
                    "flash_grid")
    ap.add_argument("--shard-rank", choices=("check", "multi", "seq"), default=None,
                    help=argparse.SUPPRESS)  # a rank of run_shard_world
    ap.add_argument("--shard-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dry-job", default=None, help=argparse.SUPPRESS)  # a dry run
    ap.add_argument("--multi-card", action="store_true",
                    help="only the phases across cards and ranks, for a "
                    "machine with several cards: the main path on card 0, "
                    "then multi_device_main, ranks_cards, sharded_knn and "
                    "distributed")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found; run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if args.dry_job:  # host only: no card
        return dry_jobs(args.dry_job)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    if args.shard_rank:
        return shard_rank(args.shard_rank, args.shard_out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # every edm_run and fleet run of the smoke keeps its summary in one
    # run history (the trends phase reads it)
    import os

    history_file = ROOT / "build" / "smoke_history.jsonl"
    history_file.parent.mkdir(parents=True, exist_ok=True)
    history_file.unlink(missing_ok=True)
    os.environ["EDM_HISTORY"] = str(history_file)

    # ---- the card --------------------------------------------------------
    from repro_torch.runtime.device import card_line
    from repro_torch.runtime.device import BusySampler

    smi = card_line(dev)
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build -----------------------------------------------------------
    from repro_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=report)
    if args.only:
        only = {"train_cli": lambda: train_cli(torch, dev, smi),
                "lm_shard_check": lambda: lm_shard_check(torch, smi),
                "lm_shard_check4": lambda: lm_shard_check(torch, smi, world=4),
                "examples": lambda: examples_phase(torch, dev, smi),
                "lm_shard_multi": lambda: lm_shard_multi(torch, dev, smi),
                "lm_seq_multi": lambda: lm_seq_multi(torch, smi),
                "lm_dryrun": lambda: lm_dryrun(
                    torch, smi, train_step_phase(torch, dev, smi,
                                                 train_check(torch, dev, smi))),
                "flash_positions": lambda: flash_positions(torch, dev, smi),
                "wide_tables": lambda: wide_tables_phase(torch, dev, smi),
                "long_recording": lambda: long_recording_phase(torch, dev, smi),
                "deep_tables": lambda: deep_tables_phase(torch, dev, smi),
                "bench_gate": lambda: bench_gate_phase(torch, dev, smi),
                "flash_grid": lambda: flash_grid_phase(torch, dev, smi)}
        for name in args.only.split(","):
            only[name]()
        print(smi, flush=True)
        return 0
    if args.multi_card:
        return multi_card_only(torch, dev, smi, args.n)

    # ---- the LM serving path: flash kernel checks and times, qwen2.5-3b ---
    # first, in a fresh process: after the EDM paths have run, the same
    # decode steps take about twice as long (PERF.md, open questions)
    flash_err = check_flash(torch, dev)
    fgrid = flash_grid_phase(torch, dev, smi)
    fpos = flash_positions(torch, dev, smi)
    ftimes = time_flash(torch, dev, smi)
    ftimes_moe = time_flash(torch, dev, smi, MOE_ARCH)
    # the hybrid, audio and vlm serve shapes (the decoder's self-attention of
    # whisper, 416 x 416, is checked above and not timed)
    ftimes_new = {f"{arch}_{part}": time_flash(torch, dev, smi, arch, part)
                  for arch, part in ((HYBRID_ARCH, "self"), (AUDIO_ARCH, "encoder"),
                                     (AUDIO_ARCH, "cross"), (VLM_ARCH, "self"),
                                     (VLM_ARCH, "cross"))}
    serve = lm_serve(torch, dev, smi)
    lm_check(torch, dev, smi)
    # the moe and ssm families: dbrx-132b (depth cut) and mamba2-2.7b whole
    serve_moe = lm_serve(torch, dev, smi, MOE_ARCH, MOE_SERVE_LAYERS, "lm_moe_serve")
    check_moe = lm_check(torch, dev, smi, MOE_ARCH, MOE_CHECK_LAYERS, "lm_moe_check")
    serve_ssm = lm_serve(torch, dev, smi, SSM_ARCH, phase="lm_ssm_serve")
    check_ssm = lm_check(torch, dev, smi, SSM_ARCH, phase="lm_ssm_check")
    # the hybrid, audio and vlm families, each whole
    serve_more, check_more = {}, {}
    for fam, arch in (("hybrid", HYBRID_ARCH), ("audio", AUDIO_ARCH), ("vlm", VLM_ARCH)):
        serve_more[fam] = lm_serve(torch, dev, smi, arch, phase=f"lm_{fam}_serve")
        check_more[fam] = lm_check(torch, dev, smi, arch, phase=f"lm_{fam}_check")

    # the training path: the flash Function's gradients, minicpm-2b whole
    # through make_train_step, the train CLI and a bit-exact resume
    tcheck = train_check(torch, dev, smi)
    tstep = train_step_phase(torch, dev, smi, tcheck)
    lm_dryrun(torch, smi, tstep)
    train_cli(torch, dev, smi)
    # the sharded LM paths (one NCCL rank, mesh (1, 1)) and the LM examples
    lm_shard_check(torch, smi)
    examples_phase(torch, dev, smi)

    from repro_torch.core import knn as tknn
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref
    from repro_torch.inference import prng
    from repro_torch.inference.convergence import subsample_permutation
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref
    from repro_torch.launch import edm_run
    from repro_torch.launch.roofline import (
        bound_ms,
        knn_counts,
        lookup_counts,
        prefix_counts,
        segmented_counts,
    )

    # ---- kernels against their plain versions, main-path shapes ---------
    Lp = FISH1_L - (E_MAX - 1) - 1  # 1430
    Lh = Lp // 2  # 715
    ts8 = dummy_brain(LIB_BLOCK, FISH1_L, seed=1)
    V8 = lag_batch(torch, ts8, Lp, dev)  # (8, 20, 1430)
    all_E = tuple(range(1, E_MAX + 1))
    knn_err = max(
        check_knn(torch, "phase1", V8[..., Lh:].contiguous(),
                  V8[..., :Lh].contiguous(), E_MAX + 1, False, all_E),
        check_knn(torch, "phase2_buckets", V8, V8, 13, True, (3, 5, 8, 12)),
        check_knn(torch, "phase2_all_E", V8, V8, E_MAX + 1, True, all_E),
    )
    small = V8[:2, :5, :21].contiguous()
    knn_err = max(knn_err, check_knn(torch, "k_eq_Lc", small, small, 21, True,
                                     (1, 2, 3, 4, 5)))
    tied = np.zeros((3, 300), np.float32)  # a dead (constant) series ...
    tied[1] = np.tile(np.sin(np.arange(50, dtype=np.float32)), 6)  # ... and
    tied[2, :150] = tied[2, 150:] = ts8[0, :150]  # series with repeated points
    Vt = lag_batch(torch, tied, 300 - E_MAX, dev)
    knn_err = max(knn_err, check_knn(torch, "tied_rows", Vt, Vt, E_MAX + 1,
                                     True, all_E))
    # the warp-parallel selection's edges: a ragged or partial last group
    # of 32 candidates, k at the warp width, k == Lc, one list, E = 1, and
    # a constant series (every distance ties at 0)
    v20, v77 = V8[:3, :, :20].contiguous(), V8[:3, :, :77].contiguous()
    v32 = V8[:2, :, :32].contiguous()
    Vconst = lag_batch(torch, np.full((2, 300), 0.25, np.float32), 300 - E_MAX, dev)
    for name, Vq, Vc, k, excl, sel in (
        ("Lc_below_32", v20, v20, 7, True, all_E),
        ("Lc_below_32_k_eq_Lc", v20, v20, 20, True, (2, 9)),
        ("Lc_not_multiple_of_32", V8[:3, :, 100:290].contiguous(), v77, 9, False,
         all_E),
        ("k_32", V8[:2], V8[:2], 32, True, (4, 11, 20)),
        ("k_eq_Lc_32", v32, v32, 32, True, all_E),
        ("one_list_E20", V8, V8, E_MAX + 1, True, (E_MAX,)),
        ("lone_E1", V8, V8, 2, True, (1,)),
        ("constant_series", Vconst, Vconst, E_MAX + 1, True, all_E),
        ("constant_series_k32", Vconst[..., :100].contiguous(), Vconst, 32, False,
         (1, 7, 20)),
    ):
        knn_err = max(knn_err, check_knn(torch, name, Vq, Vc, k, excl, sel))
    # the column range (library shards), both accumulators
    range_err, range_bf16_err = check_knn_ranges(torch, V8, smi)

    idx8, sqd8 = knn_topk(V8, V8, E_MAX + 1, True, (E_MAX,))
    idx8, w8 = tknn.tables_with_weights_bucketed(idx8, sqd8, (E_MAX,))
    idx8, w8 = idx8[:, 0].contiguous(), w8[:, 0].contiguous()  # (8, 1430, 21)
    ts_targets = dummy_brain(TARGET_BLOCK, FISH1_L, seed=2)
    Y = torch.as_tensor(ts_targets[:, E_MAX : E_MAX + Lp]).to(dev).contiguous()
    lookup_err = max(
        check_lookup(torch, "one_table", idx8[0], w8[0], Y),
        check_lookup(torch, "chunk_tables", idx8, w8, Y),
        check_lookup(torch, "ragged", idx8[:3, :1000].contiguous(),
                     w8[:3, :1000].contiguous(), Y[:777]),
    )
    # the segmented form: a chunk's table sets at four buckets, segments of
    # 1, G - 1, G and G + 1 targets for every group width G (8, 4, 2) and
    # one long segment; ragged Lq; k = 1 and 32 with idx at 0 and Lp - 1;
    # Subject11's series length and Lp = 16,384 (the stream kernel)
    bsel = (3, 5, 8, 12)
    idxb, sqdb = knn_topk(V8, V8, 13, True, bsel)
    idxb, wb = tknn.tables_with_weights_bucketed(idxb, sqdb, bsel)  # (8, 4, 1430, 13)
    counts = (1, 7, 8, 9, 0, 3, 4, 5, 2, 1, 17)
    segs = tuple((i % 4, c) for i, c in enumerate(counts))
    segs += ((3, TARGET_BLOCK - sum(counts)),)
    lookup_err = max(
        lookup_err,
        check_lookup(torch, "segmented", idxb, wb, Y, segs),
        check_lookup(torch, "segmented_ragged_Lq", idxb[:3, :, :1000].contiguous(),
                     wb[:3, :, :1000].contiguous(), Y[:sum(counts)],
                     tuple((i % 4, c) for i, c in enumerate(counts))),
    )
    rng = np.random.default_rng(7)
    seg_small = tuple((i % 2, c) for i, c in enumerate(counts))
    B_small = sum(counts)
    for name, S_, Lq_, k_, Lp_ in (("k1", 8, 1430, 1, Lp), ("k32", 8, 1430, 32, Lp),
                                   ("subject11_Lp", 2, 8508, 21, SUBJECT11_L),
                                   ("Lp_16384", 2, 1430, 21, 16384),
                                   ("stream_k1", 3, 8508, 1, SUBJECT11_L),
                                   ("stream_k32_Lp_9001", 2, 1000, 32, 9001)):
        ri = rng.integers(0, Lp_, (S_, 2, Lq_, k_)).astype(np.int32)
        ri[:, :, 0], ri[:, :, -1] = 0, Lp_ - 1
        rw = rng.uniform(0, 1, (S_, 2, Lq_, k_)).astype(np.float32)
        rY = rng.standard_normal((B_small, Lp_)).astype(np.float32)
        lookup_err = max(lookup_err, check_lookup(
            torch, name, torch.as_tensor(ri).to(dev), torch.as_tensor(rw).to(dev),
            torch.as_tensor(rY).to(dev), seg_small))
    from repro_torch.kernels.ccm_lookup.ops import _lib as lookup_lib

    # past the two staged target rows one row is staged at a time, past
    # one the gather route runs
    for name, stages in (("Lp_past_two_stages", 2), ("Lp_past_one_stage", 1)):
        Lp_ = lookup_lib().ccm_lookup_max_lp(stages) + 1
        Y_long = torch.as_tensor(rng.standard_normal((3, Lp_)).astype(np.float32))
        lookup_err = max(lookup_err, check_lookup(
            torch, name, idxb[:1], wb[:1], Y_long.to(dev), ((0, 1), (3, 2))))
    del Y_long

    # ---- the prefix kernel against its plain version, significance shapes
    # col_ids: the pipeline's subsampling permutation at seed 0
    perm_key = prng.split(prng.prng_key(0, dev), 2)[0]
    col_ids = subsample_permutation(perm_key, Lp)
    prefix_err = max(
        check_knn_prefix(torch, "sig_buckets", V8, V8, 13, True, bsel,
                         SIG_LIB_SIZES, col_ids),
        check_knn_prefix(torch, "sig_all_E", V8, V8, E_MAX + 1, True, all_E,
                         SIG_LIB_SIZES, col_ids),
        check_knn_prefix(torch, "natural_order", V8, V8, 13, True, bsel,
                         SIG_LIB_SIZES, None),
        check_knn_prefix(torch, "lib0_is_k_plus_1", V8, V8, 13, True, bsel,
                         (14, 700, Lp), col_ids),
        check_knn_prefix(torch, "tied_rows", Vt, Vt, E_MAX + 1, True, all_E,
                         (E_MAX + 2, 100, Vt.shape[-1]),
                         subsample_permutation(perm_key, Vt.shape[-1])),
    )
    # the warp-parallel selection's snapshot edges: library sizes ending
    # inside a 32-wide group (1430 = 44 * 32 + 22), several in one group,
    # few query rows, a constant series under the permuted sweep (every
    # distance ties: the earliest position wins); with exclude_self the
    # self column of some query lies on either side of each snapshot
    Vc_const = lag_batch(torch, np.full((2, FISH1_L), 0.25, np.float32), Lp, dev)
    for name, Vq, Vc, k, excl, sel, sizes, cids in (
        ("mid_group_sizes", V8, V8, 13, True, bsel, (45, 100, Lp), col_ids),
        ("sizes_in_one_group", V8, V8, 13, True, bsel, (40, 45, 60, Lp), col_ids),
        ("mid_group_natural", V8, V8, 13, True, bsel, (45, 100, Lp), None),
        ("Lq_5", V8[..., 700:705].contiguous(), V8, 13, False, bsel, (45, 100, Lp),
         col_ids),
        ("Lq_1", V8[..., 7:8].contiguous(), V8, E_MAX + 1, False, all_E,
         (E_MAX + 1, 333, Lp), col_ids),
        ("constant_permuted", Vc_const, Vc_const, E_MAX + 1, True, all_E,
         (E_MAX + 2, 100, Lp), col_ids),
    ):
        prefix_err = max(prefix_err, check_knn_prefix(torch, name, Vq, Vc, k, excl,
                                                      sel, sizes, cids))
    check_prng(torch, dev)

    # ---- the bfloat16 accumulator: both kernels against the plain bf16
    # version, bit for bit, at the paths' shapes and on tie-heavy lags
    Vq1, Vc1 = V8[..., Lh:].contiguous(), V8[..., :Lh].contiguous()
    Vtie = tied_lags(torch, dev, 3, 400, 12)
    perm400 = subsample_permutation(perm_key, 400)
    b13 = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16)
    knn_bf16_err = max(
        check_knn(torch, "phase2_17E_bf16", V8, V8, 18, True, tuple(range(1, 18)),
                  "bfloat16"),
        check_knn(torch, "phase1_bf16", Vq1, Vc1, E_MAX + 1, False, all_E,
                  "bfloat16"),
        check_knn(torch, "tied_bf16", Vtie, Vtie, E_MAX + 1, True, all_E,
                  "bfloat16"),
        check_knn(torch, "tied_k32_bf16", Vtie, Vtie, 32, True, (4, 11, 20),
                  "bfloat16"),
    )
    prefix_bf16_err = max(
        check_knn_prefix(torch, "sig_shape_bf16", V8, V8, 17, True, b13,
                         SIG_LIB_SIZES, col_ids, "bfloat16"),
        check_knn_prefix(torch, "tied_mid_group_bf16", Vtie, Vtie, 13, True, bsel,
                         (40, 45, 60, 400), perm400, "bfloat16"),
        check_knn_prefix(torch, "tied_natural_bf16", Vtie, Vtie, E_MAX + 1, True,
                         all_E, (22, 100, 400), None, "bfloat16"),
    )

    # ---- the slab kernel of the kNN bench against its plain version ------
    # ragged Lq (130) and Lc (777), both exclude_self settings (self =
    # column q), the tied and constant series above, k above the valid
    # candidates (3.0e38 entries, self and padding ids), k 64 > 32; and
    # the knn_topk kernel's tables wherever k fits the valid candidates.
    # Then each route of the kernel: the threshold filter with the row in
    # shared memory (Lc 16,000) and with its tail in the workspace (Lc
    # 60,000), value ties at Lc 16,000; the exact search where the
    # candidates overflow the buffer (k 2,000), k above its capacity
    # (2,100) and k == Lc_pad (5,120)
    v = [V8[i] for i in range(LIB_BLOCK)]  # (20, 1430) each
    Vl = lag_batch(torch, dummy_brain(2, 60000 + E_MAX, seed=7), 60000, dev)
    Vl_const = torch.full((E_MAX, 16000), 0.25, device=dev)
    slab_cases = [
        check_slab(torch, "Lq128_Lc1000", v[0][:, :128].contiguous(),
                   v[1][:, :1000].contiguous(), E_MAX + 1, False, True),
        check_slab(torch, "Lq130_Lc1430_self", v[2][:, :130].contiguous(), v[2],
                   E_MAX + 1, True),
        check_slab(torch, "Lq1430_Lc1430_self", v[3], v[3], E_MAX + 1, True, True),
        check_slab(torch, "Lq128_Lc777_self", v[4][:, :128].contiguous(),
                   v[4][:, :777].contiguous(), E_MAX + 1, True),
        check_slab(torch, "Lq130_Lc777", v[5][:, :130].contiguous(),
                   v[5][:, :777].contiguous(), E_MAX + 1, False, True),
        check_slab(torch, "tied_rows", Vt[1], Vt[1], E_MAX + 1, True, True),
        check_slab(torch, "repeated_points", Vt[2], Vt[2], E_MAX + 1, True, True),
        check_slab(torch, "constant_series", Vconst[0], Vconst[0], E_MAX + 1,
                   True, True),
        check_slab(torch, "constant_series_k32", Vconst[0][:, :100].contiguous(),
                   Vconst[1], 32, False, True),
        check_slab(torch, "k_above_valid", v[6][:2, :10].contiguous(),
                   v[6][:2, :10].contiguous(), 12, True, expect_big=2 * 10 * 3),
        check_slab(torch, "k64", v[7][:, :128].contiguous(),
                   v[7][:, :1000].contiguous(), 64, False),
        check_slab(torch, "k64_self", v[7], v[7], 64, True),
        check_slab(torch, "Lc16000_on_chip", Vl[0][:, :128].contiguous(),
                   Vl[1][:, :16000].contiguous(), E_MAX + 1, False,
                   expect_route="filter"),
        check_slab(torch, "Lc60000_workspace", Vl[0][:, :128].contiguous(), Vl[1],
                   E_MAX + 1, False, expect_route="filter"),
        check_slab(torch, "Lc16000_constant_self", Vl_const[:, :64].contiguous(),
                   Vl_const, E_MAX + 1, True, expect_route="filter"),
        check_slab(torch, "k2000_overflow", Vl[0][:, :64].contiguous(),
                   Vl[1][:, :16000].contiguous(), 2000, False,
                   expect_route="search"),
        check_slab(torch, "k2100_above_capacity", Vl[1][:, :16].contiguous(),
                   Vl[1][:, :16000].contiguous(), 2100, True,
                   expect_route="search"),
        check_slab(torch, "k_eq_Lc_pad", Vl[0][:, :8].contiguous(),
                   Vl[0][:, :5000].contiguous(), 5120, True,
                   expect_big=E_MAX * 8 * 121, expect_route="search"),
    ]
    slab_err = max(err for err, _ in slab_cases)
    slab_check_routes = {r: sum(routes[r] for _, routes in slab_cases)
                         for r in slab_cases[0][1]}
    if not (slab_check_routes["filter"] > 0 and slab_check_routes["search"] > 0):
        raise AssertionError(f"knn_slab: a route never taken across the checks: "
                             f"{slab_check_routes}")
    del v, Vl, Vl_const

    # ---- the main path; the launch counts start at 0 here ---------------
    out_dir = ROOT / "build" / "smoke_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    knn_topk.LAUNCHES = 0
    ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()  # one progress line per chunk: keep it off stdout
    busy_single = BusySampler()
    try:
        with contextlib.redirect_stdout(log):
            summary = edm_run.main(["--synthetic", f"{args.n}x{FISH1_L}",
                                    "--e-max", str(E_MAX), "--out", str(out_dir)])
    finally:
        busy_single = busy_single.stop()
    print(log.getvalue().strip().splitlines()[-1], flush=True)
    launches = {"knn_topk": knn_topk.LAUNCHES, "ccm_lookup": ccm_lookup.LAUNCHES}
    peak_mem = torch.cuda.max_memory_allocated(dev)
    result = summary["result"]
    rho = np.asarray(result.rho)
    if rho.shape != (args.n, args.n) or not np.isfinite(rho).all():
        raise AssertionError(f"causal map shape {rho.shape} / finite "
                             f"{np.isfinite(rho).all()}")
    if not (launches["knn_topk"] > 0 and launches["ccm_lookup"] > 0):
        raise AssertionError(f"main path missed a kernel: {launches}")
    buckets = tuple(int(b) for b in np.unique(result.optE))
    main_optE = np.asarray(result.optE)
    emit("end_to_end", N=args.n, L=FISH1_L, E_max=E_MAX, lib_block=LIB_BLOCK,
         n_cut_from=53053, wall_s=summary["wall_s"],
         phase1_s=summary["phase1_s"], phase2_s=summary["phase2_s"],
         assemble_s=summary["assemble_s"],
         cross_maps_per_s=summary["cross_maps_per_s"],
         peak_device_bytes=peak_mem, buckets=list(buckets),
         launches=launches, card_busy_sampled=busy_single,
         rho_mean=float(rho.mean()),
         rho_absmax=float(np.abs(rho).max()), smi=smi)
    del result, rho

    wall_single = {"main": summary["wall_s"]}
    main_walls = phase_walls(summary)
    del summary

    # ---- the tiled main path: the same call in column tiles, against
    # end_to_end's store
    tiled_dir = ROOT / "build" / "smoke_tiled"
    shutil.rmtree(tiled_dir, ignore_errors=True)
    tsum, tiled_launches, peak_tiled = run_cli(torch, dev, [
        "--synthetic", f"{args.n}x{FISH1_L}", "--e-max", str(E_MAX),
        "--target-tile", str(MAIN_TILE), "--out", str(tiled_dir)])
    tiled_equal = same_npy_bits(out_dir / "causal_map" / "data.npy",
                                tiled_dir / "causal_map" / "data.npy")
    emit("tiled_main_path", N=args.n, L=FISH1_L, E_max=E_MAX, tile=MAIN_TILE,
         **phase_walls(tsum), launches=tiled_launches,
         peak_device_bytes=peak_tiled,
         tiles_written=len(list(tiled_dir.glob("tile_*.npy"))),
         untiled={**main_walls, "launches": launches, "peak_device_bytes": peak_mem},
         byte_equal_to_untiled=tiled_equal, smi=smi)
    if not tiled_equal:
        raise AssertionError("tiled main-path map != untiled map")
    if min(tiled_launches["knn_topk"], tiled_launches["ccm_lookup"]) < 1:
        raise AssertionError(f"tiled main path missed a kernel: {tiled_launches}")
    del tsum
    shutil.rmtree(tiled_dir, ignore_errors=True)  # out_dir: the fleet's reference
    # ---- the autotuner: recorded, applied, off; and the recommendation of
    # the main path's own store, on the host
    autotune_launches = autotune_phase(torch, dev, smi, out_dir)
    # ---- the main path over several row slots / cards, against out_dir ----
    multi_main = multi_device_main(torch, dev, smi, args.n, out_dir,
                                   {"wall_s": wall_single["main"],
                                    "launches": launches})
    profile_phase2(torch, dev, dummy_brain(args.n, FISH1_L), main_optE, smi)

    # ---- the significance path; the launch counts start at 0 here -------
    sig_dir = ROOT / "build" / "smoke_sig"
    shutil.rmtree(sig_dir, ignore_errors=True)
    knn_topk.LAUNCHES = knn_topk_prefix.LAUNCHES = ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    sig_argv = ["--synthetic", f"{args.sig_n}x{FISH1_L}", "--e-max", str(E_MAX),
                "--lib-sizes", ",".join(map(str, SIG_LIB_SIZES)),
                "--surrogates", str(SIG_M), "--surrogate-kind", "phase",
                "--fdr", "0.05", "--seed", "0"]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        summary = edm_run.main([*sig_argv, "--out", str(sig_dir)])
    sig_launches = {"knn_topk": knn_topk.LAUNCHES,
                    "knn_topk_prefix": knn_topk_prefix.LAUNCHES,
                    "ccm_lookup": ccm_lookup.LAUNCHES}
    peak_sig = torch.cuda.max_memory_allocated(dev)
    for ln in log.getvalue().strip().splitlines()[-2:]:
        print(ln, flush=True)
    out = summary["significance"]
    n = args.sig_n
    maps = {"rho": summary["result"].rho, "drho": out.drho, "trend": out.trend,
            "pvals": out.pvals}
    for name, a in maps.items():
        a = np.asarray(a)
        if a.shape != (n, n) or not np.isfinite(a).all():
            raise AssertionError(f"significance map {name}: shape {a.shape}, "
                                 f"finite {np.isfinite(a).all()}")
    j = np.asarray(out.pvals, np.float64) * (SIG_M + 1)
    if not (np.abs(j - np.rint(j)).max() <= 1e-4
            and np.rint(j).min() >= 1 and np.rint(j).max() <= SIG_M + 1):
        raise AssertionError("p-values outside {j / (m + 1)}")
    if min(sig_launches.values()) < 1:
        raise AssertionError(f"significance path missed a kernel: {sig_launches}")
    sig_buckets = tuple(int(b) for b in np.unique(summary["result"].optE))
    wall_single["significance"] = summary["wall_s"] + summary["significance_s"]
    emit("significance", N=n, L=FISH1_L, E_max=E_MAX, lib_block=LIB_BLOCK,
         lib_sizes=list(SIG_LIB_SIZES), surrogates=SIG_M, surrogate="phase",
         fdr=0.05, seed=0, n_cut_from=53053, wall_s=summary["wall_s"]
         + summary["significance_s"], phase1_s=summary["phase1_s"],
         phase2_s=summary["phase2_s"], assemble_s=summary["assemble_s"],
         significance_s=summary["significance_s"], peak_device_bytes=peak_sig,
         buckets=list(sig_buckets), launches=sig_launches, edges=summary["edges"],
         p_threshold=out.p_threshold, n_tests=out.n_tests,
         drho_mean=float(np.asarray(out.drho).mean()),
         trend_mean=float(np.asarray(out.trend).mean()), smi=smi)
    sig_untiled = {"significance_s": summary["significance_s"], "launches": sig_launches}
    del summary, out, maps

    # ---- the tiled significance stage: the same call in column tiles,
    # against the significance path's store
    sn = args.sig_n
    sig_tiled_dir = ROOT / "build" / "smoke_sig_tiled"
    shutil.rmtree(sig_tiled_dir, ignore_errors=True)
    stsum, sig_tiled_launches, peak_sig_tiled = run_cli(torch, dev, [
        *sig_argv, "--target-tile", str(SIG_TILE), "--out", str(sig_tiled_dir)])
    sig_equal = {a: same_npy_bits(sig_dir / a / "data.npy",
                                  sig_tiled_dir / a / "data.npy")
                 for a in FLEET_ARTIFACTS}
    Lp11 = SUBJECT11_L - (E_MAX - 1) - 1  # 8508
    emit("significance_tiled", N=sn, L=FISH1_L,
         tile=SIG_TILE, surrogates=SIG_M,
         wall_s=stsum["wall_s"] + stsum["significance_s"],
         significance_s=stsum["significance_s"], launches=sig_tiled_launches,
         peak_device_bytes=peak_sig_tiled,
         peak_device_bytes_untiled=peak_sig,
         untiled={"wall_s": wall_single["significance"], **sig_untiled},
         byte_equal_to_untiled=sig_equal,
         surrogate_bytes={"untiled": sn * SIG_M * Lp * 4,
                          "tiled": SIG_TILE * SIG_M * Lp * 4},
         subject11_surrogate_bytes_arithmetic={
             "untiled": SUBJECT11_N * SIG_M * Lp11 * 4,
             "tiled": SIG_TILE * SIG_M * Lp11 * 4},
         edges=stsum["edges"], smi=smi)
    if not all(sig_equal.values()):
        raise AssertionError(f"tiled significance != untiled: {sig_equal}")
    if min(sig_tiled_launches.values()) < 1:
        raise AssertionError(f"tiled significance missed a kernel: "
                             f"{sig_tiled_launches}")
    if not peak_sig_tiled < peak_sig:
        raise AssertionError(f"tiled significance peak {peak_sig_tiled} B not "
                             f"below the untiled {peak_sig} B")
    del stsum
    shutil.rmtree(sig_tiled_dir, ignore_errors=True)  # sig_dir: the fleet's
    multi_sig_launches = multi_device_significance(torch, dev, smi, args.sig_n,
                                                   sig_dir, sig_launches)

    # ---- the all-E phase 2 and the bfloat16 map, each path's counts at 0
    all_e = all_e_phase(torch, dev, smi)
    bf16_map = bf16_map_phase(torch, dev, smi)

    # ---- times with CUDA events at the main path's shapes ---------------
    kb = buckets[-1] + 1
    times = {}
    for case, (Vq, Vc, k, excl, sel, it, it_plain) in {
        "phase2": (V8, V8, kb, True, buckets, 20, 2),
        "phase1": (Vq1, Vc1, E_MAX + 1, False, all_E, 20, 2),
    }.items():
        ms = time_ms(torch, lambda: knn_topk(Vq, Vc, k, excl, sel), it)
        plain = time_ms(torch, lambda: knn_topk_ref(Vq, Vc, k, excl, sel), it_plain)
        # the bfloat16 accumulator at the same shape, checked there first
        knn_bf16_err = max(knn_bf16_err, check_knn(
            torch, f"{case}_path_buckets_bf16", Vq, Vc, k, excl, sel, "bfloat16"))
        ms_bf16 = time_ms(torch, lambda: knn_topk(Vq, Vc, k, excl, sel,
                                                  dist_dtype="bfloat16"), it)
        plain_bf16 = time_ms(torch, lambda: knn_topk_ref(
            Vq, Vc, k, excl, sel, dist_dtype="bfloat16"), it_plain)
        bound, by = bound_ms(*knn_counts(Vq.shape[0], sel[-1], len(sel),
                                         Vq.shape[-1], Vc.shape[-1], k))
        times[case] = dict(kernel_ms=ms, plain_ms=plain, kernel_ms_bf16=ms_bf16,
                           plain_ms_bf16=plain_bf16,
                           bound_us=bound * 1e3, bound_by=by, S=Vq.shape[0],
                           Lq=Vq.shape[-1], Lc=Vc.shape[-1], k=k,
                           select_Es=list(sel))
    Lp11 = SUBJECT11_L - (E_MAX - 1) - 1  # 8508
    V11 = lag_batch(torch, dummy_brain(1, SUBJECT11_L, seed=3), Lp11, dev)
    ms = time_ms(torch, lambda: knn_topk(V11, V11, E_MAX + 1, True, all_E), 3)
    plain = time_ms(torch, lambda: knn_topk_ref(V11, V11, E_MAX + 1, True,
                                                all_E, tile_c=2048), 1, warmup=0)
    bound, by = bound_ms(*knn_counts(1, E_MAX, E_MAX, Lp11, Lp11, E_MAX + 1))
    times["subject11_one_series"] = dict(kernel_ms=ms, plain_ms=plain,
                                         bound_us=bound * 1e3, bound_by=by, S=1,
                                         Lq=Lp11, Lc=Lp11, k=E_MAX + 1,
                                         select_Es=list(all_E))
    emit("time_knn_topk", smi=smi, **times)
    # ---- library-sharded kNN at Subject11's length, on the card and
    # across the ranks of a two-rank torch.distributed world
    sharded_launches = sharded_knn_phase(torch, dev, smi)
    dist_launches = distributed_phase(torch, smi)

    # the significance path's prefix build: one chunk, its bucket set
    kp = sig_buckets[-1] + 1
    prefix_err = max(prefix_err, check_knn_prefix(
        torch, "sig_path_buckets", V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES,
        col_ids))
    ms = time_ms(torch, lambda: knn_topk_prefix(V8, V8, kp, True, sig_buckets,
                                                SIG_LIB_SIZES, col_ids=col_ids), 20)
    plain = time_ms(torch, lambda: knn_topk_prefix_ref(
        V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES, col_ids=col_ids), 2)
    prefix_bf16_err = max(prefix_bf16_err, check_knn_prefix(
        torch, "sig_path_buckets_bf16", V8, V8, kp, True, sig_buckets,
        SIG_LIB_SIZES, col_ids, "bfloat16"))
    ms_bf16 = time_ms(torch, lambda: knn_topk_prefix(
        V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES, col_ids=col_ids,
        dist_dtype="bfloat16"), 20)
    plain_bf16 = time_ms(torch, lambda: knn_topk_prefix_ref(
        V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES, col_ids=col_ids,
        dist_dtype="bfloat16"), 2)
    bound, by = bound_ms(*prefix_counts(V8.shape[0], sig_buckets[-1],
                                        len(sig_buckets), Lp, SIG_LIB_SIZES[-1],
                                        len(SIG_LIB_SIZES), kp))
    ptimes = dict(kernel_ms=ms, plain_ms=plain, kernel_ms_bf16=ms_bf16,
                  plain_ms_bf16=plain_bf16, bound_us=bound * 1e3, bound_by=by,
                  B=V8.shape[0], Lq=Lp, P=SIG_LIB_SIZES[-1],
                  lib_sizes=list(SIG_LIB_SIZES), k=kp, buckets=list(sig_buckets))
    emit("time_knn_topk_prefix", smi=smi, **ptimes)

    import torch.nn.functional as F

    # the chunk's 8 tables at Subject11's Lp, where the stream kernel
    # runs: real tables of Subject11-length series
    V11x8 = lag_batch(torch, dummy_brain(LIB_BLOCK, SUBJECT11_L, seed=3), Lp11, dev)
    idx11, sqd11 = knn_topk(V11x8, V11x8, E_MAX + 1, True, (E_MAX,))
    idx11, w11 = tknn.tables_with_weights_bucketed(idx11, sqd11, (E_MAX,))
    idx11, w11 = idx11[:, 0].contiguous(), w11[:, 0].contiguous()  # (8, 8508, 21)
    Y11 = torch.as_tensor(dummy_brain(TARGET_BLOCK, SUBJECT11_L, seed=9)
                          [:, E_MAX : E_MAX + Lp11]).to(dev).contiguous()
    del V11x8, sqd11
    lookup_err = max(lookup_err, check_lookup(torch, "subject11_chunk_tables",
                                              idx11, w11, Y11))
    ltimes = {}
    for case, (idx, w, Yc) in {"chunk_tables": (idx8, w8, Y),
                               "one_table": (idx8[0], w8[0], Y),
                               "subject11_chunk_tables": (idx11, w11, Y11)}.items():
        S, Lq = (1, idx.shape[0]) if idx.dim() == 2 else idx.shape[:2]
        ms = time_ms(torch, lambda: ccm_lookup(idx, w, Yc), 50)
        plain = time_ms(torch, lambda: ccm_lookup_ref(idx, w, Yc), 5)
        # one library call computing the same function: embedding_bag
        # over the transposed targets (the transpose is set-up, untimed)
        YT = Yc.t().contiguous()
        il, wl = idx.reshape(-1, idx.shape[-1]).long(), w.reshape(-1, w.shape[-1])
        lib_out = F.embedding_bag(il, YT, per_sample_weights=wl, mode="sum")
        want = ccm_lookup_ref(idx, w, Yc)
        lib_pred = lib_out.reshape(S, Lq, -1).transpose(1, 2).reshape(want.shape)
        lib_err = float((lib_pred - want).abs().max())
        del lib_out, want, lib_pred
        lib = time_ms(torch, lambda: F.embedding_bag(il, YT, per_sample_weights=wl,
                                                     mode="sum"), 50)
        bound, by = bound_ms(*lookup_counts(S, Yc.shape[0], Lq, Yc.shape[1],
                                            idx.shape[-1]))
        ltimes[case] = dict(kernel_ms=ms, plain_ms=plain, library_ms=lib,
                            library_max_abs_diff=lib_err, bound_us=bound * 1e3,
                            bound_by=by, S=S, B=Yc.shape[0], Lq=Lq, Lp=Yc.shape[1],
                            k=idx.shape[-1])
    del idx11, w11, Y11
    # the segmented launches of one phase-2 chunk at the main path's real
    # segment mix: the run's bucket plan cut into target blocks, the
    # chunk's tables at its bucket set
    from repro_torch.core import ccm as tccm

    bplan, _ = tccm.make_bucket_plan(main_optE)
    blocks = tccm.target_blocks(tuple(enumerate(bplan.counts)), TARGET_BLOCK)
    idxm, sqdm = knn_topk(V8, V8, kb, True, buckets)
    idxm, wm = tknn.tables_with_weights_bucketed(idxm, sqdm, buckets)
    Ym = torch.as_tensor(dummy_brain(bplan.n_targets, FISH1_L, seed=8)
                         [:, E_MAX : E_MAX + Lp]).to(dev).contiguous()

    def chunk_lookups(fn):
        return [fn(idxm, wm, Ym[b0:b1], segs) for b0, b1, segs in blocks]

    # the kernel against its plain version on these very launches
    got, want = chunk_lookups(ccm_lookup), chunk_lookups(ccm_lookup_ref)
    seg_err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    seg_tol = 1e-6 * float(Ym.abs().max())
    emit("check_lookup", case="segmented_chunk_main_mix", idx_shape=list(idxm.shape),
         B=Ym.shape[0], Lp=Ym.shape[1], launches=len(blocks),
         segments=[len(sg) for _, _, sg in blocks], max_abs_err=seg_err, tol=seg_tol,
         bit_equal=all(same_bits(torch, g, r) for g, r in zip(got, want)))
    if not seg_err <= seg_tol:
        raise AssertionError(f"ccm_lookup kernel != plain version "
                             f"(segmented_chunk_main_mix): {seg_err} > {seg_tol}")
    lookup_err = max(lookup_err, seg_err)
    del got, want
    ms = time_ms(torch, lambda: chunk_lookups(ccm_lookup), 10)
    plain = time_ms(torch, lambda: chunk_lookups(ccm_lookup_ref), 1)
    bound, by = bound_ms(*segmented_counts(LIB_BLOCK, blocks, Lp, Lp, kb))
    ltimes["segmented_chunk"] = dict(
        kernel_ms=ms, launches=len(blocks), kernel_ms_per_launch=ms / len(blocks),
        plain_ms=plain, library_ms=None, bound_us=bound * 1e3, bound_by=by,
        S=LIB_BLOCK, n_buckets=len(buckets), B=bplan.n_targets, Lq=Lp, k=kb,
        segments_per_launch=[len(sg) for _, _, sg in blocks])
    emit("time_ccm_lookup", smi=smi, **ltimes)

    profile_paths(torch, dev, PROFILE_N, smi)

    # ---- engine check: cuda vs torch-reference ---------------------------
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig

    for case, n, L, ref_dev in (("card", CHECK_N, FISH1_L, dev),
                                ("cpu_reference", 24, 400, "cpu")):
        ts = dummy_brain(n, L, seed=4)
        got = run_causal_inference(ts, EDMConfig(E_max=E_MAX, engine="cuda"),
                                   device=dev)
        want = run_causal_inference(ts, EDMConfig(E_max=E_MAX,
                                                  engine="torch-reference"),
                                    device=ref_dev)
        optE_eq = bool(np.array_equal(got.optE, want.optE))
        err = float(np.abs(got.rho - want.rho).max())
        emit("engine_check", case=case, N=n, L=L, reference_device=str(ref_dev),
             optE_equal=optE_eq, rho_max_abs_err=err, tol=1e-5,
             simplex_rho_max_abs_err=float(np.abs(got.simplex_rho
                                                  - want.simplex_rho).max()))
        if not (optE_eq and err <= 1e-5):
            raise AssertionError(f"cuda engine != torch-reference ({case})")

    # ---- significance engine check: cuda vs torch-reference --------------
    from repro_torch.inference import SignificanceConfig, run_significance

    ts = dummy_brain(CHECK_N, FISH1_L, seed=6)
    cmap = run_causal_inference(ts, EDMConfig(E_max=E_MAX), device=dev)
    sig = SignificanceConfig(lib_sizes=SIG_LIB_SIZES, n_surrogates=SIG_CHECK_M,
                             alpha=0.05, seed=0)
    ref_cfg = EDMConfig(E_max=E_MAX, engine="torch-reference")
    got = run_significance(ts, cmap.optE, cmap.rho, EDMConfig(E_max=E_MAX), sig,
                           device=dev)
    want = run_significance(ts, cmap.optE, cmap.rho, ref_cfg, sig, device=dev)
    trend_tie, p_tie = sig_near_ties(torch, ts, cmap.optE, cmap.rho, ref_cfg, sig,
                                     dev)
    drho_err = float(np.abs(got.drho - want.drho).max())
    trend_bad = int((got.trend != want.trend)[~trend_tie].sum())
    p_bad = int((got.pvals != want.pvals)[~p_tie].sum())
    emit("sig_engine_check", N=CHECK_N, L=FISH1_L, m=SIG_CHECK_M,
         drho_max_abs_err=drho_err, tol=1e-5, near_tie=NEAR_TIE,
         trend_near_ties_skipped=int(trend_tie.sum()),
         p_near_ties_skipped=int(p_tie.sum()), trend_mismatches=trend_bad,
         p_mismatches=p_bad, trend_equal_all=bool(np.array_equal(got.trend,
                                                                 want.trend)),
         pvals_equal_all=bool(np.array_equal(got.pvals, want.pvals)),
         edges=[len(got.edges), len(want.edges)])
    if not (drho_err <= 1e-5 and trend_bad == 0 and p_bad == 0):
        raise AssertionError("cuda engine != torch-reference (significance)")

    # ---- the wide kernels (k past 32, E past 32, more than 64 library
    # sizes or segments a launch) and a recording past the lookup's two
    # staged target rows, each map's counts set to 0 just before it
    wide = wide_tables_phase(torch, dev, smi)
    longrec = long_recording_phase(torch, dev, smi)
    # ---- tables past 128 neighbours: the kNN kernels' key-select route
    deep = deep_tables_phase(torch, dev, smi)

    # ---- the port's kNN bench (the slab kernel's path) and the dry runs
    # of Fish1_Normo and Subject11 at their own N and L
    bknn = bench_knn(torch, dev, smi)
    bench_gate_phase(torch, dev, smi)
    dry = dryrun_phase(torch, dev, smi)

    # ---- the fleet: W worker processes on the card, each with its own
    # context; what this process still holds on the card is released first
    del V8, V11, idx8, w8, Y, idxb, wb, Ym, idxm, wm, Vt, Vq1, Vc1, Vtie, Vconst
    del Vc_const, ts8, got, want, cmap
    gc.collect()
    torch.cuda.empty_cache()
    fleet = fleet_phases(torch, smi, args.n, args.sig_n, out_dir, launches,
                         sig_dir, sig_launches, wall_single, busy_single)
    # ---- rows across ranks: two gloo edm_run ranks sharing card 0 against
    # the one-process stores of the same calls
    ranks_main = ranks_phase(
        torch, smi, "ranks_main", 2,
        ["--synthetic", f"{args.n}x{FISH1_L}", "--e-max", str(E_MAX)], out_dir,
        ("causal_map",), {"wall_s": wall_single["main"], "launches": launches},
        ids=(0, 0))
    ranks_sig = ranks_phase(
        torch, smi, "ranks_significance", 2, sig_argv, sig_dir, FLEET_ARTIFACTS,
        {"wall_s": wall_single["significance"], "launches": sig_launches},
        ids=(0, 0))
    # ---- the run history of every store above, in one file -------------
    build = ROOT / "build"
    trends_phase(torch, dev, smi, sig_argv, sig_dir, [out_dir, sig_dir] + [
        build / f"smoke_{x}" for x in ("fleet_main", "fleet_sig", "fleet_kill",
                                       "fleet_faults", "ranks_main",
                                       "ranks_significance")])
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(sig_dir, ignore_errors=True)
    engine_check_cli(smi)
    ext_launches = extensions_phase(torch, dev, smi)

    # ---- the kernels line --------------------------------------------------
    k2, k1 = times["phase2"], times["phase1"]
    l8 = ltimes["chunk_tables"]
    slab64 = bknn["kernel_times"][str(max(int(lc) for lc in bknn["kernel_times"]))]
    dry_launches = {name: r["launches"] for name, r in dry.items()}
    line = {"kernels": [
        {"name": "knn_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
         "replaces": "src/repro/kernels/knn_topk/knn_topk.py:211",
         "launches": launches["knn_topk"],
         "launches_significance": sig_launches["knn_topk"],
         "max_abs_err": max(knn_err, range_err),
         "ms": k2["kernel_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_us"] / 1e3,
         "bound_by": k2["bound_by"], "library_ms": None,
         "ms_phase1": k1["kernel_ms"],
         "plain_ms_phase1": k1["plain_ms"], "bound_ms_phase1": k1["bound_us"] / 1e3,
         "ms_bf16": k2["kernel_ms_bf16"], "plain_ms_bf16": k2["plain_ms_bf16"],
         "ms_phase1_bf16": k1["kernel_ms_bf16"],
         "plain_ms_phase1_bf16": k1["plain_ms_bf16"],
         "max_abs_err_bf16": knn_bf16_err,
         "launches_tiled_main_path": tiled_launches["knn_topk"],
         "launches_autotune": {k: v["knn_topk"] for k, v in autotune_launches.items()},
         "launches_significance_tiled": sig_tiled_launches["knn_topk"],
         "launches_all_e": {k: v["launches"]["knn_topk"]
                            for k, v in all_e["runs"].items()},
         "launches_bf16_map": bf16_map["launches"]["knn_topk"],
         "launches_fleet": {k: v["knn_topk"] for k, v in fleet.items()},
         "launches_dryrun": {k: v["knn_topk"] for k, v in dry_launches.items()},
         "launches_bench_knn": bknn["launches"]["knn_topk"],
         "launches_multi_device_main": {k: v["launches"]["knn_topk"]
                                        for k, v in multi_main.items()},
         "launches_multi_device_significance": multi_sig_launches["knn_topk"],
         "launches_sharded_knn": sharded_launches,
         "launches_distributed": dist_launches,
         "launches_ranks_main": ranks_main["launches"]["knn_topk"],
         "launches_ranks_significance": ranks_sig["launches"]["knn_topk"],
         "launches_extensions": ext_launches["knn_topk"],
         "max_abs_err_column_range": range_err,
         "max_abs_err_column_range_bf16": range_bf16_err,
         "launches_wide_map": wide["launches"]["knn_topk"],
         "launches_long_recording": longrec["launches"]["knn_topk"],
         "max_abs_err_wide": wide["max_abs_err"]["knn_topk"],
         **wide_line(wide["times"]["knn_topk"]),
         "launches_deep_map": deep["launches"]["knn_topk"],
         "launches_by_route_deep_map": deep["launches_by_route"],
         "max_abs_err_deep": deep["max_abs_err"]["knn_topk"],
         **wide_line(deep["times"]["knn_topk"], "deep"),
         "checked": True, "checked_bf16": True, "checked_column_range": True,
         "checked_wide": True, "checked_key_select": True},
        {"name": "ccm_lookup", "route": "cuda",
         "source": "src/repro_torch/kernels/ccm_lookup/csrc/ccm_lookup.cu",
         "replaces": "src/repro/kernels/ccm_lookup/ccm_lookup.py:24",
         "launches": launches["ccm_lookup"],
         "launches_significance": sig_launches["ccm_lookup"],
         "max_abs_err": lookup_err,
         "ms": l8["kernel_ms"], "plain_ms": l8["plain_ms"],
         "bound_ms": l8["bound_us"] / 1e3,
         "bound_by": l8["bound_by"], "library_ms": l8["library_ms"],
         "ms_segmented_chunk": ltimes["segmented_chunk"]["kernel_ms"],
         "bound_ms_segmented_chunk": ltimes["segmented_chunk"]["bound_us"] / 1e3,
         "ms_subject11_Lp": ltimes["subject11_chunk_tables"]["kernel_ms"],
         "bound_ms_subject11_Lp":
             ltimes["subject11_chunk_tables"]["bound_us"] / 1e3,
         "launches_tiled_main_path": tiled_launches["ccm_lookup"],
         "launches_autotune": {k: v["ccm_lookup"]
                               for k, v in autotune_launches.items()},
         "launches_significance_tiled": sig_tiled_launches["ccm_lookup"],
         "launches_all_e": {k: v["launches"]["ccm_lookup"]
                            for k, v in all_e["runs"].items()},
         "launches_fleet": {k: v["ccm_lookup"] for k, v in fleet.items()},
         "launches_dryrun": {k: v["ccm_lookup"] for k, v in dry_launches.items()},
         "launches_multi_device_main": {k: v["launches"]["ccm_lookup"]
                                        for k, v in multi_main.items()},
         "launches_multi_device_significance": multi_sig_launches["ccm_lookup"],
         "launches_ranks_main": ranks_main["launches"]["ccm_lookup"],
         "launches_ranks_significance": ranks_sig["launches"]["ccm_lookup"],
         "launches_wide_map": wide["launches"]["ccm_lookup"],
         "launches_long_recording": longrec["launches"]["ccm_lookup"],
         "max_abs_err_wide": max(wide["max_abs_err"]["ccm_lookup"],
                                 longrec["max_abs_err"]),
         **wide_line(wide["times"]["ccm_lookup"]),
         "library_ms_wide": {c: t["library_ms"] for c, t in
                             wide["times"]["ccm_lookup"].items() if "library_ms" in t},
         "launches_deep_map": deep["launches"]["ccm_lookup"],
         "max_abs_err_deep": deep["max_abs_err"]["ccm_lookup"],
         **wide_line(deep["times"]["ccm_lookup"], "deep"),
         "library_ms_deep": {c: t["library_ms"] for c, t in
                             deep["times"]["ccm_lookup"].items() if "library_ms" in t},
         "ms_Lp36000": longrec["lookup"]["kernel_ms"],
         "plain_ms_Lp36000": longrec["lookup"]["plain_ms"],
         "bound_ms_Lp36000": longrec["lookup"]["bound_ms"],
         "library_ms_Lp36000": longrec["lookup"]["library_ms"],
         "checked": True, "checked_wide": True},
        {"name": "knn_topk_prefix", "route": "cuda",
         "source": "src/repro_torch/kernels/knn_topk/csrc/knn_topk_prefix.cu",
         "replaces": "src/repro/kernels/knn_topk/knn_topk.py:398",
         "launches": sig_launches["knn_topk_prefix"],
         "launches_significance": sig_launches["knn_topk_prefix"],
         "max_abs_err": prefix_err, "ms": ptimes["kernel_ms"],
         "plain_ms": ptimes["plain_ms"], "bound_ms": ptimes["bound_us"] / 1e3,
         "bound_by": ptimes["bound_by"], "library_ms": None,
         "ms_bf16": ptimes["kernel_ms_bf16"], "plain_ms_bf16": ptimes["plain_ms_bf16"],
         "max_abs_err_bf16": prefix_bf16_err,
         "launches_significance_tiled": sig_tiled_launches["knn_topk_prefix"],
         "launches_fleet": {k: v["knn_topk_prefix"] for k, v in fleet.items()},
         "launches_multi_device_significance":
             multi_sig_launches["knn_topk_prefix"],
         "launches_ranks_significance": ranks_sig["launches"]["knn_topk_prefix"],
         "max_abs_err_wide": wide["max_abs_err"]["knn_topk_prefix"],
         **wide_line(wide["times"]["knn_topk_prefix"]),
         "max_abs_err_deep": deep["max_abs_err"]["knn_topk_prefix"],
         **wide_line(deep["times"]["knn_topk_prefix"], "deep"),
         "checked": True, "checked_bf16": True, "checked_wide": True,
         "checked_key_select": True},
        {"name": "flash_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:26",
         "launches": serve["launches"]["flash_attn"],
         "launches_by_route": serve["launches_by_route"], "max_abs_err": flash_err,
         "max_abs_err_grid_65540": fgrid["max_abs_err"],
         "ms_grid_65540": fgrid["kernel_ms"],
         "ms": ftimes["kernel_ms"],
         "plain_ms": ftimes["plain_ms"],
         "bound_ms": ftimes["bound_ms"], "bound_by": ftimes["bound_by"],
         "library_ms": ftimes["library_ms"],
         "ms_dbrx": ftimes_moe["kernel_ms"], "plain_ms_dbrx": ftimes_moe["plain_ms"],
         "bound_ms_dbrx": ftimes_moe["bound_ms"],
         "library_ms_dbrx": ftimes_moe["library_ms"],
         "launches_lm_moe_serve": serve_moe["launches"]["flash_attn"],
         "launches_lm_moe_check": sum(check_moe["flash_launches_forward"].values()),
         "launches_lm_ssm_serve": serve_ssm["launches"]["flash_attn"],
         "launches_lm_ssm_check": sum(check_ssm["flash_launches_forward"].values()),
         **{f"launches_lm_{fam}_serve": r["launches_prefill"]
            for fam, r in serve_more.items()},
         **{f"launches_lm_{fam}_check": r["flash_launches_forward"]
            for fam, r in check_more.items()},
         **{f"{name}_{part}": t[key] for part, t in ftimes_new.items()
            for key, name in (("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
                              ("library_ms", "library_ms"), ("bound_ms", "bound_ms"))},
         "launches_fleet": {k: v["flash_attn"] for k, v in fleet.items()},
         "launches_train": tstep["flash_launches_per_step"][-1],
         "launches_flash_positions": fpos["launches"],
         "max_abs_err_positions_f32": fpos["max_abs_err_f32"],
         **{f"{key}_positions_{case.split('_')[0]}": t[key] for case, t in fpos["times"].items()
            for key in ("ms", "plain_ms", "library_ms", "bound_ms") if key in t},
         **{f"ms_positions_{case.split('_')[0]}": t["kernel_ms"]
            for case, t in fpos["times"].items()},
         "train_step_s": tstep["step_s_mean"],
         "backward_ms_train_shape": tcheck["bfloat16"]["backward_ms"],
         "checked": True, "checked_grad": True},
        {"name": "knn_slab", "route": "cuda",
         "source": "src/repro_torch/kernels/knn_slab/csrc/knn_slab.cu",
         "replaces": "benchmarks/run.py:476",
         "launches": bknn["launches"]["knn_slab"],
         "max_abs_err": max(slab_err, bknn["max_abs_err"]),
         "ms": slab64["kernel_ms"], "plain_ms": slab64["plain_ms"],
         "bound_ms": slab64["bound_ms"], "bound_by": slab64["bound_by"],
         "library_ms": None,
         "ms_by_Lc": {lc: t["kernel_ms"] for lc, t in bknn["kernel_times"].items()},
         "routes": bknn["routes"],
         "routes_by_Lc": {lc: t["routes"] for lc, t in bknn["kernel_times"].items()},
         "routes_checks": slab_check_routes,
         "checked": True},
    ]}
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(line), flush=True)
    print(card_line(dev), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
