#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each; any failure exits non-zero before the last
line is printed:

1. device — torch/CUDA versions, the card's name and power limit.
2. build — compile every kernel of the port with nvcc (sm_90a) from the
   sources in the checkout, one nvcc each, all at once.
3. kernel vs plain — the fused kernel's wrapper against its plain
   PyTorch version on the card, on the same key and inputs; all four
   KYResult fields must be equal; lane shards (``lane0``) of one launch
   equal its rows, and a ``lane0`` past 2**32 words equals the plain
   version; a row map equal to the contiguous layout gives the unmapped
   launch's rows, and a scattered one the rows it names and the plain
   version's fields.
4. serve — ``PosteriorEngine.answer_batch`` on hailfinder_scale (56
   nodes, engine defaults but a 32-sweep burn-in, budget 2048) with
   ``sampler="cuda"``: 64 synthetic queries
   over 4 evidence patterns, cold and warm pass, launch counters zeroed
   just before and read just after (launches per (b, L) and per engine
   round included; no bit words made on the host: the kernel makes its
   own); every query of both passes must equal the same query through
   ``sampler="torch"`` bit for bit, cold and then warm from the timed
   warm pass's key (``plain_identity``), and a sprinkler posterior must land
   within 0.03 of exact.
5. kernel at the main path's inputs — the first recorded call of each
   (b, L) launched again, held against the recorded result and the plain
   version, then timed; the bound counts every recorded launch.
6. mrf_gibbs — the paper's MRF configs through ``run_mcmc``'s MRF branch
   at their published sizes (aia-mrf-penguin 500 x 333, L 2;
   aia-mrf-art 288 x 384, L 16; 16 chains): 20 and 10 sweeps with
   ``sampler="cuda"`` equal to ``"torch"`` bit for bit (labels, bits,
   attempts); then aia-mrf-penguin's 1000 sweeps on the kernel, timed
   (site samples per second, bits per sample, accuracy against the
   task's truth), exactly 2 launches a sweep, and the kernel at
   (2,664,000, 2) and (1,769,472, 16) held to the recorded result and
   the plain version and timed with a cold L2 beside its bound.
7. mesh_gibbs — distributed halo-exchange Gibbs on a 2 x 2 tile mesh
   (``cuda:0..3`` on a host with four cards, else ``cuda:0`` four times;
   a line says which) at aia-mrf-penguin's 500 x 333 (pads to 500 x
   334), 16 chains: 10 sweeps ``sampler="cuda"`` equal to ``"torch"``
   and ``comm="halo"`` equal to ``"allgather"`` bit for bit, the bytes
   each copies per half-step beside the per-tile formulas; 200 sweeps
   timed (site samples per second, bits per sample, accuracy at least
   0.95, 2 launches a tile a sweep); the clamped step once.
8. metropolis — ``mrf_metropolis`` on aia-mrf-penguin (100 sweeps) and
   ``fg_metropolis`` on the 65,536-spin sparse glass on the card
   (acceptance rate, bits), and both on the card against the CPU at
   50 x 34 / 4,096 spins, bit for bit.
9. serve_mrf — ``mrf_penguin`` served at 500 x 333: 8 ``MrfQuery`` over
   2 scribble patterns, 8 chains a query, cold and warm, every query
   of both passes bitwise against ``sampler="torch"``
   (``plain_identity``); launches counted, no host bit words.
10. serve_ising — ``ising_torus`` at side 256 (65,536 spins, iterated-MIS
   colouring): 16 ``IsingQuery`` over 2 clamp patterns, cold and warm,
   every query of both passes bitwise against ``sampler="torch"``;
   ``run_fg_gibbs`` on a random
   sparse spin glass of 65,536 spins with a degree-16 bucket, bitwise;
   and the torus at β 0.6 started all up within 0.03 of Onsager's
   magnetization.
11. serve_queue — phase 4's 64 queries through ``AdmissionQueue`` on the
   card (``submit_many`` + ``flush``, one group a pattern): its dispatcher
   thread launches the kernel, and the results must equal phase 4's cold
   ``answer_batch`` bit for bit; dispatch log, groups and backfills.
12. serve_sharded — phase 4's traffic through ``PosteriorEngine(mesh=
   make_serve_mesh((4,), ...))`` (lanes split over four batch shards,
   each launching at its ``lane0``): equal to phase 4's cold pass bit for
   bit; one 500 x 333 ``MrfQuery`` and one side-256 ``IsingQuery``
   sharded and unsharded, bitwise; a lane-padding case (6 chains a
   query) within 0.05 of exact.
13. serve_model_axis — the serve mesh's "model" axis on a 2 x 2
   ``make_serve_mesh`` over ``cuda:0..3`` (else the card four times):
   ``ising_torus(1024)`` (1,048,576 spins) and ``random_sparse_ising(
   2**20)`` held as site blocks, IsingQuery traffic cold and warm with
   ``sampler="cuda"``, one fused launch a (batch shard, block, colour)
   with a row map, bitwise against the 1-D batch mesh and (the torus)
   against ``sampler="torch"``; a random Bayes net whose 5,668,276-element
   log-CPT bank splits into bank blocks and one whose odd bank stays
   whole, bitwise against the 1-D mesh; the bytes a colour update copies
   between "model" positions counted by ``partition.KINDS`` equal to the
   plans' reckoning; the largest site-block launch re-run against its
   recorded result and the plain version, timed beside its bound.
14. serve_stream — ``cli.measure_stream`` on 4 hailfinder_scale sensor
   streams x 4 slices (``synthetic_stream_traffic``), replayed open-loop
   at 4x the measured one-at-a-time rate through the deadline scheduler:
   queries/s, p50/p99 ms, speedup, every later slice warm-started, the
   trace and metrics exports parsed; the card's busy share by
   torch.profiler over a second replay; a sprinkler stream within 0.03
   of exact slice by slice.
15. serve_wire — a two-worker ``WorkerPool`` on the card behind
   ``ServeFrontEnd`` (127.0.0.1, ephemeral port): one /v2/batch of 16
   hailfinder_scale queries, a MAP query and a scribble-mask
   ``MrfQuery`` at 500 x 333, each response bitwise equal to the
   in-process ``answer_batch``; a WebSocket stream of 3 slices of one
   stream (slices 1-2 warm-started); a 429 on a quota overrun;
   ``/healthz``, ``/stats``, ``/metrics``.
16. ky_sampler — the stand-alone kernel API's KY sampler,
   ``ops.ky_sample_kernel``, at the sizes of
   ``benchmarks/bench_ky_vs_cdf.py`` (65536 rows, n in {4, 16, 64},
   Dirichlet 0.3, 12-bit weights), a ragged (133, 7) case with an
   all-zero row and a (65536, 3) frequency check; all four fields
   equal to the plain version on the card; bits per sample beside
   ``cdf_sample``'s 32; at 65536 x 64 also the device time of one whole
   call (``call_ms``) and of its bit words alone (``words_ms``).
17. interp_lut — ``ops.interp_kernel`` at ``benchmarks/bench_interp.py``'s
   (4096, 1024) for the exp and sigmoid tables, inputs past both ends of
   the range, and ragged (37, 64) and (1, 1000): bitwise equal to the
   plain version.
18. flash_attention — ``flash_mha`` at phi4-mini's attention (B 1,
   S 4096, 24 heads, 8 kv heads, dh 128, causal) and ``flash_attention``
   at the five shapes of ``tests/test_kernels.py``, each in bfloat16 and
   float16 (the tensor-core kernel) and float32 (the CUDA-core kernel),
   all within the JAX tests' tolerances of the plain ``mha_ref`` on the
   same inputs; the bfloat16 and float16 cases also per row, within 2e-2
   (bfloat16) or 2e-3 (float16) of the row's largest output; each
   route's launches counted; both routes timed at full width beside SDPA.
19. lm_generate — the LM serving path (``models.sampling.generate``, the
   ``--arch`` half of ``launch/serve.py``) on the card at full width with
   random weights from a seeded generator: phi4-mini-3.8b (bf16, 32
   layers, vocab 200,064) and mamba2-130m, batch 4, prompt 16, 32 new
   tokens, with the ky, categorical and greedy samplers and ky again at
   the first step's logit standard deviation; tok/s, ms a decode step,
   bits a token, the steps' entropy (the run's tokens fed back), a
   decode step alone beside its bytes bound, device launches of one
   profiled step, peak memory.  Then every family at smoke size in
   float32, the card against the CPU in one process: decode logits
   within 1e-5 of the largest, greedy tokens equal, the KY token stages
   bit for bit on the same integer weights.  No kernel of the port is on
   this path (the reference's models call no Pallas kernel, and its KY
   token walks are plain XLA): every launch count must stay 0 over it.
20. lm_train — first every family at smoke size, the card against the
   CPU: loss and every gradient leaf, one train step for each optimizer
   kind, microbatch 2 against the full batch.  Then the training path
   (``launch/train.py``'s loop: ``init_train_state``, ``make_train_step``,
   ``StepGuard``, ``TokenDataset``) on the card at full width with random
   weights from a seeded generator: phi4-mini-3.8b with its config's
   settings (AdamW, float32 moments, microbatch 2, remat "full"), batch
   8 x 128 tokens, 4 steps (loss and gradient norm finite, median ms a
   step over steps 2-4, tok/s, peak memory beside the state's 16 bytes a
   parameter, busy share, launches and top ops of one profiled step, the
   step beside its bound) and mamba2-130m (microbatch 8), 4 steps, then
   its state saved, restored into a state of other weights and stepped
   once more, equal to the live state's next step bit for bit; zero
   retries.  No kernel of the port is on this path either: every launch
   count must stay 0 over it.
21. lm_mesh — the training path on a ("data", "model") mesh
   (``launch/train.py --mesh 2x2``: ``place_model``, ``init_train_state``,
   ``make_train_step(mesh=)``, ``StepGuard``): phi4-mini-3.8b at full
   width with its config's settings on a 2 x 2 mesh over
   ``mesh_devices(4)``, batch 8 x 128, 4 steps (median ms a step beside
   ``lm_train``'s 1 x 1 median from this process, peak memory beside the
   state's 16 bytes a parameter and the 1 x 1 peak, the bytes a step
   copied between mesh positions counted by ``partition.TRAFFIC`` and
   reckoned from the layout, launches and busy share of one profiled
   step); then the 2 x 2 step against the 1 x 1 step at full width cut
   to 2 layers, in float32 (loss within 1e-5 relative, each gradient leaf
   within 1e-4 of its largest, parameters after one AdamW step within
   5e-4) and in bf16 (LM_MESH_BF16); granite-20b smoke in float32 on 4 x 2
   (8 x the card) and every family's smoke on 4 x 1 against one device;
   the builders' train, prefill and decode cells on 2 x 2 against 1 x 1
   for granite smoke (a cache split on the sequence) and phi4 smoke (on
   kv heads): prefill logits within 1e-5 of the largest, decode tokens
   equal; a 2 x 2 checkpoint restored onto 4 x 1 and 1 x 1 bit for bit,
   the restored next step bitwise, two mesh steps bitwise.  No kernel of
   the port: every launch count must stay 0.
   Phase 22 also holds, against one device, a train step of the MoE with
   its experts over "model" (llama4 and grok-1 smoke on 2 x 2) and with
   its expert ffn over "model" (grok-1 smoke on 1 x 4) and of the hybrid
   (hymba smoke on 2 x 2), and hymba smoke's builders' cells.
22. lm_mesh_families — the MoE, SSM and hybrid families on a "model"
   axis of 2 (LM_FAMILIES_MESH), over ``mesh_devices(4)``:
   hymba-1.5b at full width and depth with its config's training
   settings, batch 8 x 128, 1 warm-up and 2 timed steps on 1 x 1 and on
   2 x 2 (median ms beside the 8 N T bound, peak memory, the bytes a step
   copied between positions counted and reckoned from the layout, one
   profiled mesh step's launches and busy share), then prefill 4 x 512
   and 32 greedy decode steps on 2 x 2 (its SSM state split on 50 heads
   and 3,232 conv channels; tok/s, ms a step beside its bytes bound);
   llama4-scout-17b-a16e at full width cut to 4 layers served the same
   way on 1 x 1 and on 2 x 2 (8 experts a "model" position), and at 2
   layers in float32 2 x 2 against 1 x 1 (prefill and first-step logits
   within LM_SERVE_MESH_TOL of the largest, greedy tokens equal over 8
   steps); mamba2-130m at full width, a train step and the serving on 1
   x 1 and 2 x 2 in bf16 (loss within 1e-2 relative, logits within
   LM_SSM_MESH_LOGIT_BF16); hymba's 2 x 2 step against 1 x 1 at 2 layers
   in float32 and bf16 (LM_MESH_TOL, LM_MESH_BF16).  In every 2 x 2
   decode step of hymba and mamba2 the SSM state is updated where
   cache_specs keep it: no copy between positions may carry a block of
   it (0 bytes), and the copies and bytes between positions by kind
   must equal the dry run's of the same cell (the new token's columns
   under segment "ssm_state" too); the decode ms a step is printed beside
   LM_FAMILIES_DECODE_MS_BEFORE.  No kernel of the port: every launch
   count must stay 0.
23. lm_mesh_optim — the training step's "dots" remat and Adafactor's
   update where its blocks lie, on a ("data", "model") mesh over
   ``mesh_devices(4)`` (LM_MESH_OPTIM): phi4-mini-3.8b at full width on
   2 x 2 with remat "dots" (its config's settings otherwise, batch 8 x
   128, 1 warm-up and 2 timed steps: ms a step, peak memory, bytes
   between positions, a profiled step's launches and busy share, each
   beside phase 21's "full" figures); at 2 layers in bf16 the matrix
   products one microbatch dispatches forward and backward under "full"
   and "dots", and the loss, grad norm and parameters after one step
   equal to "full"'s bit for bit; the dots step's bytes between
   positions within LM_DRYRUN["bytes_rtol"] of its dry run over four
   ``meta`` devices.  grok-1-314b at full width cut to 1 of its 64
   layers (Adafactor, bf16 parameters, 8 experts top-2, softcap 30;
   microbatch 1), trained on 1 x 1 and then on 2 x 2 from the same
   weights: step and update ms, peak memory of each, the update's bytes
   between positions (segment "optimizer") equal to the statistics and
   scalars reckoned from the layouts, beside what the whole-leaf update
   would have moved; after the first step the loss and grad norm, and
   the 2 x 2 update given the 1 x 1 step's gradients from the same
   state, within LM_MESH_BF16 of 1 x 1 (the whole step's gradients and
   parameters measured against it and printed).  No kernel of the port:
   every launch count must stay 0; at most 150 s.
24. lm_dryrun — the planning tools (``launch/dryrun.py``,
   ``launch/roofline.py``) held against phases 21 and 22: the dry run of
   the same configuration (phi4-mini-3.8b at full width, 2 x 2, batch 8 x
   128, microbatch 2, remat "full", AdamW) over four ``meta`` devices,
   one layer traced and scaled, must count the bytes between mesh
   positions phase 21 counted within 0.01 % (the layout's reckoning
   printed beside them), and its argument bytes summed over positions
   must equal the bytes of the placed state's shards counted from the
   tensors; its transient bytes are printed beside the measured peak
   less that state (no gate); the same two checks for hymba-1.5b's 2 x 2
   step of phase 22.  Then phi4-mini's four production cells on the 16 x
   16 mesh of ``meta`` devices: status, GB a device, bottleneck and
   roofline fraction at H100 constants.  No kernel launches; at most 120
   s.

Phases 4, 6, 7 and 9-24 each zero their kernel's launch count (phases
19-24: every kernel's) just before their main path and read it just
after; the fused kernel's entry of the per-kernel JSON line carries each
path's launches, shapes and times under ``paths`` (``lm_generate``,
``lm_train``, ``lm_mesh``, ``lm_mesh_families``, ``lm_mesh_optim`` and
``lm_dryrun`` with 0 launches, every kernel's count beside them),
after a ``timing`` line with each phase's seconds.  Then
the nvidia-smi name/power-limit line, and last
``{"ok": true, "device": {...}}``.  Imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import Counter
from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16/fp16 tensor cores, dense
SERVE_NET = "hailfinder_scale"
# 16 queries per evidence pattern, as one engine group
SERVE_QUERIES, SERVE_PATTERNS = 64, 4
# depth cut so the script stays near its earlier run time with the MRF and
# Ising phases added: a 2048-sample budget and 32 burn-in sweeps (engine
# defaults 4096 and 64; 6 rounds a group instead of 12; a smaller budget
# gives no fewer: the engine keeps at least 4 sampling rounds)
SERVE_BUDGET, SERVE_BURN_IN = 2048, 32
KERNEL_SHAPES = ((7, 3), (300, 5), (4096, 16), (20000, 5), (65536, 2))
# lane-offset cases: blocks of one (20000, 5) launch run as lane shards,
# and the whole launch at a lane0 whose counters pass 2**32
LANE0_SHAPE = (20000, 5)
LANE0_BLOCKS = ((0, 7000), (7000, 13000), (13000, 20000))
LANE0_FAR = 1 << 40
# row-map cases: 160 chains of a colour of 125 nodes, one launch; the
# contiguous map, and 37 scattered columns from chain 0, from chain 23 and
# from a chain whose counters pass 2**32
ROW_MAP = dict(chains=160, nodes=125, cols=37, lane0=(0, 23, 1 << 36))
# benchmarks/bench_ky_vs_cdf.py: 65536 rows, n in {4, 16, 64}, alpha 0.3
KY_SHAPES = ((65536, 4), (65536, 16), (65536, 64))
KY_RAGGED = (133, 7)
# benchmarks/bench_interp.py's tile, and ragged shapes of tests/test_kernels.py
IU_SHAPE = (4096, 1024)
IU_RAGGED = ((37, 64), (1, 1000))
# phi4-mini's attention (src/repro/configs/phi4_mini.py: n_heads 24, n_kv 8,
# d_head 128; dtype bfloat16 from configs/base.py), one sequence of 4096
PHI4_ATTN = dict(B=1, S=4096, H=24, KV=8, dh=128)
# tests/test_kernels.py's flash shapes: (bh, s, dh, causal, block), run in
# float32 (the JAX tests' type) and in bfloat16 and float16
FLASH_F32_SHAPES = ((4, 128, 64, True, 64), (2, 256, 128, True, 128),
                    (2, 256, 64, False, 64), (8, 64, 32, True, 32),
                    (1, 512, 64, True, 128))
# the JAX tests' tolerances (tests/test_kernels.py): (atol, rtol); they have
# no float16 case, so float16 (3 more mantissa bits) is held to bfloat16's
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 3e-2),
             "float16": (3e-2, 3e-2)}
# The JAX tests' bf16 atol was set at S <= 512.  At S 4096 with unit-variance
# scores, row n's outputs are about sqrt(e / n) in size (0.026 at the last
# row), so that atol would pass a key tile skipped on long rows only.  Every
# bf16 and fp16 case is also held per row: max |diff| along dh within this
# share of max |want|.  One ulp of the row's largest output is up to 2^-7 of
# it in bf16 and 2^-10 in fp16 (measured about 0.0079 and 0.00098).  The
# fp16 limit allows two fp16 ulps and sits below the 0.0038 that a kernel
# rounding P or its output at bf16's precision reads (PERF.md has the
# measured errors and planted faults).
FLASH_FULL_BF16_ROW_TOL = 2e-2
FLASH_FULL_FP16_ROW_TOL = 2e-3
FLASH_ROW_TOL = {"bfloat16": FLASH_FULL_BF16_ROW_TOL,
                 "float16": FLASH_FULL_FP16_ROW_TOL}
FLASH_HALF_DTYPES = tuple(FLASH_ROW_TOL)        # the tensor-core route
# integer ops of one 20-round threefry2x32 word: 20 x (add, rotate, xor),
# 5 key injections of 3 adds, the final xor
THREEFRY_OPS = 20 * 3 + 5 * 3 + 1
# The paper's MRF configs (src/repro/configs/aia_paper.py: aia-mrf-penguin
# 500 x 333 L 2, aia-mrf-art 288 x 384 L 16, 16 chains, 1000 sweeps) at
# their published sizes; sampler="cuda" against "torch" on a cut depth, then
# the penguin config's 1000 sweeps on the kernel alone
MRF_IDENTITY_SWEEPS = {"aia-mrf-penguin": 20, "aia-mrf-art": 10}
MIN_PENGUIN_ACCURACY = 0.95
# served grids and tori at full width; depth cut to 4 + 1 burn-in rounds of
# 4 sweeps a group, so that the sampler="torch" passes stay near a minute
SERVE_DEPTH = dict(chains_per_query=8, burn_in=4, sweeps_per_round=4,
                   max_rounds=4, seed=0)
SERVE_MRF = dict(shape=(500, 333), queries=8, patterns=2, budget=256)
SERVE_ISING = dict(side=256, queries=16, patterns=2, budget=256)
# a random sparse spin glass of 65,536 spins (degree buckets up to 16)
SPARSE_RUN = dict(n=65536, chains=8, sweeps=5, burn_in=1)
# tests/test_sparse_compile.py::test_torus_matches_onsager
ONSAGER = dict(side=16, beta=0.6, chains=48, sweeps=150, tol=0.03)
# the streaming-sensor scenario on hailfinder_scale: 4 sensor streams x 4
# drifting slices, at the serve phase's depth, replayed open-loop at the
# reference's default 4x the measured one-at-a-time rate
STREAM = dict(streams=4, slices=4, rate_multiplier=4.0, max_wait_ms=20.0,
              scheduler="deadline")
# a sprinkler stream held to exact enumeration slice by slice
STREAM_ANCHOR = dict(chains_per_query=128, ess_target=2000, max_rounds=256,
                     n_samples=65536, tol=0.03)
# the wire phase: two workers on the one card, 16 hailfinder_scale queries
# over 2 patterns, one MAP query and one scribble-mask MrfQuery at
# mrf_penguin's 500 x 333 in one /v2/batch, at the cut serve depth of the
# MRF and Ising phases (8 chains, 1 burn-in round + 4 rounds of 4 sweeps)
WIRE = dict(workers=2, queries=16, patterns=2, budget=256, slices=3)
# the tile mesh (C3): aia-mrf-penguin at its published 500 x 333 (L 2,
# 16 chains) on a 2 x 2 mesh (333 is odd, so the pad path runs); the
# identities on a cut depth, 200 sweeps timed, the clamped step once
MESH_GIBBS = dict(rows=2, cols=2, identity_sweeps=10, sweeps=200,
                  clamped_sweeps=5)
# lane sharding over a 4-way batch mesh: the serve phase's traffic, one
# MrfQuery at 500 x 333 and one IsingQuery at side 256 (the cut serve
# depth), and tests/test_distributed.py's lane-padding case (6 chains a
# query on 4 shards, within 0.05 of exact)
SHARD_WAYS = 4
SHARDED_PAD = dict(chains_per_query=6, burn_in=64, max_rounds=48, seed=7,
                   n_samples=16384, tol=0.05)
# The serve mesh's "model" axis: a 2 x 2 serve mesh over mesh_devices(4).
# ising_torus at side 1024 (1,048,576 spins, the reference's
# SERVE_SITE_SHARD_ELEMS exactly: site blocks of 524,288), 4 IsingQuery
# over 2 clamp patterns, 2 chains a query; random_sparse_ising(2**20), 2
# queries; random_bayesnet(64, max_parents=8, max_card=6) at seed 4 (a
# log-CPT bank of 5,668,276 elements, past SERVE_CPT_SHARD_ELEMS =
# 4,194,304 and even: two bank blocks) and at seed 7 (4,571,943, odd: kept
# whole), 8 and 4 queries at the serve phases' cut depth.  The factor
# graphs' depth is cut to 1 burn-in and 4 rounds of 1 sweep, so that the
# sampler="torch" passes over 4,194,304 rows a sweep stay near 20 s.
MODEL_AXIS = dict(shape=(2, 2), torus_side=1024, glass_n=1 << 20,
                  torus_queries=4, torus_patterns=2, glass_queries=2,
                  bn=dict(n_nodes=64, max_parents=8, max_card=6),
                  bn_split_seed=4, bn_whole_seed=7, bn_queries=(8, 4),
                  bn_patterns=2, seconds=180)
MODEL_AXIS_DEPTH = dict(chains_per_query=2, burn_in=1, sweeps_per_round=1,
                        max_rounds=4, seed=0)
# Metropolis at full size on the card (penguin 500 x 333, 16 chains; the
# 65,536-spin sparse glass, 8 chains), and the card against the CPU at a
# reduced size, bit for bit
METROPOLIS = dict(sweeps=100, min_accuracy=0.9, fg_chains=8, fg_sweeps=5,
                  small_shape=(50, 34), small_chains=2, small_sweeps=5,
                  small_spins=4096)


# The LM serving path (python -m repro_torch.launch.serve --arch ...) at full
# width with random weights: phi4-mini-3.8b (src/repro/configs/phi4_mini.py:
# 32 layers, d_model 3072, 24 heads on 8 kv heads, d_head 128, d_ff 8192,
# vocab 200,064, tied embeddings; bf16 compute, float32 parameters) and
# mamba2-130m (24 SSD layers, d_model 768, vocab 50,280), at the launcher's
# defaults: batch 4, prompt 16, 32 new tokens; a second ky run at a
# temperature of the first step's logit standard deviation (untrained
# logits are nearly one-hot, so at temperature 1 the KY walks take their
# zero-bit bypass)
LM_FULL = ("phi4-mini-3.8b", "mamba2-130m")
LM_RUN = dict(batch=4, prompt_len=16, max_new=32)
LM_SAMPLERS = ("ky", "categorical", "greedy")
# every family at smoke size in float32, the card against the CPU in one
# process (one arch a family; "encdec" is seamless under the text family's
# name): logits within LM_TOL of the largest (tests/test_torch_models.py's
# tolerance against the reference), greedy tokens equal, the KY stages
# bitwise on the same integer weights
LM_FAMILIES = (("dense", "phi4-mini-3.8b", {}), ("moe", "grok-1-314b", {}),
               ("ssm", "mamba2-130m", {}), ("hybrid", "hymba-1.5b", {}),
               ("encdec", "seamless-m4t-medium", {"family": "encdec"}),
               ("vlm", "pixtral-12b", {}),
               ("audio", "seamless-m4t-medium", {}))
LM_TOL = 1e-5
LM_SMOKE = dict(batch=2, prompt_len=4, max_new=8)

# The training path (python -m repro_torch.launch.train) at full width with
# random weights: phi4-mini-3.8b with the config's own settings (bf16
# compute, float32 parameters, AdamW with float32 moments, microbatch 2,
# remat "full") at the launcher's defaults, batch 8 x 128 tokens, 4 steps of
# TokenDataset; its state is 16 bytes a parameter (4 parameter + 4 gradient
# + 8 moments); then mamba2-130m's config (microbatch 8), 4 steps, and a
# checkpoint round trip of its state on the card
LM_TRAIN_FULL = "phi4-mini-3.8b"
LM_TRAIN_SSM = "mamba2-130m"
LM_TRAIN_RUN = dict(batch=8, seq_len=128, steps=4)
LM_TRAIN_STATE_BYTES = 16
# every family at smoke size, the card against the CPU on the same weights
# and batch (16 tokens, q_block 8): loss within LM_TRAIN_LOSS_RTOL relative
# and each gradient leaf within LM_TRAIN_GRAD_TOL of its largest |g| (a bf16
# leaf also one bf16 step, 2**-7, of the element), tests/test_torch_models.py's
# tolerances against the reference; one train step for each optimizer kind;
# microbatch 2 against the full batch (tests/test_training.py's 5e-5)
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GRAD_TOL = 1e-5, 1e-4
LM_TRAIN_OPT_ARCHS = (("adamw", "phi4-mini-3.8b"),
                      ("adamw_bf16", "qwen1.5-32b"),
                      ("adafactor", "grok-1-314b"))
LM_TRAIN_MB_TOL = 5e-5

# The training path on a ("data", "model") mesh (launch/train.py --mesh 2x2):
# phi4-mini-3.8b at full width with the config's own settings, on a 2 x 2
# mesh over mesh_devices(4) (cuda:0..3 on a 4-card host, else the card
# four times), batch 8 x 128, 4 steps; then the identities: the 2 x 2 step
# against the 1 x 1 step at full width cut to 2 layers, in float32 (loss
# within 1e-5 relative, each gradient leaf within 1e-4 of its largest |g|,
# parameters after one AdamW step within 5e-4: tests/test_distributed.py's
# and the card-against-CPU checks' tolerances) and in the config's bf16
# (LM_MESH_BF16: tensor-parallel partial sums are added in bf16, one more
# rounding of 2**-8 an add; a near-zero gradient of the other sign moves
# its element by 2 lr); the small cases (granite smoke on 4 x 2, every
# family's smoke on 4 x 1, the builders' train, prefill and decode cells
# on 2 x 2); checkpoints across meshes
LM_MESH = dict(shape=(2, 2), steps=4, ident_layers=2)
# the dry run of lm_mesh's step: its bytes between mesh positions within
# this relative distance of the counted ones; the phase's time limit
LM_DRYRUN = dict(bytes_rtol=1e-4, seconds=120)
LM_MESH_TOL = dict(loss_rtol=1e-5, grad_tol=1e-4, param_tol=5e-4)
LM_MESH_BF16 = dict(loss_rtol=1e-2, grad_tol=5e-2, param_tol=2 * 2.1 * 3e-4)
LM_MESH_FAMILIES = (("dense", "phi4-mini-3.8b", {}),
                    ("vlm", "pixtral-12b", {}),
                    ("moe", "llama4-scout-17b-a16e", {}),
                    ("ssm", "mamba2-130m", {}), ("hybrid", "hymba-1.5b", {}),
                    ("encdec", "seamless-m4t-medium", {"family": "encdec"}),
                    ("audio", "seamless-m4t-medium", {}),
                    ("moe_adafactor", "grok-1-314b", {}))
# the small cases on a "model" axis wider than one: the MoE with its
# experts over "model" (llama4 smoke's 4, grok-1 smoke's 2 on 2 x 2) and
# with its expert ffn over "model" (grok-1 smoke's 2 experts on 1 x 4),
# and the hybrid (attention heads, MLP and SSM projections), a train step
# each against one device
LM_MESH_TP_CASES = (("moe", "llama4-scout-17b-a16e", (2, 2)),
                    ("moe_adafactor", "grok-1-314b", (2, 2)),
                    ("hybrid", "hymba-1.5b", (2, 2)),
                    ("moe_ffn", "grok-1-314b", (1, 4)))

# The MoE, SSM and hybrid families on a 2 x 2 ("data", "model") mesh over
# mesh_devices(4) at full width (lm_mesh_families): hymba-1.5b
# (src/repro/configs/hymba_1_5b.py: 32 layers, d_model 1600, 25 heads on 5
# kv heads, d_ff 5504, 50 SSM heads of 64, vocab 32,001; 1.64 B
# parameters) trained with its config's settings (AdamW, float32 state,
# remat "full", microbatch 2) at lm_train's batch 8 x 128, 1 warm-up and 2
# timed steps on 1 x 1 and on 2 x 2 (16 B a parameter, 26.3 GB: no depth
# cut), then served on 2 x 2 (prefill 4 x 512, 32 greedy decode steps);
# llama4-scout-17b-a16e (48 layers, d_model 5120, 40 heads on 8, 16
# experts of ffn 8192, vocab 202,048) served on 1 x 1 and 2 x 2 with its
# depth cut to 4 layers: 4 x 2.08 B + 2.07 B float32 parameters (41.5 GB)
# and the 1 x 1 run's kept bf16 casts (20.7 GB) fill most of the card's 80
# GB, and a fifth layer would leave too little for the run; mamba2-130m at
# full width and depth, a train step and the same serving on 1 x 1 and 2 x
# 2; identities at 2 layers
LM_FAMILIES_MESH = dict(shape=(2, 2), hybrid="hymba-1.5b",
                        moe="llama4-scout-17b-a16e", moe_layers=4,
                        ssm="mamba2-130m", timed_steps=2, serve_batch=4,
                        prompt_len=512, decode_steps=32, ident_layers=2,
                        ident_decode_steps=8)
# llama4 at 2 layers in float32 compute, 2 x 2 against 1 x 1: prefill and
# first-step logits within this share of the 1 x 1 run's largest |logit|,
# the greedy tokens equal over 8 steps; mamba2 in its config's bf16: the
# train step's loss within LM_MESH_BF16's 1e-2 relative, prefill and
# first-step logits within LM_SSM_MESH_LOGIT_BF16 of the largest |logit|
# (the row-parallel out_proj's partial sums round in bf16)
LM_SERVE_MESH_TOL = 1e-4
LM_SSM_MESH_LOGIT_BF16 = 5e-2
# the 2 x 2 decode ms a step of the same runs before the SSM state was
# updated where cache_specs keep it (it went home and back every layer
# and token): NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 5)
LM_FAMILIES_DECODE_MS_BEFORE = {"hymba-1.5b": 356.2, "mamba2-130m": 99.0}

# The training step's two mesh behaviours of phase lm_mesh_optim, over
# mesh_devices(4): phi4-mini-3.8b at full width on 2 x 2 with remat "dots"
# (its config's settings otherwise: AdamW, microbatch 2; lm_train's batch
# 8 x 128; 1 warm-up and 2 timed steps), bitwise with "full" at
# ident_layers in bf16; grok-1-314b (src/repro/configs/grok1_314b.py: 64
# layers, d_model 6144, 48 heads on 8, 8 experts of ffn 32,768, top-2,
# vocab 131,072, softcap 30, Adafactor, bf16 parameters and accumulation)
# at full width cut to moe_layers of its 64 (4.92 B parameters: one
# layer's two expert stacks are 3.2 B; a whole-leaf Adafactor update
# holds several float32 copies of such a stack, 6.4 GB each, so one layer
# fills most of the card on 1 x 1) and its microbatch 16 cut to
# moe_microbatch (a batch of 8 has no rows for 16 microbatches, and with
# 2 the microbatch mean's float32 copy of every gradient, 19.7 GB, would
# not fit beside the whole-leaf update on 1 x 1), 1 x 1 and 2 x 2 from
# the same weights, moe_steps after a first step; after the first step
# the loss and grad norm, and the update alone on the same gradients,
# 2 x 2 against 1 x 1 within LM_MESH_BF16 (the whole step's gradients
# and parameters are reported against it: the router's top-2 in bf16
# flips where the layouts round its input differently).  The phase's
# time limit.
LM_MESH_OPTIM = dict(shape=(2, 2), warmup=1, timed_steps=2, ident_layers=2,
                     moe="grok-1-314b", moe_layers=1, moe_microbatch=1,
                     moe_steps=1, seconds=150)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def setup_path() -> None:
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit(f"chip_smoke.py: no src/repro_torch beside {root}")
    sys.path.insert(0, src)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_bound_ms(b: int, L: int, words_made: int, bits_total: int,
                   lut_nodes: int, map_cols: int = 0) -> tuple[float, str]:
    """Least time the card could take for one fused launch, and what
    bounds it (see :func:`roofline`).  Bytes: each input the function
    needs read once — the L log-weights and the card of every lane, the
    LUT once and a row map's ``map_cols`` int64 columns once — and the 13
    output bytes of every lane written once (the kernel makes its bit
    words, so none are read).  Ops: ~10 float32 per label for the weight
    tail, ~4 per label per DDG level walked (this launch's bits), and one
    threefry per word the cursors reached (``words_made``, from this
    launch's ``bits_used``)."""
    nbytes = b * (4 * L + 4 + 13) + 4 * lut_nodes + 8 * map_cols
    ops = b * L * 10 + bits_total * L * 4 + words_made * THREEFRY_OPS
    return roofline(nbytes, ops, FP32_OPS_PER_S)


def roofline(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of the bytes time at the
    card's memory rate and the operations time at ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def grid_bound_ms(B: int, H: int, W: int, L: int, kept: int,
                  words_made: int, bits_total: int,
                  lut_nodes: int) -> tuple[float, str]:
    """Least time the card could take for one grid colour update
    (``fused_mrf_halfstep``), and what bounds it.  Bytes: the int32
    labels read once, the (H, W, L) unary, the (L, L) table and the LUT
    once, and the ``kept`` sites' labels written once.  Ops: 5 adds a
    label for the energies and ~10 for the weight tail at each kept site,
    ~4 per label per DDG level walked, one threefry per word reached."""
    nbytes = 4 * B * H * W + 4 * H * W * L + 4 * L * L + 4 * kept \
        + 4 * lut_nodes
    ops = kept * L * 15 + bits_total * L * 4 + words_made * THREEFRY_OPS
    return roofline(nbytes, ops, FP32_OPS_PER_S)


def plan_bound_ms(B: int, n: int, N: int, rec_words: int, bank_n: int,
                  L: int, words_made: int, bits_total: int,
                  lut_nodes: int) -> tuple[float, str]:
    """Least time the card could take for one Bayes-net colour update on
    the plan source (``fused_bn_launcher``), and what bounds it.  Bytes:
    the (B, n) int32 states, the colour's records, the bank and the LUT
    read once, the B * N new states written once.  Ops: ~10 float32 a
    label for the weight tail, ~4 per label per DDG level walked, one
    threefry per word reached (the gather's adds are fewer than the
    tail's)."""
    nbytes = 4 * (B * n + N * rec_words + bank_n + B * N + lut_nodes)
    ops = B * N * L * 10 + bits_total * L * 4 + words_made * THREEFRY_OPS
    return roofline(nbytes, ops, FP32_OPS_PER_S)


def kernel_inputs(b: int, L: int, seed: int, device):
    import torch

    from repro_torch.core import rng

    r = np.random.default_rng(seed)
    p = r.dirichlet(np.ones(L), size=b)
    logw = torch.tensor(np.log(np.clip(p, 1e-7, None)), dtype=torch.float32,
                        device=device)
    card = torch.tensor(r.integers(1, L + 1, size=b), dtype=torch.int32,
                        device=device)
    return rng.PRNGKey(seed), logw, card


def result_err(got, want) -> tuple[bool, int]:
    """(all four KYResult fields equal, largest absolute difference)."""
    import torch

    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want)), err


def phase_kernel_vs_plain(device) -> dict:
    """The wrapper against its plain version, key in hand: every listed
    shape, per-lane cards, k in {14, 23}, IU and exp."""
    import torch

    from repro_torch.kernels import fused_sweep as fs

    cases = []
    for b, L in KERNEL_SHAPES:
        key, logw, card = kernel_inputs(b, L, b + L, device)
        for k in (14, 23):
            for use_iu in (True, False):
                got = fs.fused_gibbs_sample(key, logw, card, k=k,
                                            use_iu=use_iu)
                want = fs.fused_gibbs_sample_ref(key, logw, card, k=k,
                                                 use_iu=use_iu)
                torch.cuda.synchronize()
                equal, err = result_err(got, want)
                cases.append(dict(b=b, L=L, k=k, use_iu=use_iu, equal=equal,
                                  max_abs_err=err, ok_all=bool(got.ok.all())))
    # lane shards: rows [a, a + n) launched with lane0=a equal those rows
    # of the unsharded launch (and the plain version with the same
    # lane0); lane0 past 2**32 / W runs the 64-bit counters
    b, L = LANE0_SHAPE
    key, logw, card = kernel_inputs(b, L, 17, device)
    full = fs.fused_gibbs_sample(key, logw, card, k=14)
    cuts = [(lo, hi, lo) for lo, hi in LANE0_BLOCKS] + [(0, b, LANE0_FAR)]
    for lo, hi, lane0 in cuts:
        got = fs.fused_gibbs_sample(key, logw[lo:hi], card[lo:hi], k=14,
                                    lane0=lane0)
        want = fs.fused_gibbs_sample_ref(key, logw[lo:hi], card[lo:hi],
                                         k=14, lane0=lane0)
        torch.cuda.synchronize()
        eq_plain, err = result_err(got, want)
        eq_rows = (lane0 != lo   # the far case has no unsharded twin
                   or result_err(got, [f[lo:hi] for f in full])[0])
        cases.append(dict(b=hi - lo, L=L, k=14, use_iu=True, lane0=lane0,
                          equal=eq_plain and eq_rows, max_abs_err=err,
                          ok_all=bool(got.ok.all())))
    # row maps: the contiguous map (N, arange(N)) gives the unmapped
    # launch's rows; a scattered map gives the rows it names of the whole
    # launch and the plain version's fields, also where the counters pass
    # 2**32 (the far case has no whole launch to name)
    chains, nodes = ROW_MAP["chains"], ROW_MAP["nodes"]
    key, logw, card = kernel_inputs(chains * nodes, L, 19, device)
    full = fs.fused_gibbs_sample(key, logw, card, k=14)
    scattered = torch.tensor(sorted(np.random.default_rng(0).choice(
        nodes, ROW_MAP["cols"], replace=False)), device=device)
    for lane0, colpos in [(0, torch.arange(nodes, device=device))] + [
            (lane0, scattered) for lane0 in ROW_MAP["lane0"]]:
        first = lane0 if lane0 < chains else 0     # the far case: chain 0
        named = ((first + torch.arange(chains - first, device=device)[:, None])
                 * nodes + colpos).reshape(-1)
        got = fs.fused_gibbs_sample(key, logw[named], card[named], k=14,
                                    lane0=lane0, row_map=(nodes, colpos))
        want = fs.fused_gibbs_sample_ref(key, logw[named], card[named],
                                         k=14, lane0=lane0,
                                         row_map=(nodes, colpos))
        torch.cuda.synchronize()
        eq_plain, err = result_err(got, want)
        eq_rows = (lane0 >= chains
                   or result_err(got, [f[named] for f in full])[0])
        cases.append(dict(b=len(named), L=L, k=14, use_iu=True, lane0=lane0,
                          row_map=[nodes, colpos.numel()],
                          equal=eq_plain and eq_rows, max_abs_err=err,
                          ok_all=bool(got.ok.all())))
    bad = [c for c in cases if not c["equal"]]
    emit({"phase": "kernel_vs_plain", "cases": len(cases),
          "lane0_cases": sum("lane0" in c for c in cases),
          "row_map_cases": sum("row_map" in c for c in cases),
          "all_equal": not bad, "failures": bad})
    if bad:
        raise AssertionError(f"fused kernel != plain version: {bad}")
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "cases": len(cases)}


class GridCall(NamedTuple):
    """A recorded grid colour update (``fused_mrf_halfstep``): its key,
    the labels it started from, its fields and parity, its other keywords
    (no accumulator), the labels it wrote and the stats it added."""
    key: object
    labels: object
    unary: object
    pairwise: object
    parity: int
    kw: dict
    out: object
    stats: object


class PlanCall(NamedTuple):
    """A recorded Bayes-net colour update on the plan source
    (``fused_bn_launcher``): its key, the states it started from, the
    bank and the colour's record, its other keywords (no accumulator),
    the states it wrote and the stats it added."""
    key: object
    states: object
    bank: object
    record: object
    kw: dict
    out: object
    stats: object


def call_shape(call) -> tuple[int, int]:
    """A recorded call's ``(b, L)``: the lanes a gathered launch walks, a
    grid's B·H·W sites or a Bayes-net colour's B·N lanes, as the launch
    counter keys them."""
    if isinstance(call, GridCall):
        return call.labels.numel(), call.unary.shape[-1]
    if isinstance(call, PlanCall):
        return call.states.shape[0] * call.record.shape[0], call.kw["L"]
    return tuple(call[1].shape)


@contextlib.contextmanager
def record_main_path(keep_all: bool = True):
    """Zero the launch counts just before a main path and read them just
    after.  Meanwhile keep the fused calls the colour updates make (inputs
    and result, by reference: no device work is added; a grid colour
    update, which writes its labels in place, is kept as copies of its
    labels before and after and of the stats it added) — every call, or
    with ``keep_all=False`` the first of each ``(b, L)`` only, for paths
    whose calls would not fit in memory together — the launches of each
    ``GroupRun.step`` (one engine round), and the calls of
    ``rng.random_bit_words`` and ``rng.LaneWords.column`` (the kernel
    makes its own words, so the CUDA route should make none).  The fused
    sampler is read by name in the BN compile chain, the sparse colour
    update and the mesh step's tiles, the grid launcher in the MRF
    half-step and the plan launcher in the BN compile chain (a Bayes-net
    colour update, kept as the grid's are); all five are recorded."""
    from repro_torch.core import rng
    from repro_torch.kernels import fused_sweep as fs
    from repro_torch.pgm import compile as compile_mod
    from repro_torch.pgm import gibbs as gibbs_mod
    from repro_torch.pgm import mesh_gibbs as mesh_mod
    from repro_torch.pgm import sparse_compile as sparse_mod
    from repro_torch.serve.engine import GroupRun

    mods = (compile_mod, sparse_mod, mesh_mod)
    fused, step = fs.fused_gibbs_sample, GroupRun.step
    launcher = gibbs_mod.fused_mrf_launcher
    bn_launcher = compile_mod.fused_bn_launcher
    bit_words, column = rng.random_bit_words, rng.LaneWords.column
    rec = {"calls": [], "per_round": Counter(), "word_calls": 0,
           "row_maps": Counter()}
    seen = set()

    def counting_bit_words(*args, **kw):
        rec["word_calls"] += 1
        return bit_words(*args, **kw)

    def counting_column(*args, **kw):
        rec["word_calls"] += 1
        return column(*args, **kw)

    def recording_fused(key, logw, card, **kw):
        res = fused(key, logw, card, **kw)
        if kw.get("row_map") is not None:   # a site block's launch
            stride, colpos = kw["row_map"]
            rec["row_maps"][kw["lane0"], stride, colpos.data_ptr()] += 1
        if keep_all or tuple(logw.shape) not in seen:
            seen.add(tuple(logw.shape))
            rec["calls"].append((key, logw, card, kw, res))
        return res

    def recording_launcher(labels, unary, pairwise, **kw):
        launch = launcher(labels, unary, pairwise, **kw)
        shape = (labels.numel(), unary.shape[-1])
        acc = kw["acc"]

        def recording_launch(key, parity):
            keep = keep_all or shape not in seen
            if keep:
                before, acc0 = labels.clone(), acc.clone()
            launch(key, parity)
            if keep:
                seen.add(shape)
                rec["calls"].append(GridCall(
                    key, before, unary, pairwise, parity,
                    {k: v for k, v in kw.items() if k != "acc"},
                    labels.clone(), acc - acc0))
        return recording_launch

    def recording_bn_launcher(states, bank, records, **kw):
        launch = bn_launcher(states, bank, records, **kw)
        acc = kw["acc"]

        def recording_launch(key, color):
            shape = (states.shape[0] * records[color].shape[0], kw["L"])
            keep = keep_all or shape not in seen
            if keep:
                before, acc0 = states.clone(), acc.clone()
            launch(key, color)
            if keep:
                seen.add(shape)
                rec["calls"].append(PlanCall(
                    key, before, bank, records[color],
                    {k: v for k, v in kw.items() if k != "acc"},
                    states.clone(), acc - acc0))
        return recording_launch

    def recording_step(self):
        n0 = fs.fused_gibbs_sample.launches
        out = step(self)
        rec["per_round"][fs.fused_gibbs_sample.launches - n0] += 1
        return out

    for m in mods:
        m.fused_gibbs_sample = recording_fused
    gibbs_mod.fused_mrf_launcher = recording_launcher
    compile_mod.fused_bn_launcher = recording_bn_launcher
    GroupRun.step = recording_step
    rng.random_bit_words = counting_bit_words
    rng.LaneWords.column = counting_column
    fs.fused_gibbs_sample.launches = 0
    fs.fused_gibbs_sample.shapes.clear()
    try:
        yield rec
    finally:
        rec["launches"] = fs.fused_gibbs_sample.launches
        rec["shapes"] = Counter(fs.fused_gibbs_sample.shapes)
        for m in mods:
            m.fused_gibbs_sample = fused
        gibbs_mod.fused_mrf_launcher = launcher
        compile_mod.fused_bn_launcher = bn_launcher
        GroupRun.step = step
        rng.random_bit_words = bit_words
        rng.LaneWords.column = column


def check_recorded(rec, path: str) -> None:
    """A main path launched the kernel, made no bit words on the host,
    and every launch went through the recorded wrapper."""
    if rec["launches"] <= 0:
        raise AssertionError(f"{path} never launched the fused kernel")
    if rec["word_calls"]:
        raise AssertionError(f"{path}: the CUDA route made bit words on the "
                             f"host {rec['word_calls']} times")
    if rec["launches"] != sum(rec["shapes"].values()):
        raise AssertionError(f"{path}: {rec['launches']} launches, shapes "
                             f"{dict(rec['shapes'])}")


def main_path_bound(rec) -> tuple[float, str]:
    """Mean bound per launch over every launch of the main path, each
    from its own shape and the bits its lanes used; a recorded call
    stands for the launches of its shape that were not kept."""
    import torch

    calls = rec["calls"]
    per_call = torch.stack([torch.stack(
        grid_words_bits(c) if isinstance(c, GridCall)
        else plan_words_bits(c) if isinstance(c, PlanCall) else [
            ((c[-1].bits_used.to(torch.int64) + 31) // 32).sum(),
            c[-1].bits_used.to(torch.int64).sum()]) for c in calls])
    per_call = per_call.cpu().tolist()
    kept = Counter(call_shape(c) for c in calls)
    total = weight = 0.0
    bys = Counter()
    for call, (words_made, bits) in zip(calls, per_call):
        b, L = call_shape(call)
        w = rec["shapes"][(b, L)] / kept[(b, L)]
        kw = call.kw if isinstance(call, (GridCall, PlanCall)) else call[3]
        lut = kw["table"].table.numel() if kw.get("use_iu", True) else 0
        if isinstance(call, PlanCall):
            bound, by = plan_bound_ms(
                *call.states.shape, *call.record.shape, call.bank.numel(),
                L, words_made, bits, lut)
        elif isinstance(call, GridCall):
            sites = grid_kept(call).expand(call.labels.shape)
            bound, by = grid_bound_ms(*call.labels.shape, L,
                                      int(sites.sum()), words_made, bits,
                                      lut)
        else:
            cols = (kw["row_map"][1].numel()
                    if kw.get("row_map") is not None else 0)
            bound, by = fused_bound_ms(b, L, words_made, bits, lut, cols)
        total += bound * w
        weight += w
        bys[by] += w
    return total / weight, bys.most_common(1)[0][0]


def grid_kept(call: GridCall):
    """(B or 1, H, W) bool: the sites a recorded grid call resampled."""
    import torch

    _, H, W = call.labels.shape
    dev = call.labels.device
    ar_h, ar_w = torch.arange(H, device=dev), torch.arange(W, device=dev)
    keep = (((ar_h[:, None] + ar_w[None, :]) % 2) == call.parity)[None]
    clamp = call.kw.get("clamp")
    return keep if clamp is None else keep & ~clamp.reshape(-1, H, W)


def grid_plain(call: GridCall):
    """The plain twin on a recorded grid call's inputs: (labels written,
    stats added, the draw of every site)."""
    import torch

    from repro_torch.kernels import fused_sweep as fs

    lab = call.labels.clone()
    acc = torch.zeros(2, dtype=torch.int64, device=lab.device)
    res = fs.fused_mrf_halfstep_ref(call.key, lab, call.unary, call.pairwise,
                                    call.parity, acc=acc, **call.kw)
    return lab, acc, res


def grid_words_bits(call: GridCall) -> list:
    """[words the kept sites' cursors reached, bits they read] of a
    recorded grid call, from the plain twin's draw (the kernel returns
    only the sums), as 0-d int64 tensors."""
    import torch

    _, acc, res = grid_plain(call)
    bits = torch.where(grid_kept(call),
                       res.bits_used.reshape(call.labels.shape).long(), 0)
    return [((bits + 31) // 32).sum(), acc[0]]


def grid_kernel_row(call: GridCall, n: int) -> tuple[dict, dict | None]:
    """:func:`phase_main_path_kernel`'s row for a grid shape: the kernel
    launched again from the recorded labels must write the recorded
    labels and stats and the plain twin's; then timed as the gathered
    shapes are (the timed launches update a copy in place, half-step
    after half-step)."""
    import torch

    from repro_torch.core import rng
    from repro_torch.kernels import fused_sweep as fs

    dev = call.labels.device
    b, L = call_shape(call)
    lab = call.labels.clone()
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    fs.fused_mrf_halfstep(call.key, lab, call.unary, call.pairwise,
                          call.parity, acc=acc, **call.kw)
    p_lab, p_acc, _ = grid_plain(call)
    eq_rec = torch.equal(lab, call.out) and torch.equal(acc, call.stats)
    eq_plain = torch.equal(lab, p_lab) and torch.equal(acc, p_acc)
    err = max(int((lab.long() - x.long()).abs().max())
              for x in (call.out, p_lab))
    bad = None if eq_rec and eq_plain else dict(
        b=b, L=L, grid=True, equals_recorded=eq_rec, equals_plain=eq_plain)
    x = call.labels.clone()

    def launch():
        fs.fused_mrf_halfstep(call.key, x, call.unary, call.pairwise,
                              call.parity, acc=acc, **call.kw)

    with torch.cuda.device(dev):
        row = dict(
            n=n, b=b, L=L, max_abs_err=err,
            ms=cold_device_ms(launch, 3, dev, calls=100),
            call_ms=time_ms(launch, 200),
            plain_ms=time_ms(lambda: grid_plain(call), 5, warmup=1),
            words_ms=time_ms(lambda: rng.random_bit_words(
                call.key, (b,), 31 * 32, device=dev,
                lane0=call.kw.get("lane0", 0)), 20))
    return row, bad


def plan_plain(call: PlanCall):
    """The plain twin on a recorded plan call's inputs: (states written,
    stats added, the draw of every lane)."""
    import torch

    from repro_torch.kernels import fused_sweep as fs

    states = call.states.clone()
    acc = torch.zeros(2, dtype=torch.int64, device=states.device)
    res = fs.fused_bn_update_ref(call.key, states, call.record, call.bank,
                                 acc=acc, **call.kw)
    return states, acc, res


def plan_words_bits(call: PlanCall) -> list:
    """[words the lanes' cursors reached, bits they read] of a recorded
    plan call, from the plain twin's draw, as 0-d int64 tensors."""
    _, acc, res = plan_plain(call)
    return [((res.bits_used.long() + 31) // 32).sum(), acc[0]]


def plan_kernel_row(call: PlanCall, n: int) -> tuple[dict, dict | None]:
    """:func:`phase_main_path_kernel`'s row for a Bayes-net colour on the
    plan source: the kernel launched again from the recorded states must
    write the recorded states and stats and the plain twin's; then timed
    as the gathered shapes are (the timed launches update a copy in
    place, colour update after colour update)."""
    import torch

    from repro_torch.core import rng
    from repro_torch.kernels import fused_sweep as fs

    dev = call.states.device
    b, L = call_shape(call)
    states = call.states.clone()
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    fs.fused_bn_launcher(states, call.bank, [call.record], acc=acc,
                         **call.kw)(call.key, 0)
    p_states, p_acc, _ = plan_plain(call)
    eq_rec = torch.equal(states, call.out) and torch.equal(acc, call.stats)
    eq_plain = torch.equal(states, p_states) and torch.equal(acc, p_acc)
    err = max(int((states.long() - x.long()).abs().max())
              for x in (call.out, p_states))
    bad = None if eq_rec and eq_plain else dict(
        b=b, L=L, plan=True, equals_recorded=eq_rec, equals_plain=eq_plain)
    launch = fs.fused_bn_launcher(call.states.clone(), call.bank,
                                  [call.record], acc=acc, **call.kw)
    with torch.cuda.device(dev):
        row = dict(
            n=n, b=b, L=L, max_abs_err=err,
            ms=cold_device_ms(lambda: launch(call.key, 0), 3, dev,
                              calls=100),
            call_ms=time_ms(lambda: launch(call.key, 0), 200),
            plain_ms=time_ms(lambda: plan_plain(call), 5, warmup=1),
            words_ms=time_ms(lambda: rng.random_bit_words(
                call.key, (b,), 31 * 32, device=dev,
                lane0=call.kw.get("lane0", 0) * call.record.shape[0]), 20))
    return row, bad


def phase_main_path_kernel(rec) -> dict:
    """The kernel at the main path's own inputs: for each (b, L) the serve
    passes launched, its first recorded call is launched again through the wrapper and must equal
    both the recorded result and the plain version; then timed.  ``ms``
    is the kernel's device time per launch, 100 launches back to back on
    a held card (:func:`cold_device_ms`:
    CUDA events, not torch.profiler, whose CUDA-only captures have come
    back without a record of the kernel after the serve phase; the gaps
    between launches on the card count),
    ``call_ms`` one launch through the binding as the host sees it back
    to back (CUDA events), ``plain_ms`` the plain version as it runs
    (making the words its walk reads) and ``words_ms`` the whole draw's
    words (which the kernel makes itself), all on the same inputs; each
    averaged over the shapes weighted by their launch counts."""
    import torch

    from repro_torch.core import rng
    from repro_torch.kernels import fused_sweep as fs

    first = {}
    for call in rec["calls"]:
        first.setdefault(call_shape(call), call)
    rows, bad = [], []
    for (b, L), n in rec["shapes"].items():
        if isinstance(first[(b, L)], (GridCall, PlanCall)):
            row_of = (grid_kernel_row if isinstance(first[(b, L)], GridCall)
                      else plan_kernel_row)
            row, fault = row_of(first[(b, L)], n)
            rows.append(row)
            bad += [fault] if fault else []
            continue
        key, logw, card, kw, res = first[(b, L)]
        again = fs.fused_gibbs_sample(key, logw, card, **kw)
        plain = fs.fused_gibbs_sample_ref(key, logw, card, **kw)
        lane_card = fs._lane_card(card, b, logw.device)
        logw_c = logw.contiguous()
        lane0 = kw.get("lane0", 0)     # a lane shard's first global row
        row_map = kw.get("row_map")    # a site block's rows
        opts = dict(k=kw["k"], use_iu=kw.get("use_iu", True),
                    table=kw["table"], mask_value=fs.MASK_NEG)

        def launch():
            return fs._launch(logw_c, lane_card, key, max_attempts=32,
                              block_b=256, lane0=lane0, row_map=row_map,
                              **opts)

        eq_rec, err_rec = result_err(again, res)
        eq_plain, err_plain = result_err(again, plain)
        if not (eq_rec and eq_plain):
            bad.append(dict(b=b, L=L, equals_recorded=eq_rec,
                            equals_plain=eq_plain))
        with torch.cuda.device(logw.device):    # events on the call's card
            rows.append(dict(
                n=n, b=b, L=L, max_abs_err=max(err_rec, err_plain),
                ms=cold_device_ms(launch, 3, logw.device, calls=100),
                call_ms=time_ms(launch, 200),
                plain_ms=time_ms(lambda: fs._plain(
                    logw_c, lane_card, fs._words(key, b, 32, logw.device,
                                                 lane0, row_map),
                    **opts), 5, warmup=1),
                words_ms=time_ms(lambda: rng.random_bit_words(
                    key, (b,), 31 * 32, device=logw.device, lane0=lane0,
                    row_map=row_map), 20)))
    emit({"phase": "kernel_vs_plain_main_path", "shapes": len(rows),
          "all_equal": not bad, "failures": bad})
    if bad:
        raise AssertionError(f"fused kernel at the main path's inputs: {bad}")
    total = sum(r["n"] for r in rows)

    def mean(key):
        return sum(r[key] * r["n"] for r in rows) / total

    bound, by = main_path_bound(rec)
    out = {k: mean(k) for k in ("ms", "call_ms", "plain_ms", "words_ms")}
    return dict(out, bound_ms=bound, bound_by=by,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                shapes=[[r["b"], r["L"], r["n"]] for r in rows])


def same_results(a, b) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.marginals.keys() != y.marginals.keys() or not all(
                np.array_equal(x.marginals[k], y.marginals[k])
                for k in x.marginals):
            return False
        if (x.n_sweeps, x.n_samples, x.bits_per_sample) != (
                y.n_sweeps, y.n_samples, y.bits_per_sample):
            return False
        if dataclasses.astuple(x.diagnostics) != dataclasses.astuple(
                y.diagnostics):
            return False
    return True


def timed_pass(engine, traffic):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.answer_batch(traffic)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def plain_identity(registry, traffic, timed: tuple, warm_key,
                   **kw) -> dict:
    """The plain path (``sampler="torch"``) against the fused kernel's
    timed passes, bit for bit, on every query of ``traffic``: cold on a
    fresh engine of settings ``kw``, then warm from the key the timed
    warm pass started from (``warm_key``), each held against the timed
    cold and warm results ``timed``."""
    from repro_torch.serve.engine import PosteriorEngine

    plain = PosteriorEngine(registry, sampler="torch", **kw)
    got_cold, cold_s = timed_pass(plain, traffic)
    plain._key = warm_key
    got_warm, warm_s = timed_pass(plain, traffic)
    return {"identity_queries": len(traffic),
            "cuda_equals_torch": {
                p: same_results(got, res)
                for p, got, res in (("cold", got_cold, timed[0]),
                                    ("warm", got_warm, timed[1]))},
            "sampler_torch_cold_s": cold_s, "sampler_torch_warm_s": warm_s}


def phase_serve(card_name: str) -> dict:
    import torch

    from repro_torch.pgm import networks
    from repro_torch.serve.cli import synthetic_traffic
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.query import Query

    bn = getattr(networks, SERVE_NET)()
    registry = {SERVE_NET: bn}
    traffic = synthetic_traffic(bn, SERVE_NET, SERVE_QUERIES, SERVE_PATTERNS,
                                np.random.default_rng(0), SERVE_BUDGET)
    engine = PosteriorEngine(registry, burn_in=SERVE_BURN_IN,
                             seed=0)                     # cuda, sampler cuda
    assert engine.device.type == "cuda" and engine.sampler == "cuda"

    with record_main_path() as rec:        # the main path
        cold, cold_s = timed_pass(engine, traffic)
        warm_key = engine._key              # the warm pass's first key
        warm, warm_s = timed_pass(engine, traffic)
    check_recorded(rec, "serve phase")
    if rec["launches"] != len(rec["calls"]):
        raise AssertionError(f"{rec['launches']} launches counted, "
                             f"{len(rec['calls'])} fused calls recorded")
    node_samples = sum(r.n_node_samples for r in warm)
    emit({"phase": "serve", "network": SERVE_NET, "queries": len(traffic),
          "card": card_name, "launches": rec["launches"],
          "launches_per_round": sorted(rec["per_round"].items()),
          "host_word_calls": rec["word_calls"],
          "cold_s": cold_s, "warm_s": warm_s,
          "cold_qps": len(traffic) / cold_s, "warm_qps": len(traffic) / warm_s,
          "cold_msample_s": sum(r.n_node_samples for r in cold) / cold_s / 1e6,
          "warm_msample_s": node_samples / warm_s / 1e6,
          "converged": sum(r.converged for r in warm)})

    # the plain path on the card, every query of the timed passes
    ident = plain_identity(registry, traffic, (cold, warm), warm_key,
                           burn_in=SERVE_BURN_IN, seed=0)
    emit({"phase": "serve_identity", **ident})
    if not all(ident["cuda_equals_torch"].values()):
        raise AssertionError(f"sampler='cuda' results differ from 'torch': "
                             f"{ident}")

    spr = networks.sprinkler()
    eng = PosteriorEngine({"sprinkler": spr}, chains_per_query=128,
                          ess_target=2000, max_rounds=256, seed=0)
    res = eng.answer(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                           n_samples=65536))
    exact = spr.marginals_exact({"wetgrass": 1})[2]
    err = float(np.abs(res.marginal("rain") - exact).max())
    emit({"phase": "sprinkler_exact", "p_rain": res.marginal("rain").tolist(),
          "exact": exact.tolist(), "max_err": err})
    if not err < 0.03:
        raise AssertionError(f"sprinkler posterior off by {err} >= 0.03")
    for r in cold + warm:
        for m in r.marginals.values():
            if not (np.isfinite(m).all() and abs(m.sum() - 1.0) < 1e-9):
                raise AssertionError(f"bad marginal {m}")
    torch.cuda.synchronize()
    return {"traffic": traffic, "record": rec, "cold": cold}


def path_entry(rec, kern: dict) -> dict:
    """A main path's part of the fused kernel's entry: its launches, its
    ``(b, L, launches)`` shapes and the kernel's numbers at its shapes."""
    return dict(launches=rec["launches"],
                shapes=sorted([b, L, n] for (b, L), n in
                              rec["shapes"].items()),
                **{k: kern[k] for k in ("ms", "call_ms", "plain_ms",
                                        "words_ms", "bound_ms", "bound_by",
                                        "max_abs_err")})


def phase_mrf_gibbs(card_name: str) -> dict:
    """The paper's MRF configs through ``run_mcmc``'s MRF branch
    (``launch.run_mcmc.run_mrf``): at the published sizes, a cut depth
    with ``sampler="cuda"`` and ``"torch"`` from the same keys must give
    the same labels, bits and attempts; then aia-mrf-penguin's 1000
    sweeps on the kernel, timed, with exactly 2 launches a sweep, and
    the kernel at each config's shape held to the recorded result and
    the plain version and timed with a cold L2."""
    import torch

    from repro_torch.configs.aia_paper import MCMC_CONFIGS, PENGUIN
    from repro_torch.launch.run_mcmc import run_mrf

    out = {}
    for name, sweeps in MRF_IDENTITY_SWEEPS.items():
        cfg = MCMC_CONFIGS[name]
        with record_main_path(keep_all=False) as rec:   # a main path
            a = run_mrf(cfg, sweeps=sweeps, chains=cfg.n_chains,
                        sampler="cuda")
        check_recorded(rec, f"{name} identity run")
        b = run_mrf(cfg, sweeps=sweeps, chains=cfg.n_chains, sampler="torch")
        same = (torch.equal(a["labels"], b["labels"])
                and (a["bits"], a["attempts"]) == (b["bits"], b["attempts"]))
        emit({"phase": "mrf_identity", "config": name, "card": card_name,
              "shape": list(a["shape"]), "chains": cfg.n_chains,
              "sweeps": sweeps, "launches": rec["launches"],
              "cuda_equals_torch": same, "cuda_s": a["seconds"],
              "torch_s": b["seconds"],
              "bits_per_sample": a["bits"] / a["n_samples"]})
        if not same:
            raise AssertionError(f"{name}: sampler='cuda' != 'torch'")
        if rec["launches"] != 2 * sweeps:
            raise AssertionError(f"{name}: {rec['launches']} launches for "
                                 f"{sweeps} sweeps")
        del a, b
        if name != PENGUIN.name:
            kern = phase_main_path_kernel(rec)
            out[name] = path_entry(rec, kern)
        rec["calls"].clear()
        torch.cuda.empty_cache()

    cfg = PENGUIN
    with record_main_path(keep_all=False) as rec:       # the main path
        run = run_mrf(cfg, sweeps=cfg.n_sweeps, chains=cfg.n_chains,
                      sampler="cuda")
    check_recorded(rec, "mrf_gibbs")
    if rec["launches"] != 2 * cfg.n_sweeps:
        raise AssertionError(f"mrf_gibbs: {rec['launches']} launches for "
                             f"{cfg.n_sweeps} sweeps")
    labels = run["labels"]
    if not bool(((labels >= 0) & (labels < 2)).all()):
        raise AssertionError("mrf_gibbs: labels outside [0, 2)")
    if not run["accuracy"] >= MIN_PENGUIN_ACCURACY:
        raise AssertionError(f"mrf_gibbs: accuracy {run['accuracy']} < "
                             f"{MIN_PENGUIN_ACCURACY}")
    kern = phase_main_path_kernel(rec)
    h, w = run["shape"]
    emit({"phase": "mrf_gibbs", "config": cfg.name, "card": card_name,
          "shape": [h, w], "labels": 2, "chains": cfg.n_chains,
          "sweeps": cfg.n_sweeps, "seconds": run["seconds"],
          "msample_s": run["n_samples"] / run["seconds"] / 1e6,
          "bits_per_sample": run["bits"] / run["n_samples"],
          "accuracy": run["accuracy"], "launches": rec["launches"],
          "fused_shapes": sorted([b, L, n] for (b, L), n in
                                 rec["shapes"].items()),
          "fused_ms": kern["ms"], "fused_bound_ms": kern["bound_ms"],
          "fused_bound_by": kern["bound_by"],
          "host_word_calls": rec["word_calls"]})
    out[cfg.name] = dict(path_entry(rec, kern),
                         msample_s=run["n_samples"] / run["seconds"] / 1e6)
    rec["calls"].clear()
    del run, labels
    torch.cuda.empty_cache()
    return out


def serve_identity(registry, traffic, label: str, card_name: str,
                   depth: dict) -> dict:
    """Cold and warm passes of ``traffic`` with ``sampler="cuda"`` (the
    main path: counts zeroed just before, read just after; first call of
    each shape kept), then ``plain_identity`` on every query, which must
    be equal bit for bit; finite marginals that sum to one."""
    import torch

    from repro_torch.serve.engine import PosteriorEngine

    engine = PosteriorEngine(registry, **depth)          # cuda, sampler cuda
    assert engine.device.type == "cuda" and engine.sampler == "cuda"
    with record_main_path(keep_all=False) as rec:
        cold, cold_s = timed_pass(engine, traffic)
        warm_key = engine._key              # the warm pass's first key
        warm, warm_s = timed_pass(engine, traffic)
    check_recorded(rec, label)
    ident = plain_identity(registry, traffic, (cold, warm), warm_key,
                           **depth)
    same = ident["cuda_equals_torch"]
    samples = sum(r.n_node_samples for r in warm)
    emit({"phase": label, "card": card_name, "queries": len(traffic),
          "launches": rec["launches"],
          "launches_per_round": sorted(rec["per_round"].items()),
          "host_word_calls": rec["word_calls"],
          "cold_s": cold_s, "warm_s": warm_s,
          "cold_qps": len(traffic) / cold_s, "warm_qps": len(traffic) / warm_s,
          "cold_msample_s": sum(r.n_node_samples for r in cold) / cold_s / 1e6,
          "warm_msample_s": samples / warm_s / 1e6,
          "converged": sum(r.converged for r in warm), **ident})
    if not all(same.values()):
        raise AssertionError(f"{label}: sampler='cuda' != 'torch': {same}")
    for r in cold + warm:
        for m in r.marginals.values():
            if not (np.isfinite(m).all() and abs(m.sum() - 1.0) < 1e-9):
                raise AssertionError(f"{label}: bad marginal {m}")
    kern = phase_main_path_kernel(rec)
    rec["calls"].clear()
    torch.cuda.empty_cache()
    return dict(path_entry(rec, kern), warm_qps=len(traffic) / warm_s,
                warm_msample_s=samples / warm_s / 1e6)


def phase_serve_mrf(card_name: str) -> dict:
    """``mrf_penguin`` served at the published 500 x 333: scribble-mask
    traffic (``synthetic_mrf_traffic``), cold and warm, bitwise against
    ``sampler="torch"``."""
    from repro_torch.serve import cli

    registry = cli.build_registry(("mrf_penguin",),
                                  mrf_shape=SERVE_MRF["shape"])
    traffic = cli.synthetic_mrf_traffic(
        registry["mrf_penguin"], "mrf_penguin", SERVE_MRF["queries"],
        SERVE_MRF["patterns"], np.random.default_rng(0), SERVE_MRF["budget"])
    return serve_identity(registry, traffic, "serve_mrf", card_name,
                          SERVE_DEPTH)


def phase_serve_ising(card_name: str) -> dict:
    """``ising_torus`` at side 256 (65,536 spins, coloured by iterated
    MIS): spin-clamp traffic cold and warm, bitwise against
    ``sampler="torch"``; then ``run_fg_gibbs`` on a random sparse spin
    glass with a degree-16 bucket, bitwise against ``"torch"``; and the
    correctness anchor, the torus at β 0.6 started all up, within 0.03
    of Onsager's magnetization."""
    import torch

    from repro_torch.core import rng
    from repro_torch.pgm import coloring, networks
    from repro_torch.pgm import sparse_compile as sc
    from repro_torch.serve import cli

    registry = cli.build_registry(("ising_torus",),
                                  ising_side=SERVE_ISING["side"])
    assert registry["ising_torus"].n_vars > coloring._PARALLEL_THRESHOLD
    traffic = cli.synthetic_ising_traffic(
        registry["ising_torus"], "ising_torus", SERVE_ISING["queries"],
        SERVE_ISING["patterns"], np.random.default_rng(1),
        SERVE_ISING["budget"])
    served = serve_identity(registry, traffic, "serve_ising", card_name,
                            SERVE_DEPTH)

    prog = sc.compile_factor_graph(
        networks.random_sparse_ising(SPARSE_RUN["n"]))
    widths = sorted({b.nbr.shape[1] for p in prog.plans for b in p.buckets})
    if widths[-1] < 16:
        raise AssertionError(f"no degree-16 bucket: widths {widths}")
    kw = {k: SPARSE_RUN[k] for k in ("sweeps", "burn_in")}
    with record_main_path(keep_all=False) as rec:        # a main path
        xc, cc, stc = sc.run_fg_gibbs(
            rng.PRNGKey(3), prog, n_chains=SPARSE_RUN["chains"],
            n_sweeps=kw["sweeps"], burn_in=kw["burn_in"], sampler="cuda")
    check_recorded(rec, "run_fg_gibbs")
    xt, ct, stt = sc.run_fg_gibbs(
        rng.PRNGKey(3), prog, n_chains=SPARSE_RUN["chains"],
        n_sweeps=kw["sweeps"], burn_in=kw["burn_in"], sampler="torch")
    same = (torch.equal(xc, xt) and torch.equal(cc, ct)
            and (int(stc.bits_used), int(stc.attempts))
            == (int(stt.bits_used), int(stt.attempts)))
    rec["calls"].clear()

    o = ONSAGER
    model = networks.ising_torus(o["side"], beta=o["beta"])
    tprog = sc.compile_factor_graph(model)
    x0 = np.ones((o["chains"], model.n), np.int32)       # all up
    x, _, _ = sc.run_fg_gibbs(rng.PRNGKey(2), tprog, n_chains=o["chains"],
                              n_sweeps=o["sweeps"], burn_in=0, x0=x0)
    m = float((2.0 * x.double() - 1.0).mean())
    exact = float((1.0 - np.sinh(2.0 * o["beta"]) ** -4) ** 0.125)
    emit({"phase": "ising_sparse", "card": card_name, "spins":
          SPARSE_RUN["n"], "colors": prog.n_colors, "bucket_widths": widths,
          "launches": rec["launches"], "cuda_equals_torch": same,
          "onsager": {"magnetization": m, "exact": exact,
                      "err": abs(m - exact), "tol": o["tol"]}})
    if not same:
        raise AssertionError("run_fg_gibbs: sampler='cuda' != 'torch'")
    if not abs(m - exact) < o["tol"]:
        raise AssertionError(f"Onsager anchor: magnetization {m}, exact "
                             f"{exact}")
    return served


def check_marginals(results, label: str) -> None:
    for r in results:
        for m in r.marginals.values():
            if not (isinstance(m, np.ndarray) and m.dtype == np.float64
                    and np.isfinite(m).all() and abs(m.sum() - 1.0) < 1e-9):
                raise AssertionError(f"{label}: bad marginal {m!r}")


def phase_serve_queue(card_name: str, traffic, want) -> dict:
    """The serve phase's traffic through the port's ``AdmissionQueue`` on
    the card, admitted with ``submit_many`` and flushed (one group a
    pattern, as ``answer_batch`` forms them): its dispatcher thread
    launches every colour update, and the results must equal the serve
    phase's cold ``answer_batch`` (``want``, itself equal to
    ``sampler="torch"``) bit for bit."""
    import torch

    from repro_torch.pgm import networks
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.queue import AdmissionQueue

    registry = {SERVE_NET: getattr(networks, SERVE_NET)()}
    engine = PosteriorEngine(registry, burn_in=SERVE_BURN_IN, seed=0)
    assert engine.device.type == "cuda" and engine.sampler == "cuda"
    queue = AdmissionQueue(
        engine, max_wait_ms=3_600_000.0,
        max_group_lanes=len(traffic) * engine.chains_per_query)
    with record_main_path(keep_all=False) as rec:      # the main path
        t0 = time.perf_counter()
        try:
            handles = queue.submit_many(traffic)
            queue.flush()
            got = [h.result(timeout=600) for h in handles]
        finally:
            queue.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_recorded(rec, "serve_queue")
    same = same_results(got, want)
    st = queue.stats
    emit({"phase": "serve_queue", "card": card_name, "queries": len(traffic),
          "wall_s": wall, "qps": len(traffic) / wall,
          "dispatch_log": [[n, list(p), k] for n, p, k in st.dispatch_log],
          "groups": st.dispatched_groups, "backfilled": st.backfilled,
          "completed": st.completed, "failed": st.failed,
          "launches": rec["launches"], "host_word_calls": rec["word_calls"],
          "equals_answer_batch": same})
    if not same or st.completed != len(traffic):
        raise AssertionError("serve_queue: queued results differ from the "
                             "cuda answer_batch")
    check_marginals(got, "serve_queue")
    kern = phase_main_path_kernel(rec)
    rec["calls"].clear()
    return dict(path_entry(rec, kern), qps=len(traffic) / wall)


def device_busy_s(prof) -> float:
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6


def phase_serve_stream(card_name: str) -> dict:
    """``cli.measure_stream`` on the streaming-sensor scenario
    (``synthetic_stream_traffic`` of hailfinder_scale, 4 streams x 4
    slices): plan caches warmed off the clock, the one-at-a-time sync
    rate timed, then an open-loop replay at 4x that rate through the
    deadline scheduler (the main path: counts zeroed just before the
    replay, read just after), with the telemetry recorder off.  Every
    slice after a stream's first must warm-start.  The same arrivals are
    replayed twice more, streams reset: with the recorder on (its trace
    and metrics written and parsed, the latency broken into wait, plan
    and service), and under torch.profiler (the card's busy share).
    Then a sprinkler stream through the queue, each slice within 0.03
    of exact."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.pgm import networks
    from repro_torch.serve import cli
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.query import Query
    from repro_torch.serve.queue import AdmissionQueue
    from repro_torch.serve.telemetry import NULL, Telemetry, \
        lifecycle_breakdown

    bn = getattr(networks, SERVE_NET)()
    registry = {SERVE_NET: bn}
    traffic = cli.synthetic_stream_traffic(
        bn, SERVE_NET, STREAM["streams"], STREAM["slices"],
        np.random.default_rng(0), SERVE_BUDGET)
    kw = dict(burn_in=SERVE_BURN_IN, seed=0)
    engine = PosteriorEngine(registry, **kw)
    sync_engine = PosteriorEngine(registry, **kw)
    assert engine.sampler == sync_engine.sampler == "cuda"

    replay = cli.replay_stream
    rec = {}

    def recorded_replay(queue, *args, **kwargs):
        with record_main_path(keep_all=False) as r:    # the main path
            out = replay(queue, *args, **kwargs)
        rec.update(r)
        return out

    cli.replay_stream = recorded_replay
    try:
        m, results = cli.measure_stream(
            engine, sync_engine, traffic,
            rate_multiplier=STREAM["rate_multiplier"],
            max_wait_ms=STREAM["max_wait_ms"], scheduler=STREAM["scheduler"])
    finally:
        cli.replay_stream = replay
    check_recorded(rec, "serve_stream")
    want_warm = STREAM["streams"] * (STREAM["slices"] - 1)
    arrivals = [i / m["rate_qps"] for i in range(len(traffic))]

    def replay_again(tel, profiled: bool):
        """The same arrivals on the same (warm) engine, streams reset."""
        engine.reset_streams()
        engine.telemetry = tel
        queue = AdmissionQueue(engine, max_wait_ms=STREAM["max_wait_ms"],
                               scheduler=STREAM["scheduler"])
        torch.cuda.synchronize()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        try:
            with ctx as prof:
                res, lat, wall = replay(queue, traffic, arrivals)
                torch.cuda.synchronize()
        finally:
            queue.close()
        p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
        return res, dict(queries_per_s=len(traffic) / wall,
                         p50_ms=float(p50), p99_ms=float(p99), wall_s=wall,
                         warm_started=int(sum(r.warm_start for r in res))), \
            prof

    recorded, with_tel, _ = replay_again(Telemetry(), profiled=False)
    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = (os.path.join(tmp, n) for n in ("t.json", "m.json"))
        engine.telemetry.write_trace(trace)
        with open(metrics, "w") as f:
            json.dump(engine.stats(), f)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        with open(metrics) as f:
            snap = json.load(f)
    if not events or snap["queue"]["submitted"] != len(traffic):
        raise AssertionError(f"serve_stream: trace {len(events)} events, "
                             f"metrics {snap['queue']}")
    breakdown = lifecycle_breakdown(engine.telemetry.events())
    again, profiled, prof = replay_again(NULL, profiled=True)
    busy = device_busy_s(prof)
    if not busy > 0:
        raise AssertionError("serve_stream: the profiled replay shows no "
                             "device time")

    spr = networks.sprinkler()
    a = STREAM_ANCHOR
    eng = PosteriorEngine({"sprinkler": spr}, chains_per_query=a[
        "chains_per_query"], ess_target=a["ess_target"],
        max_rounds=a["max_rounds"], seed=0)
    evidence = ({"wetgrass": 1}, {"wetgrass": 0}, {"wetgrass": 1})
    q = AdmissionQueue(eng, max_wait_ms=3_600_000.0)
    try:
        hs = q.submit_many([Query("sprinkler", ev, ("rain",),
                                  n_samples=a["n_samples"], stream_id="cam")
                            for ev in evidence])
        q.flush()
        anchor = [h.result(timeout=600) for h in hs]
    finally:
        q.close()
    errs = [float(np.abs(r.marginal("rain")
                         - spr.marginals_exact(ev)[2]).max())
            for r, ev in zip(anchor, evidence)]

    out = {k: m[k] for k in ("n_queries", "rate_qps", "queries_per_s",
                             "p50_ms", "p99_ms", "sync_queries_per_s",
                             "speedup", "warm_started", "backfilled",
                             "dispatched_groups", "converged",
                             "msample_per_s", "ess_per_s")}
    out.update(launches=rec["launches"], device_busy_s=busy,
               device_busy_share=busy / profiled["wall_s"])
    emit({"phase": "serve_stream", "card": card_name, **out,
          "with_recorder": with_tel, "latency_breakdown": breakdown,
          "profiled": profiled, "trace_events": len(events),
          "host_word_calls": rec["word_calls"],
          "sprinkler_stream": {"max_err": errs, "tol": a["tol"],
                               "warm_start": [r.warm_start
                                              for r in anchor]}})
    warm = [m["warm_started"], with_tel["warm_started"],
            profiled["warm_started"]]
    if warm != [want_warm] * 3:
        raise AssertionError(f"serve_stream: {warm} slices warm-started, "
                             f"want {want_warm}")
    if not (max(errs) < a["tol"]
            and [r.warm_start for r in anchor] == [False, True, True]):
        raise AssertionError(f"serve_stream: sprinkler stream off exact by "
                             f"{errs} or not warm-started")
    check_marginals(results + recorded + again + anchor, "serve_stream")
    kern = phase_main_path_kernel(rec)
    rec["calls"].clear()
    return dict(path_entry(rec, kern), **{k: out[k] for k in (
        "queries_per_s", "p50_ms", "p99_ms", "device_busy_share")})


def wire_batch(registry):
    """The wire phase's /v2/batch: 16 hailfinder_scale queries over 2
    patterns, one MAP query, one scribble-mask MrfQuery at 500 x 333 (the
    sparse ``mask_sites`` form), as wire objects."""
    import dataclasses as dc

    from repro_torch.serve import cli
    from repro_torch.serve.protocol import request_to_wire
    from repro_torch.serve.query import MrfQuery

    rng = np.random.default_rng(0)
    bn = registry[SERVE_NET]
    qs = cli.synthetic_traffic(bn, SERVE_NET, WIRE["queries"],
                               WIRE["patterns"], rng, WIRE["budget"])
    qs.append(dc.replace(qs[0], mode="map"))
    h, w = registry["mrf_penguin"].shape
    mask = cli.scribble_mask(h, w, rng)
    rows, cols = np.nonzero(mask)
    labels = rng.integers(0, registry["mrf_penguin"].n_labels, rows.size)
    qs.append(MrfQuery("mrf_penguin", mask_sites=tuple(
        (int(r), int(c), int(v)) for r, c, v in zip(rows, cols, labels)),
        query_sites=((h // 2, w // 2), (h // 3, w // 4), (10, 10)),
        n_samples=WIRE["budget"]))
    return [request_to_wire(q, id=f"q{i}") for i, q in enumerate(qs)]


def phase_serve_wire(card_name: str) -> dict:
    """A ``WorkerPool`` of two workers on the one card behind
    ``ServeFrontEnd`` on 127.0.0.1 (ephemeral port): one /v2/batch of 18
    requests (BN marginals, BN MAP, an MRF scribble mask at 500 x 333),
    every response bitwise equal to an in-process ``answer_batch`` on the
    card with the same seed; a WebSocket stream of 3 slices of one
    ``stream_id`` (slices 1-2 warm-started); a quota overrun answered
    429; ``/healthz``, ``/stats`` and ``/metrics``.  Any other error
    response fails the phase.  Launch counts are zeroed before the pool
    starts and read after it stops."""
    import torch

    from repro_torch.serve import cli
    from repro_torch.serve.client import ServeClient, ServeHTTPError
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.protocol import parse_wire_request, wire_marginals
    from repro_torch.serve.server import start_in_thread
    from repro_torch.serve.worker import WorkerPool

    registry = cli.build_registry((SERVE_NET, "mrf_penguin"),
                                  mrf_shape=SERVE_MRF["shape"])
    batch = wire_batch(registry)
    stream = [{"v": 2, "id": f"s{t}", "network": SERVE_NET,
               "evidence": {"0": t % 2}, "query_vars": [5],
               "n_samples": WIRE["budget"], "stream_id": "sensor"}
              for t in range(WIRE["slices"])]
    with record_main_path(keep_all=False) as rec:      # the main path
        pool = WorkerPool(lambda name: PosteriorEngine(registry,
                                                       **SERVE_DEPTH),
                          WIRE["workers"], queue_kwargs={"max_wait_ms": 5.0})
        fe = start_in_thread(pool, port=0)
        try:
            client = ServeClient("127.0.0.1", fe.port)
            health = client.wait_ready(60.0)
            t0 = time.perf_counter()
            served = client.query_batch(batch)
            batch_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            slices = client.stream(stream)
            stream_s = time.perf_counter() - t0
            quota = start_in_thread(pool, port=0, quota_qps=0.001,
                                    quota_burst=1)
            try:
                qc = ServeClient("127.0.0.1", quota.port)
                first = qc.query(stream[0] | {"stream_id": None,
                                              "tenant": "acme"})
                try:
                    qc.query(stream[0] | {"stream_id": None,
                                          "tenant": "acme"})
                    shed = None
                except ServeHTTPError as exc:
                    shed = exc.status, exc.retry_after
            finally:
                quota.stop_thread()
            stats, metrics = client.stats(), client.metrics()
        finally:
            fe.stop_thread()
            pool.close(drain=False, timeout=60.0)
        torch.cuda.synchronize()
    check_recorded(rec, "serve_wire")
    for w in pool.workers.values():
        if w.queue._thread.is_alive():
            raise AssertionError(f"serve_wire: worker {w.name} still running")

    errors = [r for r in served + slices + [first] if "error" in r]
    want = PosteriorEngine(registry, **SERVE_DEPTH).answer_batch(
        [parse_wire_request(r)[0] for r in batch])
    mismatched = 0
    for wire_r, r in zip(served, want):
        if r.map_assignment is not None:
            mismatched += wire_r["map_assignment"] != {
                str(k): v for k, v in r.map_assignment.items()} or \
                wire_r["map_energy"] != r.map_energy
            continue
        got = wire_marginals(wire_r)
        mismatched += got.keys() != {str(k) for k in r.marginals} or any(
            not np.array_equal(got[str(k)], m) for k, m in r.marginals.items())
    check_marginals(want, "serve_wire")
    warm = [r.get("warm_start") for r in slices]
    served_by = {n: s["queue"]["completed"] if s.get("queue") else None
                 for n, s in stats["workers"].items()}
    emit({"phase": "serve_wire", "card": card_name,
          "workers": WIRE["workers"], "batch": len(batch),
          "batch_round_trip_s": batch_s, "stream_round_trip_s": stream_s,
          "mismatched": mismatched, "errors": errors[:3],
          "stream_warm_start": warm, "quota_shed": shed,
          "completed_by_worker": served_by, "health": health,
          "metrics_lines": len(metrics.splitlines()),
          "launches": rec["launches"], "host_word_calls": rec["word_calls"]})
    if errors or mismatched:
        raise AssertionError(f"serve_wire: {len(errors)} error responses, "
                             f"{mismatched} responses differ from the "
                             f"in-process answer_batch")
    if warm != [False, True, True]:
        raise AssertionError(f"serve_wire: stream warm starts {warm}")
    if shed is None or shed[0] != 429 or not shed[1] > 0:
        raise AssertionError(f"serve_wire: quota overrun answered {shed}")
    if not (health["ok"] and "serve_front_served_total" in metrics
            and stats["served"] >= len(batch) + len(slices)):
        raise AssertionError(f"serve_wire: health {health}, stats {stats}")
    kern = phase_main_path_kernel(rec)
    rec["calls"].clear()
    torch.cuda.empty_cache()
    return dict(path_entry(rec, kern), batch_round_trip_s=batch_s)


def cold_device_ms(fn, reps: int, device, calls: int = 1) -> float:
    """Mean device milliseconds of one call of ``fn`` (which may launch
    several kernels), ``calls`` calls back to back between two CUDA
    events, ``reps`` times, with a cold and clean L2: before each rep
    512 MB are read (ten times the card's 50 MB L2), which leaves no line
    of the call's inputs in L2 and none dirty (a write fill leaves 50 MB
    of dirty lines draining to device memory while the call runs).  Then
    a spin kernel (``torch.cuda._sleep``) holds the card for twice the
    host's time to enqueue the calls (at an assumed 2 GHz, the most an
    H100 clocks, so the spin is if anything longer): every kernel is
    queued before the first one starts, and the events time the device
    alone, not the host's dispatch between kernels."""
    import torch

    def batch():
        for _ in range(calls):
            fn()

    scratch = torch.ones(128 << 20, dtype=torch.float32, device=device)
    batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * host_s * 2e9)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        scratch.sum()
        torch.cuda._sleep(cycles)
        start.record()
        batch()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps / calls


def ky_weights(b: int, n: int, seed: int, device):
    """12-bit KY weights of Dirichlet(0.3) rows, made with numpy."""
    import torch

    from repro_torch.core.fixedpoint import quantize_probs

    p = np.random.default_rng(seed).dirichlet(np.full(n, 0.3), size=b)
    return quantize_probs(torch.tensor(p, dtype=torch.float32,
                                       device=device), 12)


def phase_ky_sampler(device) -> dict:
    """The stand-alone KY sampler at the KY-vs-CDF benchmark's sizes, a
    ragged case with an all-zero row, and a frequency check; every field
    equal to the plain version on the card; then timed (the kernel with a
    cold L2, the plain version and ``cdf_sample`` warm), with the bound
    from each case's own ``bits_used``.  At the widest shape also the
    whole ``ops.ky_sample_kernel`` call (zero-row fix, ``ky_prep``, bit
    words, launch: ``call_ms``) and its ``rng.random_bit_words`` part
    (``words_ms``), each on a held card by :func:`cold_device_ms`."""
    import torch

    from repro_torch.core import rng
    from repro_torch.core.cdf import cdf_sample
    from repro_torch.core.fixedpoint import quantize_probs
    from repro_torch.kernels import ky_sampler as kys
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    cases = [ky_weights(b, n, 1000 + n, device) for b, n in KY_SHAPES]
    ragged = ky_weights(*KY_RAGGED, 7, device)
    ragged[5] = 0
    probs = torch.tensor([0.6, 0.3, 0.1], device=device)
    tiled = quantize_probs(probs, 10).expand(65536, 3).contiguous()
    cases += [ragged, tiled]
    key = rng.PRNGKey(0)

    kys.ky_sampler.launches = 0                      # the main path
    got = [ops.ky_sample_kernel(key, w) for w in cases]
    torch.cuda.synchronize()
    launches = kys.ky_sampler.launches
    if launches != len(cases):
        raise AssertionError(f"{launches} KY launches for {len(cases)} calls")

    rows, bad = [], []
    for w, res in zip(cases, got):
        b, n = w.shape
        want = ops.ky_sample_kernel_ref(key, w)
        equal, err = result_err(res, want)
        bits = res.bits_used.to(torch.int64)
        words_read = int(((bits + 31) // 32).sum())
        bound, by = roofline(b * (4 * n + 8 + 9) + 4 * words_read,
                             4 * n * int(bits.sum()), FP32_OPS_PER_S)
        flat, words, klvl, rej, budget, _ = ops._ky_inputs(key, w, 32, device)

        def launch():
            return kys._launch(flat, words, klvl, rej, budget, 256)

        cdf = cdf_sample(key, w)
        row = dict(
            b=b, n=n, equal=equal, max_abs_err=err, ok_all=bool(res.ok.all()),
            bits_per_sample=float(bits.float().mean()),
            cdf_bits_per_sample=float(cdf.bits_used.float().mean()),
            ms=cold_device_ms(launch, 50, device),
            plain_ms=time_ms(lambda: ref.ky_walk_global(
                flat, words, klvl, rej, budget), 3, warmup=1),
            cdf_ms=time_ms(lambda: cdf_sample(key, w), 10),
            bound_ms=bound, bound_by=by)
        row["bit_economy"] = row["cdf_bits_per_sample"] / row[
            "bits_per_sample"]
        if not (equal and row["ok_all"]) or bool((res.sample >= n).any()):
            bad.append(row)
        rows.append(row)
    freq = torch.bincount(got[-1].sample.long(), minlength=3).float() / 65536
    freq_err = float((freq - probs).abs().max())
    emit({"phase": "ky_sampler", "launches": launches, "cases": rows,
          "all_equal": not bad, "freq_err": freq_err})
    if bad or not freq_err < 0.02:
        raise AssertionError(f"KY kernel: {bad}, frequency error {freq_err}")
    full = rows[len(KY_SHAPES) - 1]             # the widest, 65536 x 64
    w = cases[len(KY_SHAPES) - 1]
    b, budget = w.shape[0], 31 * 32             # max_attempts 32
    call_ms = cold_device_ms(lambda: ops.ky_sample_kernel(key, w), 20,
                             device)
    words_ms = cold_device_ms(
        lambda: rng.random_bit_words(key, (b,), budget, device=device), 20,
        device)
    emit({"phase": "ky_sampler_call", "shape": [b, full["n"]],
          "ms": full["ms"], "call_ms": call_ms, "words_ms": words_ms})
    return dict(launches=launches, shape=[full["b"], full["n"]],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                call_ms=call_ms, words_ms=words_ms,
                **{k: full[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")})


def iu_inputs(shape, table, seed: int, device):
    """Uniform inputs over the table's range widened by a quarter at each
    end, so that both clamps are exercised."""
    import torch

    span = table.hi - table.lo
    x = np.random.default_rng(seed).uniform(
        table.lo - span / 4, table.hi + span / 4, size=shape)
    return torch.tensor(x, dtype=torch.float32, device=device)


def phase_interp_lut(device) -> dict:
    """The stand-alone IU at the interp benchmark's tile for the exp and
    sigmoid tables and at ragged shapes; bitwise equal to the plain
    version on the card, and within 2e-3 of the exact function."""
    import torch

    from repro_torch.core import interp
    from repro_torch.kernels import interp_lut as il
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    exact = {"exp": np.exp, "sigmoid": lambda x: 1 / (1 + np.exp(-x))}
    tables = {"exp": interp.exp_table(), "sigmoid": interp.sigmoid_table()}
    cases = [("exp", IU_SHAPE), ("sigmoid", IU_SHAPE)]
    cases += [("exp", shape) for shape in IU_RAGGED]
    inputs = [iu_inputs(shape, tables[name], i, device)
              for i, (name, shape) in enumerate(cases)]

    il.interp_lut.launches = 0                       # the main path
    got = [ops.interp_kernel(x, tables[name].table, lo=tables[name].lo,
                             hi=tables[name].hi)
           for (name, _), x in zip(cases, inputs)]
    torch.cuda.synchronize()
    launches = il.interp_lut.launches
    if launches != len(cases):
        raise AssertionError(f"{launches} IU launches for {len(cases)} calls")

    rows, bad = [], []
    for (name, shape), x, y in zip(cases, inputs, got):
        t = tables[name]
        tab = t.table.to(device)
        want = ops.interp_kernel_ref(x, tab, lo=t.lo, hi=t.hi)
        x64 = np.clip(x.double().cpu().numpy(), t.lo, t.hi)
        fn_err = float(np.abs(exact[name](x64) - y.double().cpu().numpy()
                              ).max())
        bound, by = roofline(8 * x.numel() + 4 * tab.numel(), 8 * x.numel(),
                             FP32_OPS_PER_S)
        row = dict(table=name, shape=list(shape), equal=torch.equal(y, want),
                   max_abs_err=float((y - want).abs().max()), fn_err=fn_err,
                   ms=cold_device_ms(lambda: il._launch(x, tab, t.lo, t.hi),
                                     100, device),
                   plain_ms=time_ms(lambda: ref.interp_ref(x, tab, t.lo,
                                                           t.hi), 20),
                   bound_ms=bound, bound_by=by)
        if not (row["equal"] and fn_err < 2e-3):
            bad.append(row)
        rows.append(row)
    emit({"phase": "interp_lut", "launches": launches, "cases": rows,
          "all_equal": not bad})
    if bad:
        raise AssertionError(f"IU kernel != plain version: {bad}")
    full = rows[0]                               # exp at 4096 x 1024
    return dict(launches=launches, shape=full["shape"],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: full[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")})


def normal(shape, seed: int, dtype, device):
    import torch

    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.tensor(x, device=device).to(dtype)


def within(got, want, dtype_name: str, row_tol: float | None = None) -> dict:
    """Whether every element is within the JAX tests' ``atol + rtol *
    |want|`` and, given ``row_tol``, every row's max |diff| within
    ``row_tol`` times its max |want| (rows along the head dim); the
    largest absolute difference and the largest row-scaled one.
    Compared in float32."""
    atol, rtol = FLASH_TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    row = float((diff.amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max())
    ok_elem = bool((diff <= atol + rtol * w.abs()).all())
    return dict(within_jax_tol=ok_elem, row_tol=row_tol,
                within_tol=ok_elem and (row_tol is None or row <= row_tol),
                max_abs_err=float(diff.max()), max_row_rel_err=row)


def flash_check(device) -> dict:
    """Flash attention's main path and its checks: ``flash_mha`` at
    phi4-mini's full width, and ``flash_attention`` at the five test
    shapes, each in bfloat16, float16 and float32; every case held to the
    plain version on the same (rounded) inputs, compared in float32,
    within the JAX tests' tolerance, and every bfloat16/float16 case per
    row as well.  Each route's launch count is zeroed just before the main
    path and read just after.  Returns the cases and the counts."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, H, KV, dh = (PHI4_ATTN[k] for k in ("B", "S", "H", "KV", "dh"))
    dtypes = [getattr(torch, n) for n in (*FLASH_HALF_DTYPES, "float32")]
    full = {dt: tuple(normal(shape, seed, dt, device) for shape, seed in (
        ((B, S, H, dh), 1), ((B, S, KV, dh), 2), ((B, S, KV, dh), 3)))
        for dt in dtypes}
    small = [(dt, shape, tuple(normal(shape[:3], 10 * i + j, dt, device)
                               for j in range(3)))
             for dt in dtypes for i, shape in enumerate(FLASH_F32_SHAPES)]

    counters = ("launches", "launches_tc", "launches_simt")
    for name in counters:                            # the main path
        setattr(fa.flash_attention, name, 0)
    outs_full = {dt: fa.flash_mha(*qkv, causal=True)
                 for dt, qkv in full.items()}
    outs = [fa.flash_attention(*qkv, causal=causal, q_block=blk,
                               kv_block=blk)
            for _, (_, _, _, causal, blk), qkv in small]
    torch.cuda.synchronize()
    counts = {name: getattr(fa.flash_attention, name) for name in counters}
    n_half = sum(str(dt).removeprefix("torch.") in FLASH_HALF_DTYPES
                 for dt in dtypes) * (1 + len(FLASH_F32_SHAPES))
    want_counts = {"launches": len(outs_full) + len(outs),
                   "launches_tc": n_half,
                   "launches_simt": len(outs_full) + len(outs) - n_half}
    if counts != want_counts:
        raise AssertionError(f"flash launches {counts}, want {want_counts}")

    rows = []
    for dt, o in outs_full.items():
        name = str(dt).removeprefix("torch.")
        want = fa.mha_plain(*full[dt], causal=True)
        rows.append(dict(shape=[B, S, H, KV, dh], dtype=name, causal=True,
                         finite=bool(torch.isfinite(o.float()).all()),
                         **within(o, want, name, FLASH_ROW_TOL.get(name))))
        del want
    for (dt, (bh, s, d, causal, _), qkv), o in zip(small, outs):
        name = str(dt).removeprefix("torch.")
        rows.append(dict(shape=[bh, s, d], dtype=name, causal=causal,
                         finite=bool(torch.isfinite(o.float()).all()),
                         **within(o, ref.mha_ref(*qkv, causal=causal), name,
                                  FLASH_ROW_TOL.get(name))))
    bad = [r for r in rows if not (r["within_tol"] and r["finite"])]
    return dict(rows=rows, bad=bad, **counts)


def phase_flash_attention(device) -> dict:
    """:func:`flash_check`, then both routes timed at full width with a
    cold L2 (bf16 and fp16 on the tensor cores, float32 on the CUDA
    cores), each beside SDPA (also with a cold L2) and the plain version
    on the same inputs.  Returns the two routes' entries of the kernels
    line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    check = flash_check(device)
    emit({"phase": "flash_attention_check", "cases": check["rows"],
          "all_within_tol": not check["bad"],
          **{k: check[k] for k in ("launches", "launches_tc",
                                   "launches_simt")}})
    if check["bad"]:
        raise AssertionError(f"flash kernel outside tolerance: {check['bad']}")
    torch.cuda.empty_cache()

    B, S, H, KV, dh = (PHI4_ATTN[k] for k in ("B", "S", "H", "KV", "dh"))
    flops = 4 * B * H * S * S * dh / 2               # causal
    timing = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v = (normal(shape, seed, dt, device) for shape, seed in (
            ((B, S, H, dh), 1), ((B, S, KV, dh), 2), ((B, S, KV, dh), 3)))
        qt = q.transpose(1, 2).contiguous()          # SDPA's (B, H, S, dh)
        kt, vt = (torch.repeat_interleave(t, H // KV, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        peak = FP32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
        bound, by = roofline(nbytes, flops, peak)
        timing[dt] = dict(
            ms=cold_device_ms(lambda: fa._launch(q, k, v, True), 10, device),
            plain_ms=time_ms(lambda: fa.mha_plain(q, k, v, causal=True), 3,
                             warmup=1),
            library_ms=cold_device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10, device),
            bound_ms=bound, bound_by=by, gflop=flops / 1e9)
        del q, k, v, qt, kt, vt
    emit({"phase": "flash_attention", "full_width": {
        str(dt).removeprefix("torch."): t for dt, t in timing.items()}})

    def err(names):
        return max(r["max_abs_err"] for r in check["rows"]
                   if r["dtype"] in names)

    shape = [B, S, H, KV, dh]
    tc = dict(timing[torch.bfloat16], launches=check["launches_tc"],
              shape=shape, dtype="bfloat16", max_abs_err=err(
                  FLASH_HALF_DTYPES), ms_fp16=timing[torch.float16]["ms"],
              library_ms_fp16=timing[torch.float16]["library_ms"])
    simt = dict(timing[torch.float32], launches=check["launches_simt"],
                shape=shape, dtype="float32", max_abs_err=err(("float32",)))
    return {"tc": tc, "simt": simt}


def mesh_devices(n: int):
    """``n`` devices for a mesh: ``cuda:0..n-1`` when the host has that many
    cards, else the one card repeated (the tile, halo and shard logic then
    runs on it); and which of the two it is."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], "distinct"
    return [torch.device("cuda", 0)] * n, "repeated"


def phase_mesh_gibbs(card_name: str, devices, kind: str) -> dict:
    """Distributed halo-exchange Gibbs (``pgm/mesh_gibbs``) on a 2 x 2
    tile mesh at aia-mrf-penguin's published size, through ``run_mcmc``'s
    mesh branch: on a cut depth ``sampler="cuda"`` equals ``"torch"`` and
    ``comm="halo"`` equals ``comm="allgather"`` bit for bit (labels,
    bits); the bytes each exchange copied per half-step beside the
    per-tile formulas; 200 sweeps timed (site samples per second, bits a
    sample, accuracy against the task's truth), exactly 2 launches a tile
    a sweep; the clamped step once, cuda against torch."""
    import torch

    from repro_torch.configs.aia_paper import PENGUIN
    from repro_torch.core import rng
    from repro_torch.launch.mesh import make_pgm_mesh
    from repro_torch.launch.run_mcmc import run_mrf
    from repro_torch.pgm import networks
    from repro_torch.pgm.mesh_gibbs import (
        make_mesh_gibbs_step, shard_clamp, shard_mrf)
    from repro_torch.serve.cli import scribble_mask

    m, cfg = MESH_GIBBS, PENGUIN
    mesh = make_pgm_mesh(m["rows"], m["cols"], devices=devices)
    tiles = m["rows"] * m["cols"]
    n_id = m["identity_sweeps"]
    with record_main_path(keep_all=False) as rec_id:     # a main path
        halo = run_mrf(cfg, sweeps=n_id, chains=cfg.n_chains,
                       sampler="cuda", mesh=mesh)
    check_recorded(rec_id, "mesh_gibbs identity run")
    plain = run_mrf(cfg, sweeps=n_id, chains=cfg.n_chains, sampler="torch",
                    mesh=mesh)
    gather = run_mrf(cfg, sweeps=n_id, chains=cfg.n_chains, sampler="cuda",
                     mesh=mesh, comm="allgather")
    same = {"cuda_equals_torch": torch.equal(halo["labels"], plain["labels"])
            and halo["bits"] == plain["bits"],
            "halo_equals_allgather": torch.equal(halo["labels"],
                                                 gather["labels"])
            and halo["bits"] == gather["bits"]}
    b = cfg.n_chains
    hp = -(-cfg.height // m["rows"]) * m["rows"]
    wp = -(-cfg.width // m["cols"]) * m["cols"]
    ht, wt = hp // m["rows"], wp // m["cols"]
    comm = {"halo_bytes_per_halfstep":
            halo["step"].comm_bytes / halo["step"].halfsteps,
            "allgather_bytes_per_halfstep":
            gather["step"].comm_bytes / gather["step"].halfsteps,
            "halo_tile_formula": 2 * (ht + wt) * b * 4,
            "allgather_tile_formula": (hp * wp - ht * wt) * b * 4}
    emit({"phase": "mesh_gibbs_identity", "card": card_name,
          "devices": kind, "shape": list(halo["shape"]),
          "padded": [hp, wp], "tile": [ht, wt], "chains": b, "sweeps": n_id,
          "launches": rec_id["launches"], **same, **comm,
          "cuda_s": halo["seconds"], "torch_s": plain["seconds"],
          "allgather_s": gather["seconds"]})
    if not all(same.values()):
        raise AssertionError(f"mesh_gibbs identities: {same}")
    if comm["allgather_bytes_per_halfstep"] != (
            tiles * comm["allgather_tile_formula"]) or not (
            0 < comm["halo_bytes_per_halfstep"]
            <= tiles * comm["halo_tile_formula"]):
        raise AssertionError(f"mesh_gibbs bytes: {comm}")
    if rec_id["launches"] != 2 * tiles * n_id:
        raise AssertionError(f"mesh_gibbs: {rec_id['launches']} launches "
                             f"for {n_id} sweeps")
    del halo, plain, gather
    rec_id["calls"].clear()

    with record_main_path(keep_all=False) as rec:       # the main path
        run = run_mrf(cfg, sweeps=m["sweeps"], chains=cfg.n_chains,
                      sampler="cuda", mesh=mesh)
    check_recorded(rec, "mesh_gibbs")
    if rec["launches"] != 2 * tiles * m["sweeps"]:
        raise AssertionError(f"mesh_gibbs: {rec['launches']} launches for "
                             f"{m['sweeps']} sweeps")
    labels = run["labels"]
    if not bool(((labels >= 0) & (labels < 2)).all()):
        raise AssertionError("mesh_gibbs: labels outside [0, 2)")
    if not run["accuracy"] >= MIN_PENGUIN_ACCURACY:
        raise AssertionError(f"mesh_gibbs: accuracy {run['accuracy']} < "
                             f"{MIN_PENGUIN_ACCURACY}")
    kern = phase_main_path_kernel(rec)
    msample_s = run["n_samples"] / run["seconds"] / 1e6

    # the clamped step once: a scribble of observed pixels, cuda vs torch
    mrf, truth = networks.penguin_task(cfg.height, cfg.width, beta=cfg.beta)
    clamp = scribble_mask(cfg.height, cfg.width, np.random.default_rng(0))
    clamped = {}
    for sampler in ("cuda", "torch"):
        key = rng.PRNGKey(0)
        lab, u, pw, valid, _ = shard_mrf(mesh, mrf, cfg.n_chains, key)
        lab, cl = shard_clamp(mesh, clamp, truth, lab)
        step = make_mesh_gibbs_step(mesh, k=cfg.k, sampler=sampler,
                                    clamped=True)
        bits = 0
        for _ in range(m["clamped_sweeps"]):
            key, sub = rng.split(key)
            lab, bgrid = step(sub, lab, u, pw, valid, cl)
            bits = bits + bgrid.sum()
        full = lab.gather()[:, :cfg.height, :cfg.width]
        clamped[sampler] = (full, int(bits))
    got_clamped = clamped["cuda"][0][:, torch.as_tensor(clamp)]
    held = bool((got_clamped == torch.as_tensor(
        truth[clamp], device=got_clamped.device)).all())
    clamped_same = (torch.equal(clamped["cuda"][0], clamped["torch"][0])
                    and clamped["cuda"][1] == clamped["torch"][1])
    emit({"phase": "mesh_gibbs", "card": card_name, "devices": kind,
          "mesh": mesh.shape, "shape": list(run["shape"]),
          "chains": cfg.n_chains, "sweeps": m["sweeps"],
          "seconds": run["seconds"], "msample_s": msample_s,
          "bits_per_sample": run["bits"] / run["n_samples"],
          "accuracy": run["accuracy"], "launches": rec["launches"],
          "fused_shapes": sorted([b, L, n] for (b, L), n in
                                 rec["shapes"].items()),
          "fused_ms": kern["ms"], "fused_bound_ms": kern["bound_ms"],
          "halo_bytes_per_sweep": run["step"].comm_bytes / m["sweeps"],
          "clamped_pixels": int(clamp.sum()),
          "clamped_cuda_equals_torch": clamped_same,
          "clamped_sites_held": held})
    if not (clamped_same and held):
        raise AssertionError(f"mesh_gibbs clamped: cuda==torch "
                             f"{clamped_same}, clamps held {held}")
    rec["calls"].clear()
    del run, labels, clamped, lab
    torch.cuda.empty_cache()
    return dict(path_entry(rec, kern), msample_s=msample_s,
                devices=kind)


def phase_serve_sharded(card_name: str, devices, kind: str, traffic,
                        want) -> dict:
    """Lane sharding over a 4-way serve mesh: the serve phase's traffic
    through ``PosteriorEngine(mesh=...)`` must equal the serve phase's
    cold pass (``want``) bit for bit (marginals, so counts; diagnostics;
    bits), within 1e-12 on marginals a fortiori; one scribble-mask
    ``MrfQuery`` at 500 x 333 and one ``IsingQuery`` on the side-256
    torus sharded and unsharded, bitwise; and a lane-padding case (6
    chains a query, padded to 8 lanes) within 0.05 of exact."""
    import torch

    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.pgm import networks
    from repro_torch.serve import cli
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.query import Query

    mesh = make_serve_mesh((SHARD_WAYS,), devices=devices)
    registry = {SERVE_NET: getattr(networks, SERVE_NET)()}
    engine = PosteriorEngine(registry, burn_in=SERVE_BURN_IN, seed=0,
                             mesh=mesh)
    assert engine.sampler == "cuda"
    with record_main_path(keep_all=False) as rec:       # the main path
        got, wall = timed_pass(engine, traffic)
    check_recorded(rec, "serve_sharded")
    same = same_results(got, want)
    diff = max(float(np.abs(a.marginals[k] - b.marginals[k]).max())
               for a, b in zip(got, want) for k in a.marginals)
    emit({"phase": "serve_sharded", "card": card_name, "devices": kind,
          "mesh": mesh.shape, "queries": len(traffic), "wall_s": wall,
          "qps": len(traffic) / wall, "launches": rec["launches"],
          "launches_per_round": sorted(rec["per_round"].items()),
          "host_word_calls": rec["word_calls"],
          "equals_unsharded": same, "max_marginal_diff": diff})
    if not same or not diff <= 1e-12:
        raise AssertionError(f"serve_sharded: sharded != unsharded "
                             f"(bitwise {same}, max diff {diff})")
    check_marginals(got, "serve_sharded")
    kern = phase_main_path_kernel(rec)
    rec["calls"].clear()
    out = {"bn": dict(path_entry(rec, kern), qps=len(traffic) / wall)}

    reg = cli.build_registry(("mrf_penguin", "ising_torus"),
                             mrf_shape=SERVE_MRF["shape"],
                             ising_side=SERVE_ISING["side"])
    grids = [cli.synthetic_mrf_traffic(
        reg["mrf_penguin"], "mrf_penguin", 1, 1, np.random.default_rng(0),
        SERVE_MRF["budget"]), cli.synthetic_ising_traffic(
        reg["ising_torus"], "ising_torus", 1, 1, np.random.default_rng(1),
        SERVE_ISING["budget"])]
    with record_main_path(keep_all=False) as rec_g:     # a main path
        t0 = time.perf_counter()
        sharded = [PosteriorEngine(reg, mesh=mesh, **SERVE_DEPTH)
                   .answer_batch(q) for q in grids]
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
    check_recorded(rec_g, "serve_sharded grids")
    t0 = time.perf_counter()
    single = [PosteriorEngine(reg, **SERVE_DEPTH).answer_batch(q)
              for q in grids]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    grid_same = [same_results(a, b) for a, b in zip(sharded, single)]

    spr = networks.sprinkler()
    p = SHARDED_PAD
    pad_engine = PosteriorEngine(
        {"sprinkler": spr}, mesh=mesh, **{k: p[k] for k in (
            "chains_per_query", "burn_in", "max_rounds", "seed")})
    lane_shapes = Counter()
    with record_main_path(keep_all=False) as rec_p:
        res = pad_engine.answer(Query("sprinkler", {"wetgrass": 1},
                                      ("rain",), n_samples=p["n_samples"]))
    lane_shapes.update(rec_p["shapes"])
    exact = spr.marginals_exact({"wetgrass": 1})[2]
    pad_err = float(np.abs(res.marginal("rain") - exact).max())
    emit({"phase": "serve_sharded_grids", "card": card_name,
          "mrf_equals_unsharded": grid_same[0],
          "ising_equals_unsharded": grid_same[1],
          "sharded_s": grid_s, "unsharded_s": single_s,
          "launches": rec_g["launches"],
          "lane_padding": {"chains": p["chains_per_query"],
                           "shapes": sorted([b, L, n] for (b, L), n in
                                            lane_shapes.items()),
                           "p_rain": res.marginal("rain").tolist(),
                           "exact": exact.tolist(), "err": pad_err}})
    if not all(grid_same):
        raise AssertionError(f"serve_sharded grids: sharded != unsharded "
                             f"{grid_same}")
    if not pad_err < p["tol"]:
        raise AssertionError(f"serve_sharded lane padding: off by {pad_err}")
    kern_g = phase_main_path_kernel(rec_g)
    rec_g["calls"].clear()
    out["grids"] = dict(path_entry(rec_g, kern_g))
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def shared_compiles():
    """Each (model, evidence pattern) compiled once for all the engines
    made in the block: the compiled program is host numpy and the same on
    every mesh (each engine still builds its own runners, and the plan
    tensors they place).  A million-spin graph takes seconds of host time
    to colour and pack, which would otherwise be paid per engine."""
    from repro_torch.serve import families

    fams = (families.BAYESNET_FAMILY, families.ISING_FAMILY)
    memo = {}

    def memoized(compile_):
        def compile(model, pattern, **kw):
            key = (id(model), pattern, tuple(sorted(kw.items())))
            if key not in memo:
                memo[key] = compile_(model, pattern, **kw)
            return memo[key]
        return compile

    for fam in fams:
        fam.compile = memoized(fam.compile)
    try:
        yield memo
    finally:
        for fam in fams:
            del fam.compile


def kinds_bytes(kind: str) -> int:
    """Bytes ``partition.KINDS`` counted under ``kind``, all segments."""
    from repro_torch.sharding import partition

    return sum(v[1] for (_, k), v in partition.KINDS.items() if k == kind)


def counted_round_bytes(engine, name: str, query, lanes: int, kind: str,
                        seed: int) -> dict:
    """One round of the runner ``engine`` built for ``query``'s group, on
    a state of ``lanes`` lanes: the bytes counted under ``kind`` between
    "model" positions, beside the plans' reckoning (each batch shard's
    colour updates' halo sites or bank lookups, times the round's
    sweeps)."""
    import torch

    from repro_torch.core import rng
    from repro_torch.pgm.compile import blocked_lookup_bytes
    from repro_torch.pgm.sparse_compile import halo_bytes
    from repro_torch.serve.families import family_of
    from repro_torch.sharding import partition
    from repro_torch.sharding.specs import lane_bounds

    fam = family_of(engine.networks[name])
    pattern = group_pattern(engine, name, query)
    prog, runner, _ = engine._plan(name, pattern)
    ev = (torch.zeros(len(pattern), dtype=torch.int32, device=engine.device)
          if pattern else None)
    x = runner.place(fam.init_states(rng.PRNGKey(seed), prog, lanes, ev,
                                     device=engine.device))
    partition.reset_traffic()
    runner(rng.PRNGKey(seed), x, 0)
    torch.cuda.synchronize()
    per_colour = []
    for run, (lo, hi) in zip(runner.runners,
                             lane_bounds(lanes, len(runner.runners))):
        per_colour.append(
            [halo_bytes(c, hi - lo) for c in run.colours] if kind == "halo"
            else [blocked_lookup_bytes(p, hi - lo, prog.max_card,
                                       len(run.log_cpt.parts))
                  for p in prog.plans])
    per_colour = [sum(c) for c in zip(*per_colour)]
    return {"counted": kinds_bytes(kind),
            "reckoned": engine.sweeps_per_round * sum(per_colour),
            "per_colour_update": per_colour,
            "state_bytes": kinds_bytes("state")}


def phase_serve_model_axis(card_name: str, devices, kind: str) -> dict:
    """The serve mesh's "model" axis on a 2 x 2 ``make_serve_mesh`` over
    ``devices``.  Site blocks: ``ising_torus(1024)``'s IsingQuery traffic
    and ``random_sparse_ising(2**20)``'s, cold and warm with
    ``sampler="cuda"`` (the main path: counts zeroed just before, read
    just after), each fused launch a (batch shard, block, colour) with a
    row map, equal bit for bit to the same passes on the 1-D batch mesh
    and, for the torus, to ``sampler="torch"`` on the 2 x 2 mesh.  Bank
    blocks: a random Bayes net whose log-CPT bank crosses
    ``SERVE_CPT_SHARD_ELEMS`` split in two, and one whose bank is odd kept
    whole, served 2 x 2 against 1-D, bitwise.  Then the bytes a colour
    update copies between "model" positions, counted by
    ``partition.KINDS`` in one round of each runner, against the plans'
    reckoning (equal); the launches per (batch shard, block, colour); the
    first launch of every shape each path launched re-run against its
    recorded result and the plain version and timed with a cold L2 beside
    its bound (:func:`phase_main_path_kernel`, weighted by launches, as
    every other path); queries/s and the peak memory of each card."""
    import torch

    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.pgm import networks
    from repro_torch.pgm.compile import compile_bayesnet
    from repro_torch.serve import cli
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.sharding import specs

    t_phase = time.perf_counter()
    m = MODEL_AXIS
    mesh = make_serve_mesh(m["shape"], devices=devices)
    flat = make_serve_mesh(m["shape"][:1], devices=devices[:m["shape"][0]])
    torus = networks.ising_torus(m["torus_side"])
    glass = networks.random_sparse_ising(m["glass_n"])
    if not (torus.n_vars == specs.SERVE_SITE_SHARD_ELEMS
            and "model" in specs.serve_fg_state_spec(mesh, torus.n_vars)
            and "model" in specs.serve_fg_state_spec(mesh, glass.n_vars)):
        raise AssertionError("serve_model_axis: the graphs do not split")
    reg = {"ising_torus": torus, "glass": glass}
    torus_q = cli.synthetic_ising_traffic(
        torus, "ising_torus", m["torus_queries"], m["torus_patterns"],
        np.random.default_rng(3), 256)
    glass_q = cli.synthetic_ising_traffic(
        glass, "glass", m["glass_queries"], 1, np.random.default_rng(4), 256)
    traffic = {"ising_torus": torus_q, "glass": glass_q}
    n_queries = len(torus_q) + len(glass_q)
    cards = sorted(set(devices), key=str)

    def passes(engines):
        """Cold, then warm: each network's traffic through its engine."""
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = {k: e.answer_batch(traffic[k]) for k, e in engines.items()}
            torch.cuda.synchronize()
            out.append((res, time.perf_counter() - t0))
        return out

    def engines_on(mesh_, names=tuple(reg), **kw):
        return {k: PosteriorEngine({k: reg[k]}, mesh=mesh_,
                                   **MODEL_AXIS_DEPTH, **kw) for k in names}

    with shared_compiles():
        engines = engines_on(mesh)
        assert all(e.sampler == "cuda" for e in engines.values())
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        with record_main_path(keep_all=False) as rec:     # the main path
            (cold, cold_s), (warm, warm_s) = passes(engines)
        check_recorded(rec, "serve_model_axis")
        peak = {str(d): torch.cuda.max_memory_allocated(d) for d in cards}
        (one_cold, one_cold_s), (one_warm, one_warm_s) = passes(
            engines_on(flat))
        (plain_cold, plain_cold_s), (plain_warm, plain_warm_s) = passes(
            engines_on(mesh, ("ising_torus",), sampler="torch"))
        same = {f"{k}_1d_{w}": same_results(a[k], b[k])
                for w, a, b in (("cold", cold, one_cold),
                                ("warm", warm, one_warm)) for k in reg}
        same.update(torch_cold=same_results(cold["ising_torus"],
                                            plain_cold["ising_torus"]),
                    torch_warm=same_results(warm["ising_torus"],
                                            plain_warm["ising_torus"]))
        for res in (cold, warm):
            for k in reg:
                check_marginals(res[k], "serve_model_axis")
        lanes = MODEL_AXIS_DEPTH["chains_per_query"] * m["torus_queries"] \
            // m["torus_patterns"]
        halo = {k: counted_round_bytes(engines[k], k, traffic[k][0], lanes,
                                       "halo", seed)
                for k, seed in (("ising_torus", 5), ("glass", 6))}
        # one launch a (batch shard, block, colour) with nodes a sweep,
        # each group's keys launched as often as the others'
        want_keys = sum(
            len(bp.local) > 0 for k, e in engines.items()
            for p in {group_pattern(e, k, q) for q in traffic[k]}
            for run in e._plan(k, p)[1].runners
            for colour in run.colours for bp in colour)

        bn_kw = m["bn"]
        bns = {"bn_split": networks.random_bayesnet(
            **bn_kw, seed=m["bn_split_seed"]),
            "bn_whole": networks.random_bayesnet(
            **bn_kw, seed=m["bn_whole_seed"])}
        bn_q = (cli.synthetic_traffic(bns["bn_split"], "bn_split",
                                      m["bn_queries"][0], m["bn_patterns"],
                                      np.random.default_rng(5), 256)
                + cli.synthetic_traffic(bns["bn_whole"], "bn_whole",
                                        m["bn_queries"][1], 1,
                                        np.random.default_rng(6), 256))
        bank_elems = {k: int(compile_bayesnet(v).log_cpt.size)
                      for k, v in bns.items()}
        if not (min(bank_elems.values()) >= specs.SERVE_CPT_SHARD_ELEMS
                and specs.serve_cpt_spec(mesh, bank_elems["bn_split"])
                and not specs.serve_cpt_spec(mesh, bank_elems["bn_whole"])):
            raise AssertionError(f"serve_model_axis: banks {bank_elems}")
        bn_engine = PosteriorEngine(bns, mesh=mesh, **SERVE_DEPTH)
        with record_main_path(keep_all=False) as rec_bn:   # a main path
            bn_cold, bn_cold_s = timed_pass(bn_engine, bn_q)
            bn_warm, bn_warm_s = timed_pass(bn_engine, bn_q)
        check_recorded(rec_bn, "serve_model_axis bn")
        bn_one = PosteriorEngine(bns, mesh=flat, **SERVE_DEPTH)
        bn_one_cold, _ = timed_pass(bn_one, bn_q)
        bn_one_warm, _ = timed_pass(bn_one, bn_q)
        bn_same = {"1d_cold": same_results(bn_cold, bn_one_cold),
                   "1d_warm": same_results(bn_warm, bn_one_warm)}
        check_marginals(bn_cold + bn_warm, "serve_model_axis bn")
        banks = {}
        for name, q in (("bn_split", bn_q[0]), ("bn_whole", bn_q[-1])):
            runner = bn_engine._plan(
                name, group_pattern(bn_engine, name, q))[1]
            banks[name] = [[tuple(p.shape) for p in r.log_cpt.parts]
                           if isinstance(r.log_cpt, specs.ModelBlocks)
                           else [tuple(r.log_cpt.shape)]
                           for r in runner.runners]
        bank_bytes = counted_round_bytes(
            bn_engine, "bn_split", bn_q[0],
            SERVE_DEPTH["chains_per_query"] * m["bn_queries"][0]
            // m["bn_patterns"], "bank", 7)
    per_key = Counter(rec["row_maps"].values())
    out = {"phase": "serve_model_axis", "card": card_name, "devices": kind,
           "mesh": mesh.shape, "spins": {"ising_torus": torus.n_vars,
                                         "glass": glass.n_vars},
           "bank_elements": bank_elems, "bank_blocks": banks,
           "queries": n_queries, "launches": rec["launches"],
           "block_launch_keys": len(rec["row_maps"]),
           "block_launch_keys_expected": want_keys,
           "launches_per_block_key": sorted(per_key.items()),
           "launches_per_round": sorted(rec["per_round"].items()),
           "host_word_calls": rec["word_calls"],
           "cold_s": cold_s, "warm_s": warm_s,
           "warm_qps": n_queries / warm_s,
           "flat_cold_s": one_cold_s, "flat_warm_s": one_warm_s,
           "flat_warm_qps": n_queries / one_warm_s,
           "torch_cold_s": plain_cold_s, "torch_warm_s": plain_warm_s,
           "equal": same, "halo": halo,
           "halo_share_of_allgather": {
               name: sum(h["per_colour_update"]) / (
                   len(h["per_colour_update"]) * lanes * n * 4
                   * (mesh.shape["model"] - 1))
               for (name, h), n in zip(halo.items(),
                                       (torus.n_vars, glass.n_vars))},
           "peak_memory_bytes": peak,
           "bn": {"launches": rec_bn["launches"], "equal": bn_same,
                  "bank_bytes": bank_bytes, "cold_s": bn_cold_s,
                  "warm_s": bn_warm_s,
                  "warm_qps": len(bn_q) / bn_warm_s},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if not all(same.values()) or not all(bn_same.values()):
        raise AssertionError(f"serve_model_axis: 2 x 2 != 1-D or cuda != "
                             f"torch: {same}, {bn_same}")
    for name, h in list(halo.items()) + [("bank", bank_bytes)]:
        if not h["counted"] == h["reckoned"] > 0:
            raise AssertionError(f"serve_model_axis {name}: counted "
                                 f"{h['counted']} != reckoned {h['reckoned']}")
    if banks["bn_whole"][0] != [(bank_elems["bn_whole"],)] or any(
            b != [(bank_elems["bn_split"] // 2,)] * 2
            for b in banks["bn_split"]):
        raise AssertionError(f"serve_model_axis: bank placement {banks}")
    if len(per_key) != 1 or len(rec["row_maps"]) != want_keys:
        raise AssertionError(f"serve_model_axis: launches per (shard, "
                             f"block, colour) {sorted(per_key.items())}, "
                             f"{len(rec['row_maps'])} of {want_keys} keys")
    kern = phase_main_path_kernel(rec)
    bn_kern = phase_main_path_kernel(rec_bn)
    rec["calls"].clear()
    rec_bn["calls"].clear()
    del engines, bn_engine, bn_one
    torch.cuda.empty_cache()
    return (dict(path_entry(rec, kern), warm_qps=out["warm_qps"],
                 flat_warm_qps=out["flat_warm_qps"]),
            dict(path_entry(rec_bn, bn_kern),
                 warm_qps=out["bn"]["warm_qps"]))


def group_pattern(engine, name: str, query) -> tuple:
    """The evidence pattern ``engine`` groups ``query`` under."""
    from repro_torch.serve.families import family_of

    model = engine.networks[name]
    return family_of(model).normalize(model, query)[2]


def first_difference(a, b):
    """The first index where two tensors differ, or None."""
    import torch

    diff = torch.nonzero(a.cpu() != b.cpu())
    return None if not len(diff) else diff[0].tolist()


def phase_metropolis(card_name: str) -> dict:
    """Metropolis-Hastings (``pgm/metropolis``) at full size on the card:
    ``mrf_metropolis`` on aia-mrf-penguin (500 x 333, 16 chains) and
    ``fg_metropolis`` on the 65,536-spin random sparse glass — acceptance
    rate, bits, accuracy; then both on the card against the CPU at a
    reduced size, bit for bit (labels, acceptance rate, bits); on a
    difference the first differing site is printed and the phase
    fails."""
    import torch

    from repro_torch.configs.aia_paper import PENGUIN
    from repro_torch.core import rng
    from repro_torch.pgm import networks
    from repro_torch.pgm import sparse_compile as sc
    from repro_torch.pgm.gibbs import init_labels
    from repro_torch.pgm.metropolis import fg_metropolis, mrf_metropolis

    m, cfg = METROPOLIS, PENGUIN
    mrf, truth = networks.penguin_task(cfg.height, cfg.width, beta=cfg.beta)
    lab = init_labels(rng.PRNGKey(0), mrf, cfg.n_chains, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = mrf_metropolis(rng.PRNGKey(1), lab, mrf.unary, mrf.pairwise,
                             n_sweeps=m["sweeps"])
    torch.cuda.synchronize()
    mrf_s = time.perf_counter() - t0
    acc = float((out[0].cpu().numpy() == truth).mean())
    proposals = cfg.n_chains * cfg.height * cfg.width * m["sweeps"]

    prog = sc.compile_factor_graph(networks.random_sparse_ising(
        SPARSE_RUN["n"]))
    x0 = sc.init_fg_states(rng.PRNGKey(0), prog, m["fg_chains"],
                           device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, fst = fg_metropolis(rng.PRNGKey(1), x0, prog, n_sweeps=m["fg_sweeps"])
    torch.cuda.synchronize()
    fg_s = time.perf_counter() - t0

    # the card against the CPU at a reduced size
    h, w = m["small_shape"]
    small, _ = networks.penguin_task(h, w, beta=cfg.beta)
    sprog = sc.compile_factor_graph(networks.random_sparse_ising(
        m["small_spins"]))
    runs = {}
    for dev in ("cuda", "cpu"):
        lab_s = init_labels(rng.PRNGKey(0), small, m["small_chains"],
                            device=dev)
        g = mrf_metropolis(rng.PRNGKey(1), lab_s, small.unary,
                           small.pairwise, n_sweeps=m["small_sweeps"])
        xs = sc.init_fg_states(rng.PRNGKey(0), sprog, m["small_chains"],
                               device=dev)
        f = fg_metropolis(rng.PRNGKey(1), xs, sprog,
                          n_sweeps=m["small_sweeps"])
        runs[dev] = (g, f)
    checks = {}
    for name, i in (("mrf", 0), ("fg", 1)):
        (a, sa), (b, sb) = runs["cuda"][i], runs["cpu"][i]
        checks[name] = dict(
            first_difference=first_difference(a, b),
            accept_rate=[float(sa.accept_rate), float(sb.accept_rate)],
            bits=[int(sa.bits_used), int(sb.bits_used)])
        checks[name]["equal"] = (
            checks[name]["first_difference"] is None
            and checks[name]["accept_rate"][0] == checks[name][
                "accept_rate"][1]
            and checks[name]["bits"][0] == checks[name]["bits"][1])
    emit({"phase": "metropolis", "card": card_name,
          "mrf": {"config": cfg.name, "shape": [cfg.height, cfg.width],
                  "chains": cfg.n_chains, "sweeps": m["sweeps"],
                  "seconds": mrf_s,
                  "mproposals_s": proposals / mrf_s / 1e6,
                  "accept_rate": float(st.accept_rate),
                  "bits_used": int(st.bits_used),
                  "bits_per_proposal": int(st.bits_used) / proposals,
                  "accuracy": acc},
          "fg": {"spins": SPARSE_RUN["n"], "chains": m["fg_chains"],
                 "sweeps": m["fg_sweeps"], "seconds": fg_s,
                 "accept_rate": float(fst.accept_rate),
                 "bits_used": int(fst.bits_used)},
          "card_vs_cpu": {"shape": [h, w], "spins": m["small_spins"],
                          "chains": m["small_chains"],
                          "sweeps": m["small_sweeps"], **checks}})
    bad = [k for k, c in checks.items() if not c["equal"]]
    if bad:
        raise AssertionError(f"metropolis: the card differs from the CPU "
                             f"on {bad}: {checks}")
    for name, rate in (("mrf", st.accept_rate), ("fg", fst.accept_rate)):
        if not 0.0 < float(rate) <= 1.0:
            raise AssertionError(f"metropolis {name}: accept rate {rate}")
    if not bool(((out >= 0) & (out < 2)).all()) or not bool(
            ((x >= 0) & (x < 2)).all()):
        raise AssertionError("metropolis: states outside [0, 2)")
    if not acc >= m["min_accuracy"]:
        raise AssertionError(f"metropolis: penguin accuracy {acc} < "
                             f"{m['min_accuracy']}")
    return {"mrf_accept_rate": float(st.accept_rate),
            "fg_accept_rate": float(fst.accept_rate)}


def kernel_launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_sweep as fs
    from repro_torch.kernels import interp_lut as il
    from repro_torch.kernels import ky_sampler as kys

    return {"fused_gibbs_sample": fs.fused_gibbs_sample.launches,
            "ky_sampler": kys.ky_sampler.launches,
            "interp_lut": il.interp_lut.launches,
            "flash_attention": fa.flash_attention.launches}


def zero_kernel_launch_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_sweep as fs
    from repro_torch.kernels import interp_lut as il
    from repro_torch.kernels import ky_sampler as kys

    fs.fused_gibbs_sample.launches = 0
    kys.ky_sampler.launches = 0
    il.interp_lut.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_attention.launches_tc = 0
    fa.flash_attention.launches_simt = 0


def lm_step_bytes(model, batch: int, cache_len: int) -> int:
    """Bytes one decode step must move: every parameter read once in the
    dtype the step reads it (matrices in the compute dtype, vectors as
    stored; a tok table that is not tied is gathered at ``batch`` rows
    only, as stored), the KV cache read over ``cache_len`` positions and one
    position written, the SSM state read and written, the logits
    written."""
    import torch

    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import init_cache

    cfg = model.cfg
    cdt = torch.tensor([], dtype=torch_dtype(cfg.dtype)).element_size()
    n = 0
    for name, p in model.named_parameters():
        if name == "embed.tok" and not cfg.tie_embeddings:
            n += batch * p[0].numel() * p.element_size()
        elif p.ndim >= 2:
            n += p.numel() * cdt
        else:
            n += p.numel() * p.element_size()
    for name, c in init_cache(cfg, 1, 1, device="meta").items():
        row = c[0, 0].numel() * c.element_size() * cfg.n_layers * batch
        if name in ("k", "v", "k_scale", "v_scale"):   # (L, B, T, ...)
            n += row * (cache_len + 1)
        elif name in ("xk", "xv"):         # the static cross memory, read
            n += row
        else:                              # SSM state: read and written
            n += 2 * row
    return n + batch * cfg.vocab * cdt


def lm_replay(model, prompt, tokens, temperature: float,
              **extra) -> dict:
    """Feed a run's tokens back through the model and read every step's
    distribution: mean entropy (bits) of softmax(logits / T) over steps
    and rows, and the smallest top-2 logit margin."""
    import torch

    from repro_torch.models.sampling import prefill
    from repro_torch.models.transformer import decode_step, init_cache

    b, s = prompt.shape
    n = tokens.shape[1]
    cache = init_cache(model.cfg, b, s + n, device=prompt.device)
    cache, logits = prefill(model, prompt, cache, q_block=s, **extra)
    ent, margin = [], float("inf")
    for i in range(n):
        lp = torch.log_softmax(logits.float() / temperature, dim=-1)
        ent.append(float(-(lp.exp() * lp).sum(-1).mean()) / np.log(2.0))
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        if i + 1 < n:
            logits, cache = decode_step(model, tokens[:, i:i + 1], s + i,
                                        cache)
    return {"entropy_bits": float(np.mean(ent)), "top2_margin": margin}


def lm_full_width(arch: str, card_name: str) -> dict:
    """One architecture at its published width on the card: random init
    from a seeded generator on the card, ``generate`` with each sampler
    (tok/s, ms a decode step, bits a token, the steps' entropy), the ky
    sampler again at the first step's logit std, a decode step alone
    (host clock, synchronized), device launches and busy time of one
    step and of one KY sample by torch.profiler, peak memory, and the
    step's bytes bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.models.sampling import generate, prefill, sample_logits
    from repro_torch.models.transformer import (
        decode_step, init_cache, init_model)

    dev = torch.device("cuda")
    cfg = get_config(arch)
    b, s, n_new = LM_RUN["batch"], LM_RUN["prompt_len"], LM_RUN["max_new"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = rng.randint(rng.PRNGKey(1), (b, s), 0, cfg.vocab, device=dev)
    # warm-up: cuBLAS handles, the compute-dtype casts of the weights
    generate(model, prompt, rng.PRNGKey(2), max_new=2, sampler="greedy")
    cache = init_cache(cfg, b, s + n_new, device=dev)
    cache, logits = prefill(model, prompt, cache)
    t_std = float(logits.float().std())
    if not (torch.isfinite(logits.float()).all() and t_std > 0):
        raise AssertionError(f"lm_generate {arch}: bad first-step logits")
    steps = s + n_new - 1                       # decode steps of a run
    runs = {}
    for sampler, temp in [(x, 1.0) for x in LM_SAMPLERS] + [("ky", t_std)]:
        label = sampler if temp == 1.0 else "ky_at_logit_std"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, bits = generate(model, prompt, rng.PRNGKey(2), max_new=n_new,
                              sampler=sampler, temperature=temp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if tuple(toks.shape) != (b, n_new) or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"lm_generate {arch} {label}: bad tokens")
        rep = lm_replay(model, prompt, toks, temp)
        runs[label] = dict(
            temperature=temp, tok_s=b * n_new / wall, wall_s=wall,
            ms_per_step=wall / steps * 1e3, bits_per_token=bits / (b * n_new),
            tokens0=toks[0, :8].tolist(), **rep)
        if sampler == "greedy" and not torch.equal(
                toks[:, 0], torch.argmax(logits, -1).to(torch.int32)):
            raise AssertionError(f"lm_generate {arch}: greedy != argmax")
    # one decode step alone, and sampling alone, host clock synchronized
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(8):
        logits, cache = decode_step(model, tok, s + i, cache)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    sample_ms = {}
    for sampler, temp in (("ky", 1.0), ("ky", t_std), ("categorical", 1.0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            sample_logits(rng.PRNGKey(i), logits.float(), sampler=sampler,
                          temperature=temp)
        torch.cuda.synchronize()
        label = sampler if temp == 1.0 else "ky_at_logit_std"
        sample_ms[label] = (time.perf_counter() - t0) / 8 * 1e3
    profiled = {}
    for part in ("decode_step", "ky_sample_at_logit_std"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if part == "decode_step":
                logits, cache = decode_step(model, tok, s + 8, cache)
            else:
                sample_logits(rng.PRNGKey(9), logits.float(), sampler="ky",
                              temperature=t_std)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        profiled[part] = {
            "launches": int(sum(e.count for e in kernels)),
            "wall_ms": wall * 1e3,
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3}
    bound = serve_bound(cfg, b, s + n_new)
    peak = torch.cuda.max_memory_allocated()
    out = {"phase": "lm_generate", "arch": arch, "card": card_name,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": b, "prompt_len": s, "max_new": n_new,
           "init_s": init_s, "first_step_logit_std": t_std, "runs": runs,
           "decode_step_ms": step_ms, "sample_ms": sample_ms,
           **bound, "step_over_bound": step_ms / bound["bound_ms"],
           "launches_per_step": sum(p["launches"] for p in profiled.values()),
           "profiled": profiled,
           "peak_memory_gb": peak / 1e9}
    emit(out)
    del model, cache, logits
    torch.cuda.empty_cache()
    return out


def lm_card_vs_cpu(family: str, arch: str, kw: dict) -> dict:
    """One family at smoke size in float32: the same weights on the CPU
    and the card; decode logits, greedy tokens, KY stages."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.core.token_sampler import ky_sample_stages, token_weights
    from repro_torch.models.layers import drop_casts
    from repro_torch.models.sampling import generate
    from repro_torch.models.transformer import (
        decode_step, encode, init_cache, init_model, prefill_cross_cache)

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    cfg = get_config(arch, smoke=True).replace(**kw)
    assert cfg.dtype == "float32"
    host = init_model(cfg, torch.Generator().manual_seed(0), device=cpu)
    card = copy.deepcopy(host).to(dev)
    drop_casts(card)
    b, s, n_new = LM_SMOKE["batch"], LM_SMOKE["prompt_len"], LM_SMOKE["max_new"]
    r = np.random.default_rng(1)
    toks = torch.from_numpy(r.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    extra = {}
    if cfg.family in ("encdec", "audio"):
        extra["src_embeds"] = torch.from_numpy(r.standard_normal(
            (b, cfg.enc_seq_len, cfg.d_model), dtype=np.float32))
    caches = {}
    for name, m, d in (("cpu", host, cpu), ("cuda", card, dev)):
        c = init_cache(cfg, b, s, device=d)
        if extra:
            c = prefill_cross_cache(m, encode(m, extra["src_embeds"].to(d), 8), c)
        caches[name] = c
    err = 0.0
    for t in range(s):
        want, caches["cpu"] = decode_step(host, toks[:, t:t + 1], t,
                                          caches["cpu"])
        got, caches["cuda"] = decode_step(card, toks[:, t:t + 1].to(dev), t,
                                          caches["cuda"])
        lim = LM_TOL * max(1.0, float(want.abs().max()))
        e = float((got.cpu() - want).abs().max())
        if not e <= lim:
            raise AssertionError(f"lm {family}: card logits {e} > {lim}")
        err = max(err, e / max(1.0, float(want.abs().max())))
    temp = float(want.std())
    w1, w2 = token_weights(want, temperature=temp)
    k_cpu = ky_sample_stages(rng.PRNGKey(3), w1, w2, chunk=512)
    k_card = ky_sample_stages(rng.PRNGKey(3), w1.to(dev), w2.to(dev),
                              chunk=512)
    if not all(torch.equal(x, y.cpu()) for x, y in zip(k_cpu, k_card)):
        raise AssertionError(f"lm {family}: KY stages card != CPU")
    gen = {}
    for name, m, d in (("cpu", host, cpu), ("cuda", card, dev)):
        kw_d = {k: v.to(d) for k, v in extra.items()}
        gen[name], _ = generate(m, toks.to(d), rng.PRNGKey(2), max_new=n_new,
                                sampler="greedy", q_block=s, **kw_d)
    margin = lm_replay(host, toks, gen["cpu"], 1.0, **extra)["top2_margin"]
    if not torch.equal(gen["cpu"], gen["cuda"].cpu()):
        raise AssertionError(f"lm {family}: greedy tokens card != CPU "
                             f"(smallest top-2 margin {margin})")
    return {"max_rel_logit_err": err, "ky_bits": int(k_cpu.bits_used.sum()),
            "greedy_min_margin": margin}


def phase_lm_generate(card_name: str) -> dict:
    """The LM serving path on the card.  No kernel of the port is on it
    (the reference's models call no Pallas kernel; the KY walks run as
    plain PyTorch), so every launch count must stay 0 over it."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the float32 checks need it off")
    zero_kernel_launch_counts()                      # the main path
    full = {arch: lm_full_width(arch, card_name) for arch in LM_FULL}
    launches = kernel_launch_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_generate launched a kernel: {launches}")
    smoke = {fam: lm_card_vs_cpu(fam, arch, kw)
             for fam, arch, kw in LM_FAMILIES}
    emit({"phase": "lm_identity", "tolerance": LM_TOL, "families": smoke})
    p = full[LM_FULL[0]]
    return {"launches": 0, "kernel_launches": launches,
            "arch": LM_FULL[0], "decode_step_ms": p["decode_step_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"]}


def lm_train_bound(cfg, tokens: int) -> dict:
    """The least time of one train step of the config as it runs
    (remat "full"), and its reckoning.  Operations: 8 N T matrix FLOPs
    (forward 2 N T, the remat's second forward 2 N T, backward 4 N T; N
    parameters, T tokens) at the bf16 tensor-core peak; the 6 N T of a
    step without remat (which this batch would fit) is given beside it.
    Bytes: what the step function must move, each input read once and
    each output written once: the float32 parameters and both float32
    moments read and written, 24 bytes a parameter.  The gradients are
    made and used inside the step, so they are not counted; writing and
    reading them once (8 bytes a parameter more) is given beside it."""
    n = cfg.param_count()
    flops = 8 * n * tokens
    nbytes = 24 * n
    bound_ms, bound_by = roofline(nbytes, flops, BF16_OPS_PER_S)
    return {"params": n, "tokens": tokens, "remat": cfg.remat,
            "flops": flops, "flops_ms": flops / BF16_OPS_PER_S * 1e3,
            "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "flops_no_remat_6nt_ms": 6 * n * tokens / BF16_OPS_PER_S * 1e3,
            "bytes_with_grads_32b_ms": 32 * n / HBM_BYTES_PER_S * 1e3}


def lm_train_steps(cfg, steps: int, dev, seed: int = 0, mesh=None):
    """``launch/train.py``'s loop on the card: a state from a seeded
    generator on ``dev`` (placed on ``mesh`` by ``place_model`` when one
    is given), ``TokenDataset`` batches, each step through ``StepGuard``
    and timed on the host clock to a synchronize of every card, with the
    bytes it copied between mesh positions.  Returns (state, step
    function, per-step records, dataset); fails on a loss or norm that
    is not finite, and on any retry or reload."""
    import torch

    from repro_torch.models.transformer import init_model, place_model
    from repro_torch.sharding import partition
    from repro_torch.training import DataConfig, StepGuard, TokenDataset
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    run = LM_TRAIN_RUN
    cards = [dev] if mesh is None else sorted(set(mesh.devices.flat), key=str)
    model = init_model(cfg, torch.Generator(dev).manual_seed(seed),
                       device=dev)
    if mesh is not None:
        place_model(mesh, model)
    state = init_train_state(cfg, model)
    del model
    step_fn, _ = make_train_step(cfg, q_block=min(run["seq_len"], 512),
                                 mesh=mesh)
    ds = TokenDataset(DataConfig(cfg.vocab, run["seq_len"], run["batch"]))
    guard = StepGuard()
    recs = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch_at(i).items()}
        partition.reset_traffic()
        sync_cards(cards)
        t0 = time.perf_counter()
        state, m = guard.run(step_fn, state, batch)
        sync_cards(cards)
        recs.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "crossed_bytes": partition.TRAFFIC["crossed_bytes"]})
    if not np.isfinite([[r["loss"], r["grad_norm"]] for r in recs]).all():
        raise AssertionError(f"lm_train {cfg.name}: a loss or grad norm "
                             f"is not finite: {recs}")
    if guard.retries or guard.reloads:
        raise AssertionError(f"lm_train {cfg.name}: {guard.retries} "
                             f"retries, {guard.reloads} reloads")
    return state, step_fn, recs, ds


def sync_cards(cards) -> None:
    import torch

    for c in cards:
        torch.cuda.synchronize(c)


def lm_train_full_width(card_name: str) -> dict:
    """phi4-mini-3.8b's training at full width: 4 steps, their times and
    numbers, peak memory, then one more step under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    cfg = get_config(LM_TRAIN_FULL)
    run = LM_TRAIN_RUN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step_fn, recs, ds = lm_train_steps(cfg, run["steps"], dev)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median([r["ms"] for r in recs[1:]]))
    tokens = run["batch"] * run["seq_len"]
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch_at(run["steps"]).items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # device time by the PyTorch op that launched it (kernel names alone
    # do not tell a cast from an add)
    ops = [e for e in prof.key_averages() if e.device_type != DeviceType.CUDA
           and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:12]
    bound = lm_train_bound(cfg, tokens)
    n = bound["params"]
    out = {"phase": "lm_train", "arch": cfg.name, "card": card_name,
           "params": n, "n_layers": cfg.n_layers, "depth_cut": None,
           "batch": run["batch"], "seq_len": run["seq_len"],
           "microbatch": cfg.microbatch, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "steps": recs, "wall_s": wall_s,
           "median_step_ms": med, "tok_s": tokens / med * 1e3,
           "peak_memory_gb": peak / 1e9,
           "state_gb_reckoned": n * LM_TRAIN_STATE_BYTES / 1e9,
           "profiled_step": {
               "wall_ms": prof_wall * 1e3, "busy_ms": busy_ms,
               "busy_share": busy_ms / (prof_wall * 1e3),
               "launches": int(sum(e.count for e in kernels)),
               "top_ops_ms": [[e.key, e.self_device_time_total / 1e3,
                               e.count] for e in top]},
           "bound": bound, "step_over_bound": med / bound["bound_ms"]}
    emit(out)
    del state, step_fn, batch, m
    torch.cuda.empty_cache()
    return out


def lm_train_ssm_and_checkpoint(card_name: str) -> dict:
    """mamba2-130m's training at full width (microbatch 8), 4 steps; then
    its state saved, restored into a state of other weights, and both
    stepped once more on the next batch: every leaf equal bit for bit."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.training import restore, save
    from repro_torch.training.checkpoint import host_snapshot
    from repro_torch.training.train_step import init_train_state

    dev = torch.device("cuda")
    cfg = get_config(LM_TRAIN_SSM)
    steps = LM_TRAIN_RUN["steps"]
    state, step_fn, recs, ds = lm_train_steps(cfg, steps, dev)
    tmp = tempfile.mkdtemp(prefix="lm_train_ckpt_")
    try:
        save(tmp, steps, state)
        other = init_train_state(cfg, init_model(
            cfg, torch.Generator(dev).manual_seed(1), device=dev))
        other, at = restore(tmp, other)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch_at(steps).items()}
    state, m1 = step_fn(state, batch)
    other, m2 = step_fn(other, batch)
    a, b = host_snapshot(state), host_snapshot(other)
    bad = [k for k in a if not np.array_equal(a[k][0], b[k][0])]
    if at != steps or bad or float(m1["loss"]) != float(m2["loss"]):
        raise AssertionError(f"lm_train checkpoint: restored step {at}, "
                             f"leaves that differ after a step: {bad[:8]}")
    med = float(np.median([r["ms"] for r in recs[1:]]))
    out = {"phase": "lm_train", "arch": cfg.name, "card": card_name,
           "microbatch": cfg.microbatch, "steps": recs,
           "median_step_ms": med,
           "tok_s": LM_TRAIN_RUN["batch"] * LM_TRAIN_RUN["seq_len"]
           / med * 1e3,
           "checkpoint": {"leaves": len(a), "bitwise_after_a_step": True,
                          "restored_step": at}}
    emit(out)
    del state, other
    torch.cuda.empty_cache()
    return out


def lm_loss_grads(model, batch) -> tuple[float, dict]:
    """``loss_fn`` (q_block 8) and every gradient leaf, stacked, on the
    host."""
    import torch

    from repro_torch.models.transformer import loss_fn, param_leaves

    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model, batch, 8)
    loss.backward()
    return float(loss.detach()), {
        k: (torch.stack([x.grad for x in p]) if isinstance(p, list)
            else p.grad).float().cpu()
        for k, p in param_leaves(model).items()}


def lm_train_card_vs_cpu(family: str, arch: str, kw: dict) -> dict:
    """One family at smoke size: the same weights and batch on the CPU and
    the card, loss and every gradient leaf."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models.transformer import init_model
    from repro_torch.training.data import make_batch

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    cfg = get_config(arch, smoke=True).replace(**kw)
    host = init_model(cfg, torch.Generator().manual_seed(0), device=cpu)
    card = copy.deepcopy(host).to(dev)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, ShapeCfg("t", 16, 2, "train"), 3).items()}
    want_loss, want = lm_loss_grads(host, batch)
    got_loss, got = lm_loss_grads(card, {k: v.to(dev)
                                         for k, v in batch.items()})
    if not abs(got_loss - want_loss) <= LM_TRAIN_LOSS_RTOL * abs(want_loss):
        raise AssertionError(f"lm_train {family}: card loss {got_loss} "
                             f"!= CPU {want_loss}")
    worst = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        lim = LM_TRAIN_GRAD_TOL * scale
        if cfg.param_dtype == "bfloat16":
            lim = lim + 2.0 ** -7 * w.abs()
        err = (got[k] - w).abs()
        if not bool((err <= lim).all()):
            raise AssertionError(f"lm_train {family}: gradient {k} card != "
                                 f"CPU by {float(err.max())}")
        worst = max(worst, float(err.max()) / scale)
    return {"loss": want_loss,
            "loss_rel_err": abs(got_loss - want_loss) / abs(want_loss),
            "max_rel_grad_err": worst}


def lm_train_params(state) -> dict:
    """Leaf path -> float32 host copy of every parameter leaf."""
    from repro_torch.training.checkpoint import host_snapshot

    out = {}
    for k, (arr, dt) in host_snapshot(state).items():
        if k.startswith(".params"):
            out[k] = ((arr.astype(np.uint32) << 16).view(np.float32)
                      if dt == "bfloat16" else arr, dt)
    return out


def lm_train_step_card_vs_cpu(kind: str, arch: str) -> dict:
    """One train step of an optimizer kind's smoke config from the same
    state on the CPU and the card.  Parameters within 1e-6 (a bf16
    parameter also one bf16 step of the element), except where a
    near-zero gradient took the other sign: AdamW's first step moves
    every element by about its lr whatever the gradient's size; at most
    1 in 10,000 elements may, by at most 2 x 2.1 lr."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.training import DataConfig, TokenDataset
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    cfg = get_config(arch, smoke=True)
    assert cfg.optimizer == kind
    host = init_train_state(cfg, device=cpu)
    card = init_train_state(cfg, copy.deepcopy(host.model).to(dev))
    step_fn, _ = make_train_step(cfg, q_block=8)
    ds = TokenDataset(DataConfig(cfg.vocab, 16, 4))
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
    host, mh = step_fn(host, batch)
    card, mc = step_fn(card, {k: v.to(dev) for k, v in batch.items()})
    lr = make_optimizer(cfg).lr
    a, b = lm_train_params(host), lm_train_params(card)
    n = flipped = 0
    for k, (want, dt) in a.items():
        tol = 1e-6 + (2.0 ** -7 * np.abs(want) if dt == "bfloat16" else 0)
        d = np.abs(b[k][0].astype(np.float64) - want)
        n += d.size
        flipped += int((d > tol).sum())
        if not d.max() <= 2 * 2.1 * lr + np.max(tol):
            raise AssertionError(f"lm_train {kind}: {k} card != CPU by "
                                 f"{d.max()}")
    loss_err = abs(float(mc["loss"]) - float(mh["loss"]))
    if flipped > n // 10_000 or not loss_err <= \
            LM_TRAIN_LOSS_RTOL * abs(float(mh["loss"])):
        raise AssertionError(f"lm_train {kind}: {flipped} of {n} parameters "
                             f"differ; loss differs by {loss_err}")
    return {"loss": float(mh["loss"]), "flipped": flipped, "elements": n}


def lm_train_microbatch_on_card() -> dict:
    """tests/test_training.py's identity on the card: granite smoke in
    float32, microbatch 2 against the full batch, one step: parameters
    within 5e-5."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.training import DataConfig, TokenDataset
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    dev = torch.device("cuda")
    cfg = get_config("granite-20b", smoke=True).replace(dtype="float32")
    model = init_model(cfg, torch.Generator(dev).manual_seed(1), device=dev)
    ds = TokenDataset(DataConfig(cfg.vocab, 8, 4))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch_at(0).items()}
    params = {}
    for mb in (0, 2):
        c = cfg.replace(microbatch=mb)
        st = init_train_state(c, copy.deepcopy(model))
        st, _ = make_train_step(c, q_block=8)[0](st, batch)
        params[mb] = lm_train_params(st)
    err = max(float(np.abs(params[0][k][0] - params[2][k][0]).max())
              for k in params[0])
    if not err < LM_TRAIN_MB_TOL:
        raise AssertionError(f"lm_train: microbatch 2 != full batch by {err}")
    return {"max_abs_diff": err}


def phase_lm_train(card_name: str) -> dict:
    """The training path on the card.  No kernel of the port is on it
    (the reference's models call no Pallas kernel, and its flash
    attention has no backward), so every launch count must stay 0 over
    it."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the float32 checks need it off")
    ident = {"families": {fam: lm_train_card_vs_cpu(fam, arch, kw)
                          for fam, arch, kw in LM_FAMILIES},
             "optimizers": {kind: lm_train_step_card_vs_cpu(kind, arch)
                            for kind, arch in LM_TRAIN_OPT_ARCHS},
             "microbatch": lm_train_microbatch_on_card()}
    emit({"phase": "lm_train_identity", "loss_rtol": LM_TRAIN_LOSS_RTOL,
          "grad_tol": LM_TRAIN_GRAD_TOL, **ident})
    zero_kernel_launch_counts()                      # the main path
    full = lm_train_full_width(card_name)
    ssm = lm_train_ssm_and_checkpoint(card_name)
    launches = kernel_launch_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_train launched a kernel: {launches}")
    return {"launches": 0, "kernel_launches": launches,
            "arch": full["arch"], "median_step_ms": full["median_step_ms"],
            "peak_memory_gb": full["peak_memory_gb"],
            "bound_ms": full["bound"]["bound_ms"],
            "bound_by": full["bound"]["bound_by"],
            "ssm_median_step_ms": ssm["median_step_ms"]}


def mesh_batch(cfg, seed: int, b: int, s: int, dev) -> dict:
    """A TokenDataset batch (plus the stub frontend or source embeddings
    the family takes, from a seeded generator) on ``dev``."""
    import torch

    from repro_torch.training import DataConfig, TokenDataset

    ds = TokenDataset(DataConfig(cfg.vocab, s, b))
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(seed).items()}
    g = torch.Generator().manual_seed(seed + 3)
    if cfg.family == "vlm":
        batch["frontend"] = torch.randn(b, cfg.frontend_tokens, cfg.d_model,
                                        generator=g)
    if cfg.family in ("encdec", "audio"):
        batch["src_embeds"] = torch.randn(b, cfg.enc_seq_len, cfg.d_model,
                                          generator=g)
    return {k: v.to(dev) for k, v in batch.items()}


def mesh_params(state) -> dict:
    """Leaf path -> float32 host copy of every parameter leaf, gathered."""
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sharding import partition

    return {k: partition.gather(v, "cpu").detach().float()
            for k, v in param_leaves(state.model).items()}


def mesh_state(cfg, model, devices):
    """A copy of ``model`` with a fresh optimizer state, placed on a
    ("data", "model") mesh over ``devices`` (None: unplaced)."""
    import copy

    from repro_torch.models.transformer import place_model
    from repro_torch.training.train_step import init_train_state

    m = copy.deepcopy(model)
    if devices is None:
        return init_train_state(cfg, m), None
    from repro_torch.launch.mesh import make_lm_mesh

    mesh = make_lm_mesh(*devices[0], devices=devices[1])
    place_model(mesh, m)
    return init_train_state(cfg, m), mesh


def mesh_loss_grads(state, mesh, batch) -> tuple[float, dict]:
    """The loss over the whole batch and every gradient leaf (stacked, on
    the host), on a mesh or one device."""
    import torch

    from repro_torch.models.transformer import (
        loss_fn, mesh_loss, param_leaves)
    from repro_torch.sharding import partition
    from repro_torch.training.optimizer import as_list, map_leaf
    from repro_torch.training.train_step import split_batch

    leaves = param_leaves(state.model)
    for p in leaves.values():
        for t in as_list(p):
            t.grad = None
    if mesh is None:
        loss = loss_fn(state.model, batch, 8)
    else:
        (run, shards), = split_batch(mesh, batch, 1)
        loss = mesh_loss(state.model, run, shards, 8)
    loss.backward()
    grads = {k: partition.gather(map_leaf(p, lambda t: t.grad), "cpu")
             .float() for k, p in leaves.items()}
    for p in leaves.values():
        for t in as_list(p):
            t.grad = None
    return float(loss.detach()), grads


def mesh_identity(cfg, model, devices, batch, tol: dict,
                  grads: bool = True) -> dict:
    """The mesh's loss, gradients (with ``grads``) and one train step
    against one device's on the same weights and batch; fails outside
    ``tol``."""
    from repro_torch.training.train_step import make_train_step

    out = {}
    for name, dv in (("one", None), ("mesh", devices)):
        st, mesh = mesh_state(cfg, model, dv)
        loss, g = mesh_loss_grads(st, mesh, batch) if grads else (None, {})
        st, m = make_train_step(cfg, q_block=8, mesh=mesh)[0](st, batch)
        out[name] = (float(m["loss"]) if loss is None else loss, g,
                     float(m["loss"]), mesh_params(st))
        del st
    (l1, g1, s1, p1), (l2, g2, s2, p2) = out["one"], out["mesh"]
    # bf16 parameters: each element also one bf16 step of itself, each
    # gradient one bf16 step of the leaf's largest |g| (the data shards'
    # gradients are summed in bf16, each sum rounded once)
    bf = 2.0 ** -7 if cfg.param_dtype == "bfloat16" else 0.0
    loss_err = abs(l2 - l1) / abs(l1)
    step_loss_err = abs(s2 - s1) / abs(s1)
    grad_err = max((float((g2[k] - g1[k]).abs().max())
                    / max(float(g1[k].abs().max()), 1e-30) for k in g1),
                   default=None)
    param_err = max(float((p2[k] - p1[k]).abs().max()) for k in p1)
    grads_ok = all(float((g2[k] - g1[k]).abs().max()) <= (
        tol["grad_tol"] + bf) * float(g1[k].abs().max()) for k in g1)
    params_ok = all(bool(((p2[k] - p1[k]).abs() <= tol["param_tol"]
                          + bf * p1[k].abs()).all()) for k in p1)
    res = {"loss": l1, "loss_rel_err": loss_err,
           "step_loss_rel_err": step_loss_err,
           "max_rel_grad_err": grad_err, "max_param_err": param_err,
           "bf16_params": bool(bf), "tolerance": tol}
    if not (loss_err <= tol["loss_rtol"] and step_loss_err <= tol["loss_rtol"]
            and grads_ok and params_ok):
        raise AssertionError(f"lm_mesh {cfg.name}: the mesh step != one "
                             f"device: {res}")
    return res


def mesh_reckoned_bytes(cfg, mesh, mb_rows: int, nmb: int, seq: int) -> dict:
    """The bytes a train step must copy between mesh positions, from the
    layout, for a model whose "model"-split leaves are all read as their
    pieces and the others whole on each batch shard's home device
    (phi4-mini's: its kv heads divide the axis).  Each leaf's gather
    brings every consumer what is not at its position: (D - 1) times the
    leaf, whatever its spec; a layer's weights are gathered three times
    a microbatch (forward, the remat's second forward, the backward's
    reduce-scatter), the final norm twice, the tied table five times
    (the embedding's and the loss chunk's forward, the chunk's remat,
    both backward passes).  Each tensor-parallel op copies its
    activation to the M - 1 other "model" devices and their partial sums
    back, in the same three passes (the embedding's sum in two, the loss
    chunk's activation in three)."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import init_model, param_leaves
    from repro_torch.sharding import specs as specs_lib

    d, m = mesh.shape["data"], mesh.shape["model"]
    leaves = param_leaves(init_model(cfg, device="meta"))
    weights = 0
    for k, p in leaves.items():
        nbytes = int(np.prod(specs_lib._shape(p))) * 4
        passes = {"embed/tok": 5, "final_norm/scale": 2}.get(k, 3)
        weights += passes * (d - 1) * nbytes
    act = (mb_rows // d) * seq * cfg.d_model * torch_dtype(cfg.dtype).itemsize
    emb = (mb_rows // d) * seq * cfg.d_model * 4
    tp_ops = 2 * cfg.n_layers                       # attention and MLP
    activations = d * (3 * tp_ops * 2 * (m - 1) * act   # layers
                       + 2 * (m - 1) * emb              # embedding
                       + 3 * (m - 1) * act)             # the loss chunk
    return {"weights": weights * nmb, "activations": activations * nmb,
            "total": (weights + activations) * nmb}


def lm_mesh_full_width(card_name: str, devices, kind: str,
                       one: dict) -> dict:
    """phi4-mini-3.8b's training at full width on a 2 x 2 mesh: 4 steps
    through StepGuard, their times beside lm_train's 1 x 1 steps from this
    process, peak memory, the bytes a step copied between mesh positions
    (counted and reckoned), then one step under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import init_model, place_model
    from repro_torch.sharding import partition
    from repro_torch.training import DataConfig, StepGuard, TokenDataset
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    dev = devices[0]
    cards = sorted(set(devices), key=str)
    cfg = get_config(LM_TRAIN_FULL)
    run = LM_TRAIN_RUN
    d, m = LM_MESH["shape"]
    mesh = make_lm_mesh(d, m, devices=devices)
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    place_model(mesh, model)
    state = init_train_state(cfg, model)
    del model
    place_s = time.perf_counter() - t0
    state_bytes = placed_bytes(state)
    step_fn, _ = make_train_step(cfg, q_block=min(run["seq_len"], 512),
                                 mesh=mesh)
    ds = TokenDataset(DataConfig(cfg.vocab, run["seq_len"], run["batch"]))
    guard = StepGuard()
    recs = []
    for i in range(LM_MESH["steps"]):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch_at(i).items()}
        partition.reset_traffic()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, mt = guard.run(step_fn, state, batch)
        torch.cuda.synchronize()
        recs.append({"ms": (time.perf_counter() - t1) * 1e3,
                     "loss": float(mt["loss"]),
                     "grad_norm": float(mt["grad_norm"]),
                     "crossed_bytes": partition.TRAFFIC["crossed_bytes"],
                     "moved_bytes": partition.TRAFFIC["moved_bytes"],
                     "copies": partition.TRAFFIC["crossed_copies"]})
    if not np.isfinite([[r["loss"], r["grad_norm"]] for r in recs]).all():
        raise AssertionError(f"lm_mesh: a loss or norm is not finite {recs}")
    if guard.retries or guard.reloads:
        raise AssertionError(f"lm_mesh: {guard.retries} retries")
    peaks = {str(c): torch.cuda.max_memory_allocated(c) / 1e9
             for c in cards}
    med = float(np.median([r["ms"] for r in recs[1:]]))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch_at(LM_MESH["steps"]).items()}
    # device activity only: the host's ~300,000 op events of a mesh step
    # take minutes to reduce, and launches and busy time need none
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, mt = step_fn(state, batch)
        for c in cards:
            torch.cuda.synchronize(c)
        prof_wall = time.perf_counter() - t1
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    nmb = max(cfg.microbatch, 1)
    reckoned = mesh_reckoned_bytes(cfg, mesh, run["batch"] // nmb, nmb,
                                   run["seq_len"])
    n = cfg.param_count()
    out = {"phase": "lm_mesh", "arch": cfg.name, "card": card_name,
           "mesh": mesh.shape, "devices": [str(x) for x in devices],
           "kind": kind, "params": n, "n_layers": cfg.n_layers,
           "depth_cut": None, "batch": run["batch"],
           "seq_len": run["seq_len"], "microbatch": cfg.microbatch,
           "remat": cfg.remat, "optimizer": cfg.optimizer,
           "place_s": place_s, "steps": recs, "median_step_ms": med,
           "one_device_median_step_ms": one["median_step_ms"],
           "over_one_device": med / one["median_step_ms"],
           "tok_s": run["batch"] * run["seq_len"] / med * 1e3,
           "peak_memory_gb": max(peaks.values()),
           "peak_memory_gb_by_card": peaks,
           "one_device_peak_memory_gb": one["peak_memory_gb"],
           "state_gb_reckoned": n * LM_TRAIN_STATE_BYTES / 1e9,
           "crossed_bytes_counted": recs[-1]["crossed_bytes"],
           "crossed_bytes_reckoned": reckoned,
           "state_bytes_counted": state_bytes,
           "peak_memory_bytes": max(torch.cuda.max_memory_allocated(c)
                                    for c in cards),
           "profiled_step": {
               "wall_ms": prof_wall * 1e3, "busy_ms": busy_ms,
               "busy_share": busy_ms / (prof_wall * 1e3 * len(cards)),
               "launches": int(sum(e.count for e in kernels))}}
    emit(out)
    del state, step_fn, batch, mt
    torch.cuda.empty_cache()
    return out


def placed_bytes(state) -> int:
    """Bytes of every tensor a placed training state holds: the
    parameters' and moments' shards and the step counters."""
    from repro_torch.models.transformer import param_leaves
    from repro_torch.training.optimizer import as_list

    leaves = list(param_leaves(state.model).values())
    leaves += [v for f in state.opt for v in (
        f.values() if isinstance(f, dict) else [f])]
    leaves.append(state.step)
    return sum(t.numel() * t.element_size()
               for leaf in leaves for t in as_list(leaf))


def lm_mesh_small_cases(devices1) -> dict:
    """granite-20b smoke in float32 on 4 x 2 (the reference's own case),
    every family's smoke on 4 x 1 and LM_MESH_TP_CASES against one
    device, a train step each (loss and parameters, as the reference's
    test); the builders' train, prefill and decode cells on 2 x 2
    against 1 x 1 for granite smoke (a cache split on the sequence), phi4
    smoke (on kv heads) and hymba smoke (on kv heads, and its SSM state
    on heads and channels)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model

    dev = devices1[0]
    out = {}
    cases = [("granite-20b", "granite-20b", (4, 2), {"dtype": "float32"})
             ] + [(fam, arch, (4, 1), kw) for fam, arch, kw in LM_MESH_FAMILIES
                  ] + [(fam, arch, shape, {})
                       for fam, arch, shape in LM_MESH_TP_CASES]
    for name, arch, shape, kw in cases:
        cfg = get_config(arch, smoke=True).replace(**kw)
        model = init_model(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
        batch = mesh_batch(cfg, 0, 8, 16, dev)
        tol = dict(LM_MESH_TOL, loss_rtol=1e-4)
        n = int(np.prod(shape))
        out[f"{name}@{shape[0]}x{shape[1]}"] = mesh_identity(
            cfg, model, (shape, [dev] * n), batch, tol, grads=False)
    out["cells"] = {arch: lm_mesh_cells(arch, dev)
                    for arch in ("granite-20b", "phi4-mini-3.8b",
                                 "hymba-1.5b")}
    return out


def lm_mesh_cells(arch: str, dev) -> dict:
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import rng
    from repro_torch.launch.builders import build_cell
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.sharding import partition
    from repro_torch.training.data import make_batch
    from repro_torch.training.train_step import (
        init_train_state, place_train_state)

    cfg = get_config(arch, smoke=True).replace(microbatch=2)
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    shapes = (ShapeCfg("t", 64, 8, "train"), ShapeCfg("p", 64, 4, "prefill"),
              ShapeCfg("d", 64, 4, "decode"))
    res = {}
    for d, m in ((1, 1), (2, 2)):
        mesh = make_lm_mesh(d, m, devices=[dev] * (d * m))
        got = {}
        for shape in shapes:
            fn, args, insh, outsh, donate = build_cell(cfg, mesh, shape)
            spec = {k: v.spec for k, v in (
                insh[1] if shape.kind != "decode" else insh[4]).items()}
            if shape.kind == "train":
                st = place_train_state(mesh, init_train_state(
                    cfg, copy.deepcopy(model)))
                b = {k: torch.from_numpy(v).to(dev) for k, v in
                     make_batch(cfg, shape, 1).items()}
                st, met = fn(st, partition.place(mesh, b, spec))
                got["train"] = (float(met["loss"]), mesh_params(st))
                continue
            mdl = partition.place(mesh, copy.deepcopy(model),
                                  {k: v.spec for k, v in insh[0].items()})
            if shape.kind == "prefill":
                b = {k: torch.from_numpy(v).to(dev) for k, v in
                     make_batch(cfg, shape, 2).items() if k != "labels"}
                got["prefill"] = fn(mdl, partition.place(mesh, b, spec)
                                    ).gather("cpu")
                continue
            cache = partition.place(mesh, init_cache(
                cfg, shape.global_batch, shape.seq_len, device=dev), spec)
            tok = (torch.arange(shape.global_batch, dtype=torch.int32,
                                device=dev) * 7 + 3)[:, None]
            toks = []
            for p in range(4):
                t, cache = fn(mdl, rng.PRNGKey(p),
                              partition.place(mesh, tok, insh[2].spec), p,
                              cache)
                tok = t.gather(dev)[:, None]
                toks.append(tok[:, 0].tolist())
            got["decode"] = toks
            got["cache_spec"] = spec["k"]
        res[(d, m)] = got
    a, b = res[(1, 1)], res[(2, 2)]
    loss_err = abs(a["train"][0] - b["train"][0])
    param_err = max(float((a["train"][1][k] - b["train"][1][k]).abs().max())
                    for k in a["train"][1])
    pre_err = float((a["prefill"] - b["prefill"]).abs().max()) / float(
        a["prefill"].abs().max())
    out = {"loss_err": loss_err, "param_err": param_err,
           "prefill_rel_err": pre_err, "decode_equal": a["decode"] ==
           b["decode"], "cache_spec": b["cache_spec"]}
    if not (loss_err < 1e-4 and param_err < 5e-4 and pre_err <= 1e-5
            and a["decode"] == b["decode"]):
        raise AssertionError(f"lm_mesh cells {arch}: 2 x 2 != 1 x 1: {out}")
    return out


def lm_mesh_checkpoints(dev) -> dict:
    """phi4-mini smoke trained a step on 2 x 2 and saved: restored onto
    4 x 1 and one device bit for bit; restored on 2 x 2 its next step
    equals the live one's bit for bit; two runs of the mesh step on equal
    inputs are bitwise equal."""
    import shutil
    import tempfile

    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import init_model
    from repro_torch.training import restore, save
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    runs = []
    for _ in range(2):
        st, mesh = mesh_state(cfg, model, ((2, 2), [dev] * 4))
        step = make_train_step(cfg, q_block=8, mesh=mesh)[0]
        st, m = step(st, mesh_batch(cfg, 0, 8, 16, dev))
        runs.append((st, mesh, step, float(m["loss"])))
    a, b = mesh_params(runs[0][0]), mesh_params(runs[1][0])
    repeat = runs[0][3] == runs[1][3] and all(torch.equal(a[k], b[k])
                                              for k in a)
    live, mesh, step, _ = runs[0]
    tmp = tempfile.mkdtemp(prefix="lm_mesh_ckpt_")
    try:
        save(tmp, 1, live)
        snap = convert.train_state_to_numpy(live)
        reshard = {}
        for d, m in ((4, 1), (1, 1)):
            other = init_train_state(cfg, init_model(
                cfg, torch.Generator(dev).manual_seed(5), device=dev))
            other, _ = restore(tmp, other, mesh=make_lm_mesh(
                d, m, devices=[dev] * (d * m)))
            got = convert.train_state_to_numpy(other)
            reshard[f"{d}x{m}"] = all(
                np.array_equal(x, y) for x, y in zip(
                    _leaves(snap), _leaves(got)))
        back, _ = mesh_state(cfg, init_model(
            cfg, torch.Generator(dev).manual_seed(7), device=dev),
            ((2, 2), [dev] * 4))
        # a state placed on its own mesh object: restore writes its shards
        back, at = restore(tmp, back)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nb = mesh_batch(cfg, 1, 8, 16, dev)
    live, m1 = step(live, nb)
    back, m2 = make_train_step(cfg, q_block=8, mesh=back.model.mesh)[0](
        back, nb)
    a, b = mesh_params(live), mesh_params(back)
    restored = float(m1["loss"]) == float(m2["loss"]) and all(
        torch.equal(a[k], b[k]) for k in a)
    out = {"repeat_bitwise": repeat, "reshard_bitwise": reshard,
           "restored_step_bitwise": restored, "leaves": len(a)}
    if not (repeat and restored and all(reshard.values())):
        raise AssertionError(f"lm_mesh checkpoints: {out}")
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def phase_lm_mesh(card_name: str, one: dict) -> dict:
    """The training path on a ("data", "model") mesh.  No kernel of the
    port is on it: every launch count must stay 0 over it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model

    devices, kind = mesh_devices(int(np.prod(LM_MESH["shape"])))
    zero_kernel_launch_counts()                      # the main path
    t0 = time.perf_counter()
    full = lm_mesh_full_width(card_name, devices, kind, one)
    emit({"phase": "lm_mesh_full_width_seconds",
          "s": time.perf_counter() - t0})
    launches = kernel_launch_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_mesh launched a kernel: {launches}")
    dev = devices[0]
    ident = {}
    t0 = time.perf_counter()
    for name, kw, tol in (("float32", {"dtype": "float32"}, LM_MESH_TOL),
                          ("bfloat16", {}, LM_MESH_BF16)):
        cfg = get_config(LM_TRAIN_FULL).replace(
            n_layers=LM_MESH["ident_layers"], **kw)
        model = init_model(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
        batch = mesh_batch(cfg, 0, LM_TRAIN_RUN["batch"],
                           LM_TRAIN_RUN["seq_len"], dev)
        ident[name] = mesh_identity(cfg, model, (LM_MESH["shape"], devices),
                                    batch, tol)
        del model
        torch.cuda.empty_cache()
    emit({"phase": "lm_mesh_identity", "arch": LM_TRAIN_FULL,
          "n_layers": LM_MESH["ident_layers"], "full_width": ident,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    small = lm_mesh_small_cases(devices)
    t1 = time.perf_counter()
    ckpt = lm_mesh_checkpoints(dev)
    emit({"phase": "lm_mesh_small", "cases": small, "checkpoints": ckpt,
          "seconds": {"cases": t1 - t0,
                      "checkpoints": time.perf_counter() - t1}})
    return {"launches": 0, "kernel_launches": launches,
            "arch": full["arch"], "mesh": full["mesh"],
            "median_step_ms": full["median_step_ms"],
            "one_device_median_step_ms": full["one_device_median_step_ms"],
            "peak_memory_gb": full["peak_memory_gb"],
            "crossed_bytes_counted": full["crossed_bytes_counted"],
            "crossed_bytes_reckoned": full["crossed_bytes_reckoned"]["total"],
            "state_bytes_counted": full["state_bytes_counted"],
            "peak_memory_bytes": full["peak_memory_bytes"],
            "busy_share": full["profiled_step"]["busy_share"],
            "launches_a_step": full["profiled_step"]["launches"]}


def hybrid_reckoned_bytes(cfg, mesh, mb_rows: int, nmb: int,
                          seq: int) -> dict:
    """The bytes a hybrid train step must copy between mesh positions,
    from the layout (``param_specs``) and the model's reading of it.
    Weights (float32, as stored): a leaf split over "model" is read as
    its pieces by every batch shard's "model" device j, any other (and
    ``embed/tok``, whose "model" split falls on d_model, which the
    lookup does not use) whole by each batch shard's home device; each
    reader receives what its position does not store.  A layer's weights
    are read three times a microbatch (forward, the remat's second
    forward, the backward's reduce-scatter), the output head three (the
    loss chunk's forward, its remat, the backward), the table and the
    final norm twice.  Activations (compute dtype), per layer and batch
    shard, in the same three passes: the MLP's input to the M - 1 other
    "model" devices and their partial sums back; the SSM's input
    likewise, its in_proj blocks home ((M - 1) / M of Z), its out_proj
    input blocks out ((M - 1) / M of d_inner) and the partial sums home.
    The attention, whose heads do not divide "model", moves nothing."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import init_model, param_leaves
    from repro_torch.sharding import partition
    from repro_torch.sharding import specs as specs_lib

    d, m = mesh.shape["data"], mesh.shape["model"]
    if cfg.n_heads % m == 0:
        raise ValueError("the reckoning takes the attention whole at home")
    leaves = param_leaves(init_model(cfg, device="meta"))
    pspecs = specs_lib.param_specs(cfg, leaves, mesh)
    weights = 0
    for k, p in leaves.items():
        shape = specs_lib._shape(p)
        spec = pspecs[k]
        stored = partition.position_bytes(mesh, spec, shape, 4)
        total = int(np.prod(shape)) * 4
        pieces = k != "embed/tok" and any(
            "model" in ((e,) if isinstance(e, str) else tuple(e or ()))
            for e in spec)
        if pieces:
            got = sum(total // m - stored.get((i, j), 0)
                      for i in range(d) for j in range(m))
        else:
            got = sum(total - stored.get((i, 0), 0) for i in range(d))
        passes = {"embed/tok": 2, "final_norm/scale": 2}.get(k, 3)
        weights += passes * got
    b = torch_dtype(cfg.dtype).itemsize
    tok = mb_rows // d * seq
    act = tok * cfg.d_model * b
    z = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + \
        cfg.n_ssm_heads
    per_layer = (2 * (m - 1) * act                     # MLP
                 + 2 * (m - 1) * act                   # SSM in and out
                 + (m - 1) * (z // m) * tok * b        # in_proj blocks
                 + (m - 1) * (cfg.d_inner // m) * tok * b)  # out_proj in
    activations = d * 3 * cfg.n_layers * per_layer
    return {"weights": weights * nmb, "activations": activations * nmb,
            "total": (weights + activations) * nmb}


def family_serve(model, mesh, prompt, steps: int) -> dict:
    """The serving path on ``model``: on a mesh the builders' prefill and
    decode cells (``build_prefill``, ``build_decode(sampler=None)``), on
    the card alone (``mesh`` None) ``forward`` + ``unembed`` and
    ``decode_step`` (the weights' casts kept).  The prompt's prefill,
    timed; then ``steps`` greedy decode steps at positions S ..
    S + steps - 1 over a cache of S + steps positions, each timed to a
    synchronize (the prefill cell, as the reference's, returns the last
    position's logits and writes no cache).  Returns the times, the
    prefill and first-step logits and the greedy tokens."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import rng
    from repro_torch.launch.builders import build_decode, build_prefill
    from repro_torch.models.layers import unembed
    from repro_torch.models.transformer import (
        decode_step, forward, init_cache)
    from repro_torch.sharding import partition

    cfg = model.cfg
    b, s = prompt.shape
    dev = prompt.device
    cards = [dev] if mesh is None else sorted(set(mesh.devices.flat), key=str)
    cache = init_cache(cfg, b, s + steps, device=dev)
    if mesh is None:
        @torch.no_grad()
        def prefill_fn():
            x = forward(model, prompt)
            return unembed(model.embed, cfg, x[:, -1:])[:, 0].float()

        def step_fn(tok, p, cache):
            logits, cache = decode_step(model, tok, p, cache)
            return logits.float(), cache
    else:
        pre, _, _, _, _ = build_prefill(cfg, mesh,
                                        ShapeCfg("p", s, b, "prefill"))
        dec, _, insh, _, _ = build_decode(
            cfg, mesh, ShapeCfg("d", s + steps, b, "decode"), sampler=None)
        cache = partition.place(mesh, cache,
                                {k: v.spec for k, v in insh[4].items()})

        def prefill_fn():
            return pre(model, {"tokens": prompt}).gather(dev)

        def step_fn(tok, p, cache):
            return dec(model, rng.PRNGKey(p), tok, p, cache)

    sync_cards(cards)
    t0 = time.perf_counter()
    pre_logits = prefill_fn()
    sync_cards(cards)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(pre_logits, -1).to(torch.int32)[:, None]
    toks, ms, first, copied = [], [], None, []
    state = ({tuple(blk.shape[1:]) for k in ("ssm_h", "ssm_conv")
              if k in cache for blk in cache[k].shards.values()}
             | {tuple(cache[k].shape[1:]) for k in ("ssm_h", "ssm_conv")
                if k in cache}) if mesh is not None else set()
    for i in range(steps):
        partition.reset_traffic()
        with copy_shapes() as shapes:
            t0 = time.perf_counter()
            logits, cache = step_fn(tok, s + i, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            sync_cards(cards)
            ms.append((time.perf_counter() - t0) * 1e3)
        copied.append({
            "pos": s + i, "crossed_bytes": partition.TRAFFIC["crossed_bytes"],
            "kinds": {k: list(v) for k, v in partition.KINDS.items()},
            "ssm_state_bytes": sum(n for shp, n in shapes if shp in state)})
        toks.append(tok[:, 0].tolist())
        if first is None:
            first = logits
    logits_ok = bool(torch.isfinite(pre_logits).all() and
                     torch.isfinite(first).all())
    if not logits_ok or pre_logits.shape != (b, cfg.vocab):
        raise AssertionError(f"lm_mesh_families {cfg.name}: bad logits")
    return {"prefill_ms": prefill_ms,
            "prefill_tok_s": b * s / prefill_ms * 1e3,
            "decode_ms": ms, "decode_step_ms": float(np.median(ms[1:])),
            "decode_tok_s": b * steps / sum(ms) * 1e3,
            "tokens": toks, "prefill_logits": pre_logits,
            "first_logits": first, "copied": copied}


@contextlib.contextmanager
def copy_shapes():
    """The shape and bytes of every copy between mesh positions counted
    in this block (``partition.observe_copies``)."""
    from repro_torch.sharding import partition

    seen = []

    def recording(t, src, dst, kind):
        seen.append((tuple(t.shape), t.numel() * t.element_size()))

    with partition.observe_copies(recording):
        yield seen


def check_decode_copies(cfg, mesh, serve: dict, batch: int,
                        cache_len: int) -> dict:
    """Every decode step of a ``family_serve`` run on ``mesh``: no copy
    of the SSM state between positions, and its copies and bytes between
    positions, kind by kind, equal to the dry run's of the same cell
    (``launch/dryrun.py``'s trace over ``meta`` devices at the cache's
    last position, in the same block of a cache split on positions as
    every step here), the new token's columns (segment "ssm_state")
    too; raises otherwise.  Returns a step's figures."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_lm_mesh

    d, m = mesh.shape["data"], mesh.shape["model"]
    rec = dryrun.trace_cell(
        cfg, make_lm_mesh(d, m, devices=[torch.device("meta")] * (d * m)),
        ShapeCfg("lm_mesh_families", cache_len, batch, "decode"))
    if rec["status"] != "ok":
        raise AssertionError(f"lm_mesh_families {cfg.name}: dry run {rec}")
    want = {k: [v["count"], v["bytes"]]
            for k, v in rec["collectives"].items() if v["count"]}
    seg = rec["segments"].get("ssm_state", {}).get("reshard", {})
    cols = seg.get("bytes", 0) * cfg.n_layers * d
    bad = []
    for c in serve["copied"]:
        if c["pos"] * m // cache_len != (cache_len - 1) * m // cache_len:
            raise AssertionError(f"decode position {c['pos']} is not in "
                                 f"the dry run's cache block")
        got = {}
        for (_, k), (n, nb) in c["kinds"].items():
            was = got.get(k, [0, 0])
            got[k] = [was[0] + n, was[1] + nb]
        if c["ssm_state_bytes"] or got != want or \
                c["kinds"].get(("ssm_state", "reshard"), [0, 0])[1] != cols:
            bad.append({"pos": c["pos"], "counted": got, "dry_run": want,
                        "ssm_state_bytes": c["ssm_state_bytes"]})
    if bad:
        raise AssertionError(f"lm_mesh_families {cfg.name}: decode copies "
                             f"!= the dry run's: {bad[:2]}")
    last = serve["copied"][-1]
    return {"ssm_state_bytes_a_step": last["ssm_state_bytes"],
            "crossed_bytes_a_step_counted": last["crossed_bytes"],
            "crossed_bytes_a_step_dry_run": rec["traffic"]["crossed_bytes"],
            "ssm_columns_bytes_a_step": cols,
            "by_kind": {f"{sg}/{k}": v for (sg, k), v in
                        sorted(last["kinds"].items())},
            "decode_step_ms": serve["decode_step_ms"],
            "decode_step_ms_before": LM_FAMILIES_DECODE_MS_BEFORE.get(
                cfg.name)}


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()) / \
        float(want.float().abs().max())


def serve_bound(cfg, batch: int, cache_len: int) -> dict:
    """A decode step's bytes bound (``lm_step_bytes`` of the model's
    shapes) and its matrix FLOPs at the bf16 peak."""
    from repro_torch.models.transformer import init_model

    meta = init_model(cfg, device="meta")
    nbytes = lm_step_bytes(meta, batch, cache_len)
    mat = sum(p.numel() for p in meta.parameters() if p.ndim >= 2)
    bound_ms, bound_by = roofline(nbytes, 2 * batch * mat, BF16_OPS_PER_S)
    return {"step_bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": bound_by}


def brief(serve: dict) -> dict:
    """A serving run's numbers without its tensors (the decode steps' ms
    as their quartiles and extremes)."""
    out = {k: v for k, v in serve.items() if k not in (
        "prefill_logits", "first_logits", "tokens", "decode_ms", "copied")}
    out["decode_ms_quantiles"] = np.quantile(
        serve["decode_ms"], [0, 0.25, 0.5, 0.75, 1]).tolist()
    return out


def lm_families_hybrid(devices) -> dict:
    """hymba-1.5b at full width: train steps on 1 x 1 and on 2 x 2 (times,
    peak memory, bytes between positions counted and reckoned, one
    profiled mesh step), then prefill and decode on 2 x 2 with the
    trained weights."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.launch.mesh import make_lm_mesh

    fam = LM_FAMILIES_MESH
    cfg = get_config(fam["hybrid"])
    run = LM_TRAIN_RUN
    steps = 1 + fam["timed_steps"]
    cards = sorted(set(devices), key=str)
    mesh = make_lm_mesh(*fam["shape"], devices=devices)
    peaks = {}
    for label, m in (("one", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        if m is None:
            state, _, recs1, _ = lm_train_steps(cfg, steps, devices[0])
            del state
        else:
            state, step_fn, recs, ds = lm_train_steps(cfg, steps, devices[0],
                                                      mesh=m)
        peaks[label] = max(torch.cuda.max_memory_allocated(c)
                           for c in cards) / 1e9
    batch = {k: torch.from_numpy(v).to(devices[0])
             for k, v in ds.batch_at(steps).items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        sync_cards(cards)
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    nmb = max(cfg.microbatch, 1)
    reckoned = hybrid_reckoned_bytes(cfg, mesh, run["batch"] // nmb, nmb,
                                     run["seq_len"])
    med = float(np.median([r["ms"] for r in recs[1:]]))
    med1 = float(np.median([r["ms"] for r in recs1[1:]]))
    counted = recs[-1]["crossed_bytes"]
    out = {"arch": cfg.name, "mesh": mesh.shape, "params": cfg.param_count(),
           "n_layers": cfg.n_layers, "depth_cut": None,
           "batch": run["batch"], "seq_len": run["seq_len"],
           "microbatch": cfg.microbatch, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "steps": recs,
           "one_device_steps": recs1, "median_step_ms": med,
           "one_device_median_step_ms": med1, "over_one_device": med / med1,
           "tok_s": run["batch"] * run["seq_len"] / med * 1e3,
           "bound": lm_train_bound(cfg, run["batch"] * run["seq_len"]),
           "peak_memory_gb": peaks["mesh"],
           "one_device_peak_memory_gb": peaks["one"],
           "state_gb_reckoned": cfg.param_count() * LM_TRAIN_STATE_BYTES
           / 1e9,
           "state_bytes_counted": placed_bytes(state),
           "crossed_bytes_counted": counted,
           "crossed_bytes_reckoned": reckoned,
           "counted_over_reckoned": counted / reckoned["total"],
           "profiled_step": {
               "wall_ms": prof_wall * 1e3, "busy_ms": busy_ms,
               "busy_share": busy_ms / (prof_wall * 1e3 * len(cards)),
               "launches": int(sum(e.count for e in kernels))}}
    b, s = fam["serve_batch"], fam["prompt_len"]
    prompt = rng.randint(rng.PRNGKey(1), (b, s), 0, cfg.vocab,
                         device=devices[0])
    serve = family_serve(state.model, mesh, prompt, fam["decode_steps"])
    out["serve"] = dict(brief(serve), **serve_bound(cfg, b, s + fam[
        "decode_steps"]))
    out["serve"]["decode_copies"] = check_decode_copies(
        cfg, mesh, serve, b, s + fam["decode_steps"])
    out["serve"]["step_over_bound"] = serve["decode_step_ms"] / \
        out["serve"]["bound_ms"]
    del state, step_fn, serve
    torch.cuda.empty_cache()
    return out


def lm_families_moe(devices) -> dict:
    """llama4-scout-17b-a16e served at full width, depth cut: on the card
    alone, then placed in place on the 2 x 2 mesh (experts 8 a "model"
    position); then the identity at 2 layers in float32."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.layers import drop_casts
    from repro_torch.models.transformer import init_model, place_model

    fam = LM_FAMILIES_MESH
    dev = devices[0]
    b, s, n = fam["serve_batch"], fam["prompt_len"], fam["decode_steps"]
    out = {}
    for label, layers, kw, steps in (
            ("served", fam["moe_layers"], {}, n),
            ("identity", fam["ident_layers"], {"dtype": "float32"},
             fam["ident_decode_steps"])):
        cfg = get_config(fam["moe"]).replace(n_layers=layers, **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = init_model(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
        prompt = rng.randint(rng.PRNGKey(1), (b, s), 0, cfg.vocab,
                             device=dev)
        one = family_serve(model, None, prompt, steps)
        peak1 = torch.cuda.max_memory_allocated(dev) / 1e9
        drop_casts(model)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = make_lm_mesh(*fam["shape"], devices=devices)
        place_model(mesh, model)
        got = family_serve(model, mesh, prompt, steps)
        res = {"n_layers": layers, "dtype": cfg.dtype,
               "params": cfg.param_count(),
               "one_device": brief(one), "mesh": brief(got),
               "one_device_peak_gb": peak1,
               "mesh_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "prefill_rel_err": rel_err(got["prefill_logits"],
                                          one["prefill_logits"]),
               "first_step_rel_err": rel_err(got["first_logits"],
                                             one["first_logits"]),
               "tokens_equal": got["tokens"] == one["tokens"],
               "experts_a_position": cfg.n_experts // fam["shape"][1]}
        if label == "served":
            res.update(serve_bound(cfg, b, s + n))
            res["step_over_bound"] = got["decode_step_ms"] / res["bound_ms"]
        elif not (res["prefill_rel_err"] <= LM_SERVE_MESH_TOL
                  and res["first_step_rel_err"] <= LM_SERVE_MESH_TOL
                  and res["tokens_equal"]):
            raise AssertionError(f"lm_mesh_families {cfg.name}: 2 x 2 != "
                                 f"1 x 1 at {layers} layers: {res}")
        out[label] = res
        del model, one, got
    torch.cuda.empty_cache()
    return out


def lm_families_ssm(devices) -> dict:
    """mamba2-130m at full width and depth in its config's bf16: a train
    step on 1 x 1 and on 2 x 2 from the same weights and batch, then the
    serving path on the card alone and on 2 x 2."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.layers import drop_casts
    from repro_torch.models.transformer import init_model, place_model

    fam = LM_FAMILIES_MESH
    cfg = get_config(fam["ssm"])
    dev = devices[0]
    st, _, recs1, _ = lm_train_steps(cfg, 1, dev)
    del st
    st, _, recs, _ = lm_train_steps(
        cfg, 1, dev, mesh=make_lm_mesh(*fam["shape"], devices=devices))
    del st
    loss_err = abs(recs[0]["loss"] - recs1[0]["loss"]) / abs(recs1[0]["loss"])
    b, s, n = fam["serve_batch"], fam["prompt_len"], fam["decode_steps"]
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    prompt = rng.randint(rng.PRNGKey(1), (b, s), 0, cfg.vocab, device=dev)
    one = family_serve(model, None, prompt, n)
    drop_casts(model)
    place_model(make_lm_mesh(*fam["shape"], devices=devices), model)
    got = family_serve(model, model.mesh, prompt, n)
    copies = check_decode_copies(cfg, model.mesh, got, b, s + n)
    out = {"arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "microbatch": cfg.microbatch,
           "step_ms": recs[0]["ms"], "one_device_step_ms": recs1[0]["ms"],
           "loss": recs1[0]["loss"], "loss_rel_err": loss_err,
           "crossed_bytes": recs[0]["crossed_bytes"],
           "one_device": brief(one), "mesh": brief(got),
           "prefill_rel_err": rel_err(got["prefill_logits"],
                                      one["prefill_logits"]),
           "first_step_rel_err": rel_err(got["first_logits"],
                                         one["first_logits"]),
           "tokens_agree": float(np.mean(np.array(got["tokens"]) ==
                                         np.array(one["tokens"]))),
           "decode_copies": copies, **serve_bound(cfg, b, s + n)}
    out["step_over_bound"] = got["decode_step_ms"] / out["bound_ms"]
    if not (loss_err <= LM_MESH_BF16["loss_rtol"]
            and out["prefill_rel_err"] <= LM_SSM_MESH_LOGIT_BF16
            and out["first_step_rel_err"] <= LM_SSM_MESH_LOGIT_BF16):
        raise AssertionError(f"lm_mesh_families {cfg.name}: 2 x 2 != 1 x 1: "
                             f"{out}")
    del model, one, got
    torch.cuda.empty_cache()
    return out


def phase_lm_mesh_families(card_name: str) -> dict:
    """The MoE, SSM and hybrid families on a "model" axis wider than one
    (LM_FAMILIES_MESH), over ``mesh_devices(4)``.  No kernel of the port
    is on this path: every launch count must stay 0 over it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model

    devices, kind = mesh_devices(int(np.prod(LM_FAMILIES_MESH["shape"])))
    zero_kernel_launch_counts()                      # the main path
    t0 = time.perf_counter()
    hybrid = lm_families_hybrid(devices)
    t1 = time.perf_counter()
    moe = lm_families_moe(devices)
    t2 = time.perf_counter()
    ssm = lm_families_ssm(devices)
    t3 = time.perf_counter()
    launches = kernel_launch_counts()
    if any(launches.values()):
        raise AssertionError(f"lm_mesh_families launched a kernel: "
                             f"{launches}")
    dev = devices[0]
    ident = {}
    for name, kw, tol in (("float32", {"dtype": "float32"}, LM_MESH_TOL),
                          ("bfloat16", {}, LM_MESH_BF16)):
        cfg = get_config(LM_FAMILIES_MESH["hybrid"]).replace(
            n_layers=LM_FAMILIES_MESH["ident_layers"], **kw)
        model = init_model(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
        batch = mesh_batch(cfg, 0, LM_TRAIN_RUN["batch"],
                           LM_TRAIN_RUN["seq_len"], dev)
        ident[name] = mesh_identity(
            cfg, model, (LM_FAMILIES_MESH["shape"], devices), batch, tol)
        del model
        torch.cuda.empty_cache()
    out = {"phase": "lm_mesh_families", "card": card_name,
           "devices": [str(x) for x in devices], "kind": kind,
           "hybrid": hybrid, "moe": moe, "ssm": ssm,
           "hybrid_identity": ident, "kernel_launches": launches,
           "seconds": {"hybrid": t1 - t0, "moe": t2 - t1, "ssm": t3 - t2,
                       "identity": time.perf_counter() - t3,
                       "total": time.perf_counter() - t0}}
    emit(out)
    return {"launches": 0, "kernel_launches": launches,
            "arch": hybrid["arch"], "mesh": hybrid["mesh"],
            "median_step_ms": hybrid["median_step_ms"],
            "one_device_median_step_ms":
                hybrid["one_device_median_step_ms"],
            "crossed_bytes_counted": hybrid["crossed_bytes_counted"],
            "crossed_bytes_reckoned":
                hybrid["crossed_bytes_reckoned"]["total"],
            "state_bytes_counted": hybrid["state_bytes_counted"],
            "llama4_decode_step_ms": moe["served"]["mesh"]["decode_step_ms"],
            "decode_copies": {
                "hymba-1.5b": hybrid["serve"]["decode_copies"],
                "mamba2-130m": ssm["decode_copies"]},
            "seconds": out["seconds"]["total"]}


def dot_counter():
    """A dispatch mode that counts (``.n``) the matrix products
    (``transformer.DOT_OPS``) dispatched while it is entered: a product
    the "dots" remat replays does not reach it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.transformer import DOT_OPS

    class DotCounter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in DOT_OPS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    return DotCounter()


def dot_ops_a_pass(model, mesh, batch, q_block: int) -> dict:
    """Matrix products dispatched by one microbatch's forward and by its
    backward (the remat's recompute included), under ``model.cfg``'s
    remat; the gradients are dropped after."""
    from repro_torch.models.transformer import mesh_loss, param_leaves
    from repro_torch.training.optimizer import as_list
    from repro_torch.training.train_step import split_batch

    nmb = max(model.cfg.microbatch, 1)
    run, shards = split_batch(mesh, batch, nmb)[0]
    with dot_counter() as fwd:
        loss = mesh_loss(model, run, shards, q_block)
    with dot_counter() as bwd:
        loss.backward()
    for p in param_leaves(model).values():
        for t in as_list(p):
            t.grad = None
    if not (fwd.n and bwd.n):
        raise AssertionError(f"lm_mesh_optim: no products counted "
                             f"({fwd.n}, {bwd.n})")
    return {"forward": fwd.n, "backward": bwd.n}


def lm_optim_dots(devices, kind: str, full: dict) -> dict:
    """phi4-mini-3.8b at full width on 2 x 2 with remat "dots": 1 warm-up
    and 2 timed steps through StepGuard, peak memory, the bytes a step
    between mesh positions, one profiled step's launches and busy share,
    beside lm_mesh's "full" figures (``full``) from this process."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import init_model, place_model
    from repro_torch.sharding import partition
    from repro_torch.training import DataConfig, StepGuard, TokenDataset
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    opt = LM_MESH_OPTIM
    dev = devices[0]
    cards = sorted(set(devices), key=str)
    cfg = get_config(LM_TRAIN_FULL).replace(remat="dots")
    run = LM_TRAIN_RUN
    q_block = min(run["seq_len"], 512)
    mesh = make_lm_mesh(*opt["shape"], devices=devices)
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    place_model(mesh, model)
    state = init_train_state(cfg, model)
    del model
    state_bytes = placed_bytes(state)
    step_fn, _ = make_train_step(cfg, q_block=q_block, mesh=mesh)
    ds = TokenDataset(DataConfig(cfg.vocab, run["seq_len"], run["batch"]))
    guard = StepGuard()
    recs = []
    for i in range(opt["warmup"] + opt["timed_steps"]):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch_at(i).items()}
        partition.reset_traffic()
        sync_cards(cards)
        t1 = time.perf_counter()
        state, mt = guard.run(step_fn, state, batch)
        sync_cards(cards)
        recs.append({"ms": (time.perf_counter() - t1) * 1e3,
                     "loss": float(mt["loss"]),
                     "grad_norm": float(mt["grad_norm"]),
                     "crossed_bytes": partition.TRAFFIC["crossed_bytes"],
                     "copies": partition.TRAFFIC["crossed_copies"]})
    if not np.isfinite([[r["loss"], r["grad_norm"]] for r in recs]).all():
        raise AssertionError(f"lm_mesh_optim dots: not finite: {recs}")
    if guard.retries or guard.reloads:
        raise AssertionError(f"lm_mesh_optim dots: {guard.retries} retries")
    peak = max(torch.cuda.max_memory_allocated(c) for c in cards)
    med = float(np.median([r["ms"] for r in recs[opt["warmup"]:]]))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ds.batch_at(len(recs)).items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, mt = step_fn(state, batch)
        sync_cards(cards)
        prof_wall = time.perf_counter() - t1
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {"arch": cfg.name, "mesh": mesh.shape, "kind": kind,
           "remat": cfg.remat, "optimizer": cfg.optimizer,
           "microbatch": cfg.microbatch, "batch": run["batch"],
           "seq_len": run["seq_len"], "steps": recs,
           "median_step_ms": med, "full_median_step_ms":
               full["median_step_ms"],
           "over_full": med / full["median_step_ms"],
           "peak_memory_gb": peak / 1e9,
           "full_peak_memory_gb": full["peak_memory_gb"],
           "peak_over_full_gb": peak / 1e9 - full["peak_memory_gb"],
           "peak_memory_bytes": peak, "state_bytes_counted": state_bytes,
           "crossed_bytes_counted": recs[-1]["crossed_bytes"],
           "full_crossed_bytes_counted": full["crossed_bytes_counted"],
           "profiled_step": {
               "wall_ms": prof_wall * 1e3, "busy_ms": busy_ms,
               "busy_share": busy_ms / (prof_wall * 1e3 * len(cards)),
               "launches": int(sum(e.count for e in kernels)),
               "full_launches": full["launches_a_step"],
               "full_busy_share": full["busy_share"]}}
    del state, step_fn, batch, mt
    torch.cuda.empty_cache()
    return out


def lm_optim_dots_identity(devices) -> dict:
    """phi4-mini-3.8b at full width cut to LM_MESH_OPTIM["ident_layers"],
    bf16, on 2 x 2: the matrix products one microbatch dispatches forward
    and backward, then one train step, with remat "dots" and with "full"
    from the same state and batch; the loss, the grad norm and every
    parameter after the step must be equal bit for bit."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import (
        init_model, param_leaves, place_model)
    from repro_torch.sharding import partition
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    opt = LM_MESH_OPTIM
    dev = devices[0]
    cfg = get_config(LM_TRAIN_FULL).replace(n_layers=opt["ident_layers"])
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    batch = mesh_batch(cfg, 0, LM_TRAIN_RUN["batch"],
                       LM_TRAIN_RUN["seq_len"], dev)
    q_block = min(LM_TRAIN_RUN["seq_len"], 512)
    got, products = {}, {}
    for remat in ("full", "dots"):
        c = cfg.replace(remat=remat)
        m = copy.deepcopy(model)
        m.cfg = c
        mesh = make_lm_mesh(*opt["shape"], devices=devices)
        place_model(mesh, m)
        products[remat] = dot_ops_a_pass(m, mesh, batch, q_block)
        st = init_train_state(c, m)
        st, mt = make_train_step(c, q_block=q_block, mesh=mesh)[0](st, batch)
        got[remat] = (mt["loss"], mt["grad_norm"],
                      {k: partition.gather(v, dev).detach()
                       for k, v in param_leaves(st.model).items()})
        del st, m
    (l1, n1, p1), (l2, n2, p2) = got["full"], got["dots"]
    unequal = [k for k in p1 if not torch.equal(p1[k], p2[k])]
    res = {"n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "loss": float(l1), "loss_equal": bool(torch.equal(l1, l2)),
           "grad_norm_equal": bool(torch.equal(n1, n2)),
           "params_unequal": unequal, "leaves": len(p1),
           "dot_ops_a_microbatch": products}
    del got, model, p1, p2
    torch.cuda.empty_cache()
    if not (res["loss_equal"] and res["grad_norm_equal"] and not unequal):
        raise AssertionError(f"lm_mesh_optim: dots != full at "
                             f"{cfg.n_layers} layers: {res}")
    return res


def adafactor_reckoned_bytes(params, state) -> dict:
    """The bytes Adafactor's update must copy between mesh positions,
    from the layouts, block pair by block pair: each gradient block's
    partial row (column) sums to every ``vr`` (``vc``) block at another
    position that holds some of its rows (columns), and the
    preconditioner's slices back; each ``vr`` block's partial row sums of
    ``vr2`` to every ``vr`` block at another position sharing its rows;
    an unfactored leaf's moments to the gradient's blocks and back (the
    statistics); a sum of squares a gradient block to the first position,
    the clip's root back to each of its positions, the clip scale and
    beta (8 bytes) once to each position that uses them (the scalars).
    Beside them, what the whole-leaf update on the first device moved:
    every block elsewhere of the gradient, the parameter and both
    moments gathered, and the parameter and the moments written back."""
    import math

    def blocks(leaf):
        if isinstance(leaf, list):
            return [(((i, i + 1),) + x.box(c), x.position(c),
                     x.dtype.itemsize)
                    for i, x in enumerate(leaf) for c in x.coords()]
        return [(leaf.box(c), leaf.position(c), leaf.dtype.itemsize)
                for c in leaf.coords()]

    def overlap(a, b) -> int:
        return math.prod(max(0, min(x1, y1) - max(x0, y0))
                         for (x0, x1), (y0, y1) in zip(a, b))

    def vol(box) -> int:
        return math.prod(b - a for a, b in box)

    home = None
    stats = scalars = gathered = 0
    needed = set()
    for key, p in params.items():
        G, V, C = blocks(p), blocks(state.vr[key]), blocks(state.vc[key])
        home = home or tuple(0 for _ in G[0][1])
        here = {pos for _, pos, _ in G + V + C}
        if len(here) == 1:
            continue
        if len(G[0][0]) >= 2:
            needed |= here
            for bk, pk, _ in G:
                for bv, pv, _ in V:
                    if pv != pk:
                        stats += 2 * 4 * overlap(bk[:-1], bv)
                for bc, pc, _ in C:
                    if pc != pk:
                        stats += 2 * 4 * overlap(bk[:-2] + bk[-1:], bc)
            for ba, pa, _ in V:
                for bb, pb, _ in V:
                    if pa != pb:
                        stats += 4 * overlap(ba[:-1], bb[:-1])
        else:
            needed |= {pos for _, pos, _ in G}
            for bk, pk, _ in G:
                for bv, pv, _ in V:
                    if pv != pk:
                        stats += 2 * 4 * overlap(bk, bv)
        scalars += 4 * sum(pk != home for _, pk, _ in G)
        scalars += 4 * len({pk for _, pk, _ in G} - {home})
        gathered += sum(vol(b) * 3 * n for b, pk, n in G if pk != home)
        gathered += sum(2 * vol(b) * n for b, pk, n in V + C if pk != home)
    scalars += 8 * len(needed - {home})
    return {"statistics": stats, "scalars": scalars,
            "total": stats + scalars, "gathered_update": gathered}


def lm_optim_moe(devices) -> dict:
    """grok-1-314b at full width cut to LM_MESH_OPTIM["moe_layers"] layer:
    trained with its config's settings on 1 x 1 and then on 2 x 2 from the
    same seeded weights and batches; each run's step and Adafactor update
    timed, the timed step's peak memory; the 2 x 2 update's bytes between
    positions (segment "optimizer") counted against the reckoning.  After
    the first step, against LM_MESH_BF16 (:func:`moe_identity_failures`
    holds it): the 2 x 2 loss and grad norm against 1 x 1's, and the 2 x 2
    update given 1 x 1's gradients from the same initial state against
    1 x 1's parameters (the update alone, :func:`moe_update_alone`); the
    whole steps' gradients and parameters are measured against the same
    bounds and reported (:func:`leaf_excess`): in bf16 the router's top-2
    is a discrete function of activations that the two layouts round
    differently, so a whole step's gradients may differ past any
    rounding bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import (
        init_model, param_leaves, place_model)
    from repro_torch.sharding import partition
    from repro_torch.training import DataConfig, TokenDataset
    from repro_torch.training.optimizer import Adafactor, leaf_shape
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    opt = LM_MESH_OPTIM
    tol = LM_MESH_BF16
    dev = devices[0]
    cards = sorted(set(devices), key=str)
    full_cfg = get_config(opt["moe"])
    cfg = full_cfg.replace(n_layers=opt["moe_layers"],
                           microbatch=opt["moe_microbatch"])
    run = LM_TRAIN_RUN
    ds = TokenDataset(DataConfig(cfg.vocab, run["seq_len"], run["batch"]))
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "reduced": {"n_layers": [full_cfg.n_layers, cfg.n_layers],
                       "microbatch": [full_cfg.microbatch, cfg.microbatch]},
           "optimizer": cfg.optimizer, "param_dtype": cfg.param_dtype,
           "batch": run["batch"], "seq_len": run["seq_len"]}
    kept, grads1 = {}, {}
    for label, shape in (("one", None), ("mesh", opt["shape"])):
        torch.cuda.empty_cache()
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        mesh = (None if shape is None
                else make_lm_mesh(*shape, devices=devices))
        model = init_model(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
        if mesh is not None:
            place_model(mesh, model)
        state = init_train_state(cfg, model)
        del model
        step_fn, optim = make_train_step(cfg, q_block=run["seq_len"],
                                         mesh=mesh)
        update, times, res = optim.update, [], {}

        def timed(grads, st, params, update=update, times=times, res=res,
                  label=label):
            if not times:             # the first step's gradients
                if label == "one":
                    grads1.update(host_leaves(grads))
                else:
                    res["whole_step_grads"] = leaf_excess(
                        grads, grads1, dev, relative=tol["grad_tol"])
            sync_cards(cards)
            t = time.perf_counter()
            r = update(grads, st, params)
            sync_cards(cards)
            times.append((time.perf_counter() - t) * 1e3)
            return r

        optim.update = timed
        recs = []
        for i in range(1 + opt["moe_steps"]):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in ds.batch_at(i).items()}
            partition.reset_traffic()
            sync_cards(cards)
            if i:                      # the timed step's peak alone
                for c in cards:
                    torch.cuda.reset_peak_memory_stats(c)
            t1 = time.perf_counter()
            state, mt = step_fn(state, batch)
            sync_cards(cards)
            recs.append({
                "ms": (time.perf_counter() - t1) * 1e3,
                "update_ms": times[-1], "loss": float(mt["loss"]),
                "grad_norm": float(mt["grad_norm"]),
                "crossed_bytes": partition.TRAFFIC["crossed_bytes"],
                "optimizer_bytes": sum(
                    b for (seg, _), (_, b) in partition.KINDS.items()
                    if seg == "optimizer")})
            if i:
                continue
            leaves = param_leaves(state.model)
            if label == "one":
                kept.update(host_leaves(leaves))
                continue
            res["whole_step_params"] = leaf_excess(leaves, kept, dev)
            reckoned = adafactor_reckoned_bytes(leaves, state.opt)
            traffic = Adafactor().traffic(mesh, {
                k: (leaf_shape(v), partition.stacked_spec(v),
                    isinstance(v, list)) for k, v in leaves.items()})
            res.update(
                mesh=mesh.shape, experts_a_position=cfg.n_experts // shape[1],
                optimizer_bytes_counted=recs[0]["optimizer_bytes"],
                optimizer_bytes_reckoned=reckoned,
                optimizer_bytes_traffic_fn=sum(
                    b for _, b in traffic.values()))
            if not (reckoned["total"] == recs[0]["optimizer_bytes"]
                    == res["optimizer_bytes_traffic_fn"]):
                raise AssertionError(f"lm_mesh_optim {cfg.name}: optimizer "
                                     f"bytes {res}")
            del leaves
        peak = max(torch.cuda.max_memory_allocated(c) for c in cards)
        if not np.isfinite([[r["loss"], r["grad_norm"]] for r in recs]).all():
            raise AssertionError(f"lm_mesh_optim {cfg.name} {label}: not "
                                 f"finite: {recs}")
        res.update(steps=recs, step_ms=recs[-1]["ms"],
                   update_ms=recs[-1]["update_ms"],
                   peak_memory_gb=peak / 1e9, peak_memory_bytes=peak)
        out[label] = res
        del state, step_fn, optim, batch, mt
        torch.cuda.empty_cache()
    one, got = out["one"]["steps"][0], out["mesh"]["steps"][0]
    out["identity"] = {
        "loss_rel_err": abs(got["loss"] - one["loss"]) / abs(one["loss"]),
        "grad_norm_rel_err": abs(got["grad_norm"] - one["grad_norm"])
        / abs(one["grad_norm"]),
        "update_alone": moe_update_alone(cfg, devices, grads1, kept),
        "whole_step_grads": out["mesh"].pop("whole_step_grads"),
        "whole_step_params": out["mesh"].pop("whole_step_params"),
        "tolerance": tol}
    out["peak_one_over_mesh"] = (out["one"]["peak_memory_bytes"]
                                 / out["mesh"]["peak_memory_bytes"])
    return out


def moe_identity_failures(ident: dict) -> list:
    """What of :func:`lm_optim_moe`'s identity is outside LM_MESH_BF16:
    the first step's loss and grad norm, and the update alone."""
    tol = ident["tolerance"]
    bad = []
    if ident["loss_rel_err"] > tol["loss_rtol"]:
        bad.append("loss")
    if ident["grad_norm_rel_err"] > tol["grad_tol"]:
        bad.append("grad_norm")
    if ident["update_alone"]["outside"]:
        bad.append("update_alone")
    return bad


def host_leaves(leaves: dict) -> dict:
    """Each leaf whole on the host, a copy (not a live tensor)."""
    import torch

    from repro_torch.sharding import partition

    return {k: v.detach().to("cpu", copy=True)
            if isinstance(v, torch.Tensor)
            else partition.gather(v, "cpu").detach()
            for k, v in leaves.items()}


def leaf_excess(leaves: dict, want: dict, dev, relative=None) -> dict:
    """Each leaf of ``leaves`` (placed or not) against ``want`` (whole, on
    the host), in slices on the card: within LM_MESH_BF16's parameter
    bound (``param_tol`` plus one bf16 step of |want|), or with
    ``relative`` within ``(relative + 2**-7)`` of the leaf's largest
    |want| (its gradient bound).  Returns the leaves outside, each
    leaf's largest |difference| and the largest excess over the bound,
    and the elements outside it."""
    from repro_torch.sharding import partition

    bf = 2.0 ** -7
    res = {"outside": [], "max_abs_diff": {}, "max_excess": -float("inf"),
           "elements_outside": 0, "elements": 0}
    step = 1 << 26
    for k, v in leaves.items():
        got = partition.gather(v, dev).detach().reshape(-1)
        ref = want[k].reshape(-1)
        scale = (None if relative is None
                 else (relative + bf) * float(ref.float().abs().max()))
        worst = 0.0
        for lo in range(0, got.numel(), step):
            a = got[lo:lo + step].float()
            b = ref[lo:lo + step].to(dev).float()
            d = (a - b).abs_()
            lim = (b.abs_().mul_(bf).add_(LM_MESH_BF16["param_tol"])
                   if scale is None else scale)
            worst = max(worst, float(d.max()))
            res["max_excess"] = max(res["max_excess"], float((d - lim).max()))
            n = int((d > lim).sum())
            res["elements_outside"] += n
            if n and k not in res["outside"]:
                res["outside"].append(k)
        res["elements"] += got.numel()
        res["max_abs_diff"][k] = worst
        del got
    return res


def moe_update_alone(cfg, devices, grads1: dict, kept: dict) -> dict:
    """Adafactor's update where its blocks lie, alone: the 2 x 2 state
    from the same seeded weights, given the 1 x 1 run's first gradients
    (``grads1``, placed as the parameters are), against the 1 x 1 run's
    parameters after that step (``kept``) within LM_MESH_BF16."""
    import torch

    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import (
        init_model, param_leaves, place_model)
    from repro_torch.sharding import partition
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import init_train_state

    dev = devices[0]
    mesh = make_lm_mesh(*LM_MESH_OPTIM["shape"], devices=devices)
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    place_model(mesh, model)
    state = init_train_state(cfg, model)
    del model
    params = param_leaves(state.model)
    grads = {}
    for k, p in params.items():
        g = grads1[k].to(dev)
        grads[k] = ([partition.Sharded.place(mesh, g[i], x.spec)
                     for i, x in enumerate(p)] if isinstance(p, list)
                    else partition.Sharded.place(mesh, g, p.spec))
        del g
    torch.cuda.synchronize()
    t = time.perf_counter()
    with partition.segment("optimizer"):
        make_optimizer(cfg).update(grads, state.opt, params)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    del grads
    res = leaf_excess(params, kept, dev)
    res["update_ms"] = ms
    del state, params
    torch.cuda.empty_cache()
    return res


def phase_lm_mesh_optim(card_name: str, full: dict) -> dict:
    """The "dots" remat and Adafactor's update where its blocks lie on a
    ("data", "model") mesh over ``mesh_devices(4)`` (LM_MESH_OPTIM); the
    dots step's bytes between positions held against its dry run.  One
    JSON line for each half as it ends, then the phase's.  No kernel of
    the port is on this path: every launch count must stay 0 over it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_lm_mesh

    opt = LM_MESH_OPTIM
    devices, kind = mesh_devices(int(np.prod(opt["shape"])))
    zero_kernel_launch_counts()                      # the main path
    t0 = time.perf_counter()
    dots = lm_optim_dots(devices, kind, full)
    dots["identity"] = lm_optim_dots_identity(devices)
    d, m = opt["shape"]
    rec = dryrun.trace_cell(
        get_config(LM_TRAIN_FULL).replace(remat="dots"),
        make_lm_mesh(d, m, devices=[torch.device("meta")] * (d * m)),
        ShapeCfg("lm_mesh_optim", LM_TRAIN_RUN["seq_len"],
                 LM_TRAIN_RUN["batch"], "train"), trainer=True)
    if rec["status"] != "ok":
        raise AssertionError(f"lm_mesh_optim dry run: {rec}")
    counted = dots["crossed_bytes_counted"]
    traced = rec["traffic"]["crossed_bytes"]
    dots["dryrun"] = {
        "crossed_bytes_traced": traced, "bytes_rel_err":
        abs(traced - counted) / counted, "trace_s": rec["t_trace_s"],
        "temp_bytes_max": rec["memory"]["temp_bytes"],
        "measured_peak_less_state":
            dots["peak_memory_bytes"] - dots["state_bytes_counted"]}
    t1 = time.perf_counter()
    emit({"phase": "lm_mesh_optim_dots", "card": card_name,
          "devices": [str(x) for x in devices], **dots,
          "seconds": t1 - t0})
    if dots["dryrun"]["bytes_rel_err"] > LM_DRYRUN["bytes_rtol"]:
        raise AssertionError(f"lm_mesh_optim: dry run traced {traced} bytes "
                             f"between positions, the dots step counted "
                             f"{counted}")
    moe = lm_optim_moe(devices)
    t2 = time.perf_counter()
    emit({"phase": "lm_mesh_optim_moe", "card": card_name, **moe,
          "seconds": t2 - t1})
    bad = moe_identity_failures(moe["identity"])
    if bad:
        raise AssertionError(f"lm_mesh_optim {moe['arch']}: 2 x 2 != 1 x 1 "
                             f"({bad}): {moe['identity']}")
    launches = kernel_launch_counts()
    out = {"phase": "lm_mesh_optim", "card": card_name, "kind": kind,
           "kernel_launches": launches,
           "seconds": {"dots": t1 - t0, "moe": t2 - t1, "total": t2 - t0}}
    emit(out)
    if any(launches.values()):
        raise AssertionError(f"lm_mesh_optim launched a kernel: {launches}")
    if out["seconds"]["total"] > opt["seconds"]:
        raise AssertionError(f"lm_mesh_optim took "
                             f"{out['seconds']['total']:.1f} s")
    return {"launches": 0, "kernel_launches": launches,
            "dots_median_step_ms": dots["median_step_ms"],
            "dots_peak_memory_gb": dots["peak_memory_gb"],
            "moe_step_ms": moe["mesh"]["step_ms"],
            "moe_peak_memory_gb": {"one": moe["one"]["peak_memory_gb"],
                                   "mesh": moe["mesh"]["peak_memory_gb"]},
            "seconds": out["seconds"]["total"]}


def phase_lm_dryrun(card_name: str, mesh_run: dict, families: dict) -> dict:
    """The dry run of lm_mesh's configuration over four ``meta``
    devices against what phase lm_mesh measured in this process: the
    bytes between mesh positions (within LM_DRYRUN["bytes_rtol"]), the
    arguments' bytes (equal to the placed state's), the transients
    beside the measured peak less the state (printed); the same for
    hymba-1.5b's 2 x 2 step against phase lm_mesh_families' count; then
    phi4-mini's production cells on 16 x 16.  No kernel launches."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_lm_mesh

    zero_kernel_launch_counts()                      # the main path
    t0 = time.perf_counter()
    cfg = get_config(LM_TRAIN_FULL)
    run = LM_TRAIN_RUN
    d, m = LM_MESH["shape"]
    mesh = make_lm_mesh(d, m, devices=[torch.device("meta")] * (d * m))
    rec = dryrun.trace_cell(
        cfg, mesh, ShapeCfg("lm_mesh", run["seq_len"], run["batch"], "train"),
        trainer=True)
    if rec["status"] != "ok":
        raise AssertionError(f"lm_dryrun: {rec}")
    counted = mesh_run["crossed_bytes_counted"]
    traced = rec["traffic"]["crossed_bytes"]
    bytes_err = abs(traced - counted) / counted
    args_sum = rec["memory"]["argument_bytes_sum"]
    state = mesh_run["state_bytes_counted"]
    out = {"phase": "lm_dryrun", "arch": cfg.name, "card": card_name,
           "mesh": dict(mesh.shape), "trace_s": rec["t_trace_s"],
           "crossed_bytes_traced": traced,
           "crossed_bytes_counted": counted,
           "crossed_bytes_reckoned": mesh_run["crossed_bytes_reckoned"],
           "bytes_rel_err": bytes_err,
           "collectives": rec["collectives"], "scale": rec["scale"],
           "argument_bytes_sum": args_sum, "state_bytes_counted": state,
           "argument_bytes_max": rec["memory"]["argument_bytes"],
           "temp_bytes_max": rec["memory"]["temp_bytes"],
           "temp_bytes_sum": rec["memory"]["temp_bytes_sum"],
           "measured_peak_bytes": mesh_run["peak_memory_bytes"],
           "measured_peak_less_state": mesh_run["peak_memory_bytes"] - state}
    if bytes_err > LM_DRYRUN["bytes_rtol"]:
        raise AssertionError(f"lm_dryrun: traced {traced} bytes between "
                             f"mesh positions, the step counted {counted}")
    if args_sum != state:
        raise AssertionError(f"lm_dryrun: argument bytes {args_sum} != the "
                             f"placed state's {state}")
    hcfg = get_config(LM_FAMILIES_MESH["hybrid"])
    rec = dryrun.trace_cell(
        hcfg, mesh, ShapeCfg("lm_mesh_families", run["seq_len"],
                             run["batch"], "train"), trainer=True)
    if rec["status"] != "ok":
        raise AssertionError(f"lm_dryrun {hcfg.name}: {rec}")
    counted = families["crossed_bytes_counted"]
    traced = rec["traffic"]["crossed_bytes"]
    out["hybrid"] = {
        "arch": hcfg.name, "trace_s": rec["t_trace_s"],
        "crossed_bytes_traced": traced, "crossed_bytes_counted": counted,
        "crossed_bytes_reckoned": families["crossed_bytes_reckoned"],
        "bytes_rel_err": abs(traced - counted) / counted,
        "collectives": rec["collectives"],
        "argument_bytes_sum": rec["memory"]["argument_bytes_sum"],
        "state_bytes_counted": families["state_bytes_counted"],
        "temp_bytes_sum": rec["memory"]["temp_bytes_sum"]}
    if out["hybrid"]["bytes_rel_err"] > LM_DRYRUN["bytes_rtol"]:
        raise AssertionError(f"lm_dryrun {hcfg.name}: traced {traced} bytes "
                             f"between mesh positions, the step counted "
                             f"{counted}")
    if rec["memory"]["argument_bytes_sum"] != families["state_bytes_counted"]:
        raise AssertionError(f"lm_dryrun {hcfg.name}: argument bytes != the "
                             f"placed state's: {out['hybrid']}")
    cells = {}
    for shape in SHAPES:
        r = dryrun.run_cell(cfg.name, shape.name, multi_pod=False,
                            out_dir=None)
        cells[shape.name] = {"status": r["status"]}
        if r["status"] == "ok":
            cells[shape.name].update(
                gb_per_device=r["memory"]["total_per_device"] / 1e9,
                fits_80gb=r["memory"]["fits_80gb"],
                bottleneck=r["roofline"]["bottleneck"],
                roofline_fraction=r["roofline"]["roofline_fraction"],
                trace_s=r["t_trace_s"])
        elif r["status"] == "skipped":
            cells[shape.name]["reason"] = r["reason"]
        else:
            raise AssertionError(f"lm_dryrun {shape.name}: {r['error']}")
    out["production_16x16"] = cells
    launches = kernel_launch_counts()
    out["kernel_launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if any(launches.values()):
        raise AssertionError(f"lm_dryrun launched a kernel: {launches}")
    if out["seconds"] > LM_DRYRUN["seconds"]:
        raise AssertionError(f"lm_dryrun took {out['seconds']:.1f} s")
    return {"launches": 0, "kernel_launches": launches,
            "bytes_rel_err": bytes_err, "seconds": out["seconds"]}


def kernel_entry(name: str, source: str, replaces: str, res: dict) -> dict:
    """One kernel's entry of the per-kernel JSON line."""
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{source}",
             "replaces": replaces, "library_ms": None}
    entry.update(res)
    return entry


def main() -> int:
    setup_path()
    import torch

    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "cuda_available": torch.cuda.is_available()})
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda."
                         "is_available() is false)")
    smi = nvidia_smi()
    card_name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": card_name, "nvidia_smi": smi,
          "count": torch.cuda.device_count()})
    device = torch.device("cuda")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"library": os.path.basename(
              _build.library_path(name)), "seconds": sec}
              for name, sec in seconds.items()}})

    laps, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    check = phase_kernel_vs_plain(device)
    lap("kernel_vs_plain")
    serve = phase_serve(card_name)
    serve_cold = serve.pop("cold")
    rec = serve.pop("record")
    main_path = phase_main_path_kernel(rec)
    rec["calls"].clear()            # free the recorded tensors
    traffic = serve["traffic"]
    del serve
    torch.cuda.empty_cache()
    paths = {"bn_serve": path_entry(rec, main_path)}
    lap("serve")
    mrf = phase_mrf_gibbs(card_name)
    paths["mrf_gibbs"] = mrf["aia-mrf-penguin"]
    paths["mrf_gibbs_art"] = mrf["aia-mrf-art"]
    lap("mrf_gibbs")
    paths["mesh_gibbs"] = phase_mesh_gibbs(card_name, *mesh_devices(
        MESH_GIBBS["rows"] * MESH_GIBBS["cols"]))
    lap("mesh_gibbs")
    phase_metropolis(card_name)
    lap("metropolis")
    paths["serve_mrf"] = phase_serve_mrf(card_name)
    paths["serve_ising"] = phase_serve_ising(card_name)
    lap("serve_mrf_ising")
    paths["serve_queue"] = phase_serve_queue(card_name, traffic, serve_cold)
    lap("serve_queue")
    devices, kind = mesh_devices(SHARD_WAYS)
    emit({"phase": "mesh_devices", "devices": [str(d) for d in devices],
          "kind": kind, "cards": torch.cuda.device_count()})
    sharded = phase_serve_sharded(card_name, devices, kind, traffic,
                                  serve_cold)
    paths["serve_sharded"] = sharded["bn"]
    paths["serve_sharded_grids"] = sharded["grids"]
    del serve_cold
    lap("serve_sharded")
    paths["serve_model_axis"], paths["serve_model_axis_bn"] = \
        phase_serve_model_axis(card_name, devices, kind)
    lap("serve_model_axis")
    paths["serve_stream"] = phase_serve_stream(card_name)
    lap("serve_stream")
    paths["serve_wire"] = phase_serve_wire(card_name)
    lap("serve_wire")
    ky = phase_ky_sampler(device)
    iu = phase_interp_lut(device)
    flash = phase_flash_attention(device)
    lap("ky_iu_flash")
    paths["lm_generate"] = phase_lm_generate(card_name)
    lap("lm_generate")
    paths["lm_train"] = phase_lm_train(card_name)
    lap("lm_train")
    paths["lm_mesh"] = phase_lm_mesh(card_name, paths["lm_train"])
    lap("lm_mesh")
    paths["lm_mesh_families"] = phase_lm_mesh_families(card_name)
    lap("lm_mesh_families")
    paths["lm_mesh_optim"] = phase_lm_mesh_optim(card_name,
                                                 paths["lm_mesh"])
    lap("lm_mesh_optim")
    paths["lm_dryrun"] = phase_lm_dryrun(card_name, paths["lm_mesh"],
                                         paths["lm_mesh_families"])
    lap("lm_dryrun")
    emit({"phase": "timing", "seconds": laps,
          "total_after_build": sum(laps.values())})
    emit({"kernels": [{
        "name": "fused_gibbs_sample",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sweep.cu",
        "replaces": "src/repro/kernels/fused_sweep.py:71",
        "launches": sum(p["launches"] for p in paths.values()),
        "max_abs_err": max(check["max_abs_err"],
                           *(p["max_abs_err"] for p in paths.values()
                             if p["launches"])),
        "library_ms": None,
        **{k: main_path[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "call_ms", "words_ms",
            "shapes")},
        "launches_per_round": sorted(rec["per_round"].items()),
        "paths": paths,
    }, kernel_entry("ky_sampler", "ky_sampler.cu",
                    "src/repro/kernels/ky_sampler.py:45", ky),
        kernel_entry("interp_lut", "interp_lut.cu",
                     "src/repro/kernels/interp_lut.py:31", iu),
        kernel_entry("flash_attention_tc", "flash_attention_tc.cu",
                     "src/repro/kernels/flash_attention.py:26", flash["tc"]),
        kernel_entry("flash_attention_simt", "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:26",
                     flash["simt"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
