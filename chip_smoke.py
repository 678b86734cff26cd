#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build every hand-written kernel from the checkout's sources (``nvcc``
   for ``sm_90a`` into ``build/repro_torch/``) and print the build time and
   the compiler's register/shared-memory report;
3. hold ``pair_score`` against its plain PyTorch version on the card, at
   the main path's shapes and ``PAIR_SCORE_SIZES``, without and with the
   fused cost preparation (2e-5 abs/rel, sentinels and idle edges exact);
4. fit the ``SYNPA4_R-FEBE`` Eq. 4 model with the port's own profiling
   campaign (default campaign, ``MachineParams()``, machine seed 0);
5. a small race (N = 16) on the card against the same race on the CPU,
   both fed the same draws: the reference check of the whole path;
6. the main path: the cluster-scale closed race, N = 1024 applications
   (``scaled_workload(1024, seed=1024)``), 8 quanta, seed 3, policies
   ``linux``/``random``/``synpa4``, through ``run_quanta_scan``, with every
   kernel's launch count set to 0 just before and read just after; then an
   audit of the host synchronisations of one race, its per-quantum wall
   time (median of 3 timed runs after one warm run), a profiler
   breakdown of one race by kernel, a timing of each layer, and Step 2
   plus the matcher's cost preparation as the fused step ran it before the
   fusion (the unfused kernel and eleven tensor ops) against the one fused
   launch: kernels and device time under the profiler;
7. ``pair_score``'s time at the main path's shape, unfused and fused
   (CUDA events, and the kernel alone under the profiler), beside its
   plain version's time and the card's bound for the same work;
8. the serving kernels (``flash_attention``, ``decode_attention``,
   ``rmsnorm``) against their plain versions on the card, at the reference
   tests' shapes and the serving path's (1e-4 abs/rel in float32, 2e-2 in
   bfloat16), flash attention at the shapes the vlm, audio, gemma,
   starcoder2, hymba and kimi main paths give it (``FLASH_PATH_SHAPES``,
   both types; windows of 4096 and 2048, kimi-k2's D 112 through the
   wrapper's zero-padded copies) and at the edges of its tensor-core
   design (``FLASH_EDGES``, both types; rows that see no key exactly 0);
   inputs drawn on the card;
9. the serving path's reference check, card against CPU: qwen1.5-0.5b at
   full width and depth 2, the same seeded weights on both: prefill logits
   of 1 x 256 tokens and the logits after 16 decode steps (1e-4 of the
   largest |logit|), and greedy ``generate`` tokens (identical);
10. the serving main path: qwen1.5-0.5b at full width and depth (24
   layers, float32, ``attention_impl="kernel"``), ``ServeEngine.prefill``
   of 4 x 2048 tokens (exactly 24 ``flash_attention`` launches) and
   ``serve_demo`` at its defaults (12 requests x 16 tokens), with every
   kernel's launch count set to 0 just before and read just after; then
   the prefill and decode-step wall times and a profiler breakdown of each;
11. each serving kernel's time at the path's shapes beside its plain
   version's, the card's bound and one PyTorch call's (used nowhere in the
   port) for the same work.  Flash attention's bound counts its float32
   products as three TF32 products on the tensor cores (495 TFLOP/s); the
   float32 SIMT bound of the earlier design is printed beside it, the
   SDPA backend that ran the yardstick is named by its kernels, the
   pre-pass and the attention kernel are timed apart under the profiler,
   and the bfloat16 kernel is timed at the same shape; then flash
   attention at ``FLASH_PATH_SHAPES`` in both types beside its plain
   version, its bound (the pairs the mask keeps) and SDPA with the same
   mask (``is_causal``, or a boolean window mask) and ``enable_gqa``, the
   zero-padded copies at D 112 timed apart;
12. the open system's reference check, card against CPU: ``ClusterSim``
   with ``engine="scan"`` at capacity 16 (15 jobs at quantum 0, then 3 at
   every odd quantum), policies ``adjacent``, ``synpa4`` with fifo and
   with synergy admission, and ``synpa4`` under a crash wave, both sides
   fed the same draws and the same synergy tables: admission quanta,
   queue depths, active and solo counts, retries, evictions and requeues
   identical, finish quanta within 1e-4; the synergy pool cost card
   against CPU (2e-5), and ``torch.argmin`` taking the first of tied
   minima on the card;
13. the open main path: ``record_device_ab``'s large cell of
   ``benchmarks/online_churn.py`` (capacity 1024, rho = 1.0, 24 quanta,
   seed 11, ``pool_profiles()``, target scale 0.25): ``adjacent``,
   ``synpa4`` with fifo and with synergy admission, and ``synpa4`` under
   the ``combined`` fault profile, each run with every kernel's launch
   count set to 0 just before and read just after (``pair_score`` exactly
   once a synpa quantum); per run the jobs, slowdowns, turnaround, queue
   depth, wall per quantum (median of 3 after a warm run) and host syncs;
   an audit of the host syncs of one synergy run, a profiler breakdown of
   one fifo run, and ``synpa4`` must beat ``adjacent`` on mean slowdown;
14. ``pair_score`` reading the idle vertex's flag from device memory,
   timed beside the host-int variant at P = 1032, outputs identical;
15. ``pair_score`` with a lane axis: 12 lanes at P = 1032 (5% of the
   slots empty, the idle vertex live in every other lane) in one launch,
   each lane's slab equal bit for bit to a one-lane launch and within
   2e-5 of the plain version; one batched launch timed against 12 single
   ones, beside the bound;
16. the lane-batched open grid against the CPU at capacity 16, 40 quanta:
   rho (0.85, 1.2) x (fifo, synergy) x 2 seeds, its synergy lanes alone
   as a grid of one rule, then a faulted grid (the healthy lane and the
   fault profiles of ``benchmarks/online_churn.py``'s fault grid, fifo);
   every card lane equal to the same lane of the
   CPU's batched run and to the card's ``run_device_sim`` of its scenario
   (integer logs identical, finish quanta within 1e-4), conservation in
   every faulted lane;
17. the open grid's main path: ``record_batched_ab``'s grid of
   ``benchmarks/online_churn.py`` at capacity 1024, 24 quanta, rho (0.85,
   1.2) x (fifo, synergy) x seeds (11, 108, 205), 12 lanes, through
   ``run_device_sim_batched`` with every kernel's launch count set to 0
   just before and read just after (``pair_score`` once a quantum for all
   lanes); the grid wall (median of 3 after a warm run) against the 12
   scenarios run one after another through ``run_device_sim``, every
   lane's integer logs equal to its sequential twin's; kernels a quantum
   and device busy share under the profiler, beside one synergy lane's,
   the synergy lanes alone as one grid (each held to its sequential twin)
   and the draws alone, which break the grid's extra launches down into
   draws, the heavy-ball fallback, fifo's rule and the synergy trips; the
   host syncs of one grid run audited, none growing with the lanes; each lane's slowdowns, jobs
   and queue depth; ``synpa4`` beats ``adjacent`` in the fifo lanes at
   rho 1.2;
18. the closed race over seed lanes: ``run_quanta_multi_batched`` at
   N = 1024, 8 quanta, seeds (3, 4, 5), phase 6's policies; the seed-3
   lane against phase 6 (rtol 1e-4), every lane against
   ``run_quanta_scan`` of its seed on the card (rtol 1e-4), a one-lane
   batch against phase 6 bit for bit; its wall per lane-quantum against
   phase 6's per quantum; and the card's draws: the counter noise's
   log-ratio moments over 200 quanta, the phase-length draws' Poisson
   moments at the pool's means over 200 quanta, and a free-running static
   race at N = 64 over 40 quanta against the CPU's (within 3%);
19. the closed race's telemetry rings: phase 6's race with
   ``app_telemetry=True`` (both rings), with every kernel's launch count
   set to 0 just before and read just after: results equal phase 6 bit
   for bit, ring shapes (8, 8) and (8, 1024, 9), the host syncs of one
   ringed race audited and equal to phase 6's; at N = 16 the card's rings
   against the CPU's on the same draws (integer columns exact, float
   columns within rtol 1e-4, the GN columns within the plateau limit);
   synpa4's per-app prediction error (``accuracy_report``);
20. the open system's rings: phase 13's three synpa runs and phase 17's
   12-lane grid with both rings: logs equal the ring-off runs bit for bit,
   host syncs unchanged, the ring's queue, active, solo, admission and
   departure columns equal the stats' timelines, and the grid's lane 0
   ring against its single run's;
21. the checkpointed open run: phase 13's ``synpa4`` fifo run under the
   ``combined`` faults through ``run_device_sim_checkpointed`` in three
   segments of ``CKPT_SEG`` quanta, in a temporary directory: equal to
   phase 13's ``run_device_sim`` bit for bit; killed after one segment
   and resumed, bit for bit; resumed past a corrupted newest snapshot, bit
   for bit; the host syncs audited (the run's own plus one a segment);
   its wall per quantum against ``run_device_sim``'s and the snapshot
   write time per segment;
22. the paper's §6.2 workload race through the host tier:
   ``make_workloads`` (N = 8), workloads ``fb0``, ``be0``, ``fe0``
   (``RACE6_WORKLOADS``, fixed base seeds), ``linux``, ``hy-sched`` and
   ``SYNPA4_R-FEBE`` (``SynpaScheduler`` on the card) through
   ``run_repeated(repeats=2)``, audited for host syncs, with every
   kernel's launch count set to 0 just before and read just after
   (``pair_score`` once a SYNPA quantum): makespan, average turnaround and
   IPC geomean per policy, the TT speedup over ``linux`` per workload and
   its mean (SYNPA4_R-FEBE's must exceed 1); then ``fb0`` on the card
   against the CPU: the same pairing every quantum, turnaround within
   rtol 1e-5;
23. phase 6's race through the host matchers:
   ``run_quanta_multi(engine="vector")`` at N = 1024, 8 quanta, seed 3,
   ``linux``/``random``/``synpa4`` (``SynpaScheduler``: the fused step on
   the card, one cost copy, the tiled matcher on the host), audited, the
   launches counted as in phase 22: mean true slowdown per policy
   (``synpa4`` must beat both), wall per quantum split into fused step,
   cost copy and host matcher, phase 6's numbers printed beside;
24. the open system's host event loop at phase 13's cell (capacity 1024,
   24 quanta): ``StreamingAllocator`` under fifo, synergy and fifo with
   the ``combined`` faults, and ``LinuxOnline``, each audited and counted
   as in phase 22: slowdowns, jobs, wall per quantum split as in phase
   23, syncs (``synpa4-stream`` must beat ``LinuxOnline`` on mean
   slowdown), phase 13's numbers printed beside; then capacity 16 on the
   card against the CPU: the same pairs every quantum, integer logs
   identical, finish quanta within rtol 1e-5;
25. training, card against CPU: qwen1.5-0.5b at full width and depth 2,
   then qwen2-moe-a2.7b at full width and depth 1, float32, the same
   seeded weights and ``SyntheticLM`` batches, three ``train_step``s
   (learning rate 0 at step 1, 1e-4 from step 2): losses and ``aux``
   within rtol 1e-4, every parameter and first moment after step 3
   within 1e-4 of its tensor's largest |value| (the QKV biases, which
   start at zero and so hold only AdamW's normalised steps, within the
   learning rates' sum), and for the moe the same dropped (token, slot)
   pairs in every call;
26. the training main path: ``launch.train.train("qwen1.5-0.5b",
   smoke=False, steps=30, batch=8, seq=512)`` at full width and depth in
   bfloat16, with every kernel's launch count set to 0 just before and
   read just after (no launch: training runs plain attention) and its
   host syncs audited (only the counted loss reads at ``log_every``): the
   loss falls from the first log to the last; step wall (CUDA events
   between step ends, median of the last 10), training tokens/s, peak
   memory; one step under the profiler; ``grad_accum=2`` against
   ``grad_accum=1`` on one batch at depth 2 in float32 (losses, first
   moments, and parameters at lr 1e-5, within 1e-4); and a run killed
   after its step-4 checkpoint and resumed to step 8, equal bit for bit
   to 8 steps uninterrupted;
27. the moe serving path's reference check: phase 9 for qwen2-moe-a2.7b
   (full width, depth 2, float32, card against CPU);
28. the moe main paths: phase 10 for qwen2-moe-a2.7b at full width and
   depth (24 layers, bfloat16, ``attention_impl="kernel"``: exactly 24
   ``flash_attention`` launches a prefill of 4 x 2048, then
   ``serve_demo`` at its defaults), and ``train`` of qwen2-moe-a2.7b at
   full width and depth 2 in bfloat16 (10 steps, batch 4, sequence 512),
   counted and timed as in phase 26: the loss falls and ``aux`` stays
   finite;
29. the vlm and audio families' reference check, card against CPU,
   float32, ``attention_impl="kernel"``, every cross block's ``gate`` at
   0.5 on both sides (it starts at 0, where the cross-attention adds
   nothing): phase 9 for llama-3.2-vision-11b at full width and depth 5
   (one group: four self blocks, one cross block) and for
   whisper-large-v3 at full width with 2 decoder and 2 encoder layers
   over 1500 frames, each prefill with its batch's image or frame
   embeddings, the decode cache holding the image embeddings or the
   encoder's output of the frames; then phase 25's three training steps
   for each family's smoke config, embeddings in the batches;
30. the vlm main path: phase 10 for llama-3.2-vision-11b at full width
   and depth (40 layers, bfloat16): a prefill of 4 x 2048 tokens with 4 x
   1601 image embeddings launches ``flash_attention`` exactly 32 times
   (the self blocks; the cross blocks attend in plain tensor code, as the
   reference's), then ``serve_demo`` at its defaults in float32;
31. the audio main path: phase 10 for whisper-large-v3 at full width and
   depth (32 encoder and 32 decoder layers, bfloat16): a prefill of 4 x
   448 tokens (whisper's text context) over 4 x 1500 frames launches
   ``flash_attention`` exactly 64 times, 32 of them non-causal (the
   encoder's), then ``serve_demo`` at its defaults;
32. the last five architectures' reference check, card against CPU,
   float32, ``attention_impl="kernel"``, weights drawn on the card: the
   smoke configs of gemma-7b, starcoder2-3b, kimi-k2-1t-a32b, hymba-1.5b
   and rwkv6-3b (a prefill of 2 x 40 past the smoke windows of 16, then
   56 decode steps, greedy from step 40, which wrap the 16-slot rings
   three times, slot 1 reset after step 24, zeroing its Mamba or RWKV
   state: logits within 2e-5 of the largest |logit|, greedy tokens
   identical); phase 9 for gemma-7b, starcoder2-3b, hymba-1.5b and
   rwkv6-3b at full width and depth 2; then phase 25's three training
   steps for hymba's and rwkv6's smoke configs;
33-37. phase 10 in bfloat16 for gemma-7b (4 x 2048, 28 flash launches
   at D 256), starcoder2-3b (2 x 6144, past its 4096-token window, 30
   launches; the decode step on a 4096-slot ring at position 6000),
   hymba-1.5b (2 x 4096, 32 launches; the step on a 2048-slot ring at
   position 3000 and the Mamba states), rwkv6-3b (4 x 2048, no launch;
   the step on the RWKV states) and kimi-k2-1t-a32b at full width and
   depth 1 of 61 (4 x 2048, 1 launch at D 112; no ``serve_demo``, whose
   float32 copy of the layer would be 78 GB): each prints a summary
   (prefill wall and tokens/s, decode-step wall and kernels a step,
   device busy, flash launches a prefill, peak memory), hymba and rwkv6
   also one block's time loop apart from its products (``[scan]``);
38. the roofline's constants beside the card: ``nvidia-smi`` name and
   power limit, a bfloat16 8192^3 ``torch.matmul``'s TFLOP/s beside
   ``launch.roofline.PEAK_FLOPS``, a 4 GiB device-to-device copy's GB/s
   (bytes read plus bytes written) beside ``HBM_BW``, the card's
   ``total_memory`` beside ``HBM_BYTES`` (``[roofline]``);
39. the dry-run on the host (``launch.dryrun.run_cells``, the cells in
   ``DRYRUN_JOBS`` spawned processes at once, each over its own fake
   process group of 256 or 512 ranks, the models at full size on
   ``meta``): every cell of the 16x16 mesh but the four loop-bound ones
   (``launch.dryrun.LOOP_BOUND``: hymba-1.5b's and rwkv6-3b's
   ``train_4k`` and ``prefill_32k``, whose time loops trace a step at a
   time; the
   ``--all`` sweep of ``experiments/dryrun_sweep/run.py`` runs them),
   and the 2x16x16 mesh for ``DRYRUN_MULTI_POD`` (qwen1.5-0.5b's and
   kimi-k2's ``train_4k``); each cell's terms,
   dominant term, useful-FLOPs ratio, GiB per device, collective counts
   and wall (``[dryrun]``); every cell must complete with finite terms,
   a multi-pod cell may hold no more bytes a device than on 16x16, and
   no process group may be left;
40. co-location on the card against the CPU: ``core.colocation.
   plan_colocation`` of phase 39's records (an even count) and of the
   reference's eight stand-in jobs (``STAND_IN_JOBS``) with phase 4's
   ``SYNPA4_R-FEBE``, with every kernel's launch count set to 0 just
   before the card's plans and read just after (``pair_score`` once a
   plan): the card's pairs identical to the CPU's and ``predicted_cost``
   within 1e-5 relative; ``evaluate_placement`` of SYNPA's pairs beside a
   seeded random pairing's (``[coloc]``);
41. phase 26's run over a process group of one NCCL rank (this process,
   a file store): ``launch.train.train`` lays a (1, 1) mesh and the
   state and batches as DTensors; launches counted (0), syncs audited
   (only the counted loss reads), steps clocked as in phase 26; its
   logged losses within ``MESH_LOSS_RTOL`` of phase 26's (bit for bit
   said apart), step wall, tokens/s, peak memory and host syncs beside
   phase 26's; one more step under the profiler (device busy against
   its wall); then phase 26's checkpoint check with the killed run over
   the group and the resumed one without: equal bit for bit to 8
   uninterrupted steps (``[trainmesh]``);
42. serving over the same kind of group (``[servemesh]``): phase 10's
   ``serve_demo`` joined to it (the weights, the decode cache and each
   step's tokens as DTensors over a (1, 1) mesh), launches counted (0),
   syncs audited (only the counted token reads), its tokens identical to
   phase 10's, its decode steps (CUDA events) and tokens/s beside phase
   10's; phase 10's 4 x 2048 prefill through ``ServeEngine.prefill`` over
   the group (exactly 24 ``flash_attention`` launches on each rank's
   local tensors; logits within ``MESH_LOGIT_REL`` of the largest |logit|
   of the one-device prefill, which must repeat phase 10's, bit for bit
   said apart; peak memory beside phase 10's); hymba-1.5b and rwkv6-3b at
   full width and depth ``MESH_STATE_DEPTH`` through
   ``MESH_DECODE_STEPS`` greedy decode steps with and without the group,
   tokens identical.

The line before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_APPS = 1024
N_QUANTA = 8
RACE_SEED = 3
TOL = 2e-5
#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
#: float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: TF32 on the tensor cores, dense; the flash kernel's float32 products are
#: three TF32 products each (3xTF32).
TF32_OPS_PER_S = 495e12
TF32_PER_F32 = 3
#: bfloat16 on the tensor cores, dense.
BF16_OPS_PER_S = 989e12
#: Output sizes at which phase 3 holds pair_score to its plain version in
#: both modes: 2 and 33 hold a single tile (the diagonal one), 33 and 129
#: end in a partial tile, 4104 and 8200 launch thousands of tiles.
#: tests/test_torch_pair_score_gpu.py::PAIR_SCORE_SIZES must match.
PAIR_SCORE_SIZES = [2, 33, 129, 264, 1032, 4104, 8200]
#: Serving: the architecture, the prefill batch and its sequence length.
SERVE_ARCH = "qwen1.5-0.5b"
PREFILL_B, PREFILL_S = 4, 2048
#: A serving decode shape: slots x cache positions, KV heads, head dim.
DECODE_B, DECODE_S, DECODE_H, DECODE_D = 8, 4096, 16, 64
RMS_T, RMS_D = 8192, 1024
TOL_F32, TOL_BF16 = 1e-4, 2e-2
#: The open system's main path (phase 13): the large cell of
#: ``record_device_ab`` in benchmarks/online_churn.py (sizes (256, 1024),
#: rho 1.0, seed 11, QUANTA[1024], TARGET_SCALE, MEAN_SERVICE_SLOWDOWN).
OPEN_CAPACITY, OPEN_QUANTA, OPEN_SEED, OPEN_RHO = 1024, 24, 11, 1.0
TARGET_SCALE = 0.25
MEAN_SERVICE_SLOWDOWN = 1.3
#: The open system's reference check (phase 12): 8 cores, 40 quanta.
SMALL_CORES, SMALL_QUANTA, SMALL_SEED = 8, 40, 5
#: The lane-batched open grid (phases 15-17): ``record_batched_ab`` in
#: benchmarks/online_churn.py (rhos, admissions, seeds), at the open cell's
#: capacity and horizon; phase 16 takes two of the seeds at capacity 16.
GRID_RHOS = (0.85, 1.2)
GRID_ADMISSIONS = ("fifo", "synergy")
GRID_SEEDS = (11, 108, 205)
GRID_LANES = len(GRID_RHOS) * len(GRID_ADMISSIONS) * len(GRID_SEEDS)
#: The closed race over seed lanes (phase 18).
RACE_SEEDS = (3, 4, 5)
#: The checkpointed run's segment length (phase 21): three segments.
CKPT_SEG = 8
#: Quanta of the open run profiled without and with rings (phase 20).
RING_PROFILE_QUANTA = 6
#: The training path (phases 25-26) and the moe family (27-28): the
#: configurations, the main path's run (steps, batch, sequence) and the
#: moe training depth (24 layers of AdamW state, about 14.3 B parameters x
#: 12 bytes, would not fit the card's 80 GB).
TRAIN_ARCH, MOE_ARCH = "qwen1.5-0.5b", "qwen2-moe-a2.7b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 512
MOE_TRAIN_DEPTH, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH = 2, 10, 4
#: Phase 41's limit on the one-rank mesh run's logged losses against phase
#: 26's, relative.  The mesh run has given phase 26's losses bit for bit
#: (the loss head's log-sum-exp takes the same ops in both).
MESH_LOSS_RTOL = 1e-5
#: Phase 42's limits and sizes: the group prefill's logits against the
#: one-device prefill's, relative to the largest |logit|; the greedy
#: decode steps and the depth of the recurrent-state check.
MESH_LOGIT_REL = 1e-5
MESH_DECODE_STEPS, MESH_STATE_DEPTH = 24, 2
#: The vlm and audio families (phases 29-31): the configurations, the
#: vlm reference check's depth (one group of four self blocks and a cross
#: block), the audio one's decoder and encoder depth, and whisper's text
#: context, the audio prefill's length.
VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "whisper-large-v3"
VLM_REF_DEPTH, AUDIO_REF_DEPTH, AUDIO_S = 5, 2, 448
#: The gate every cross block gets in the reference checks.
GATE = 0.5
#: The last five architectures (phases 32-37): the configurations; each
#: main path's prefill (batch, sequence), decode cache (max_len, the
#: slots' position) and whether it runs ``serve_demo``; kimi-k2's depth
#: (one of its 61 layers: one layer's routed experts alone are 33.8 GB in
#: bfloat16).  starcoder2-3b's prefill runs past its 4096-token window and
#: its decode cache is a 4096-slot ring, hymba-1.5b's a 2048-slot one,
#: each step timed with the slots' position past the window.
GEMMA_ARCH, STARCODER_ARCH, KIMI_ARCH = ("gemma-7b", "starcoder2-3b",
                                         "kimi-k2-1t-a32b")
HYMBA_ARCH, RWKV_ARCH = "hymba-1.5b", "rwkv6-3b"
NEW_ARCHS = (GEMMA_ARCH, STARCODER_ARCH, KIMI_ARCH, HYMBA_ARCH, RWKV_ARCH)
NEW_PATHS = {
    GEMMA_ARCH: dict(batch=4, seq=2048, decode=(64, 32), demo=True),
    STARCODER_ARCH: dict(batch=2, seq=6144, decode=(8192, 6000), demo=True),
    HYMBA_ARCH: dict(batch=2, seq=4096, decode=(4096, 3000), demo=True),
    RWKV_ARCH: dict(batch=4, seq=2048, decode=(64, 32), demo=True),
    KIMI_ARCH: dict(batch=4, seq=2048, decode=(64, 32), demo=False,
                    overrides={"n_layers": 1}),
}
#: The new families' reference check (phase 32): the smoke configs'
#: prompt (past starcoder2's and hymba's smoke windows of 16), decode
#: steps (the prompt's, then greedy ones; the 16-slot rings wrap three
#: times) and the step after which slot 1 is reset.
NEW_REF_PROMPT, NEW_REF_STEPS, NEW_REF_RESET = 40, 56, 24
#: The dry-run (phase 39): the multi-pod cells and the processes that
#: trace cells at once (``launch.dryrun.LOOP_BOUND``'s cells are left to
#: the sweep: their time loops trace one step at a time, minutes each).
DRYRUN_MULTI_POD = [("qwen1.5-0.5b", "train_4k"),
                    ("kimi-k2-1t-a32b", "train_4k")]
DRYRUN_JOBS = 6
#: The reference's stand-in jobs for co-location (phase 40;
#: examples/colocation_demo.py): name, compute_s, memory_s, collective_s,
#: useful_flops_ratio.
STAND_IN_JOBS = [
    ("gemma-7b/train_4k", 0.9, 0.5, 0.3, 0.8),
    ("kimi-k2/train_4k", 0.3, 0.9, 1.2, 0.5),
    ("llama3.2-3b/decode_32k", 0.05, 0.9, 0.1, 0.9),
    ("rwkv6-3b/long_500k", 0.1, 0.7, 0.05, 0.9),
    ("starcoder2-3b/prefill_32k", 0.8, 0.4, 0.2, 0.7),
    ("qwen2-moe/train_4k", 0.4, 0.6, 0.9, 0.6),
    ("whisper-v3/prefill_32k", 0.7, 0.5, 0.2, 0.75),
    ("hymba-1.5b/decode_32k", 0.1, 0.8, 0.1, 0.85),
]
#: Flash attention at the main paths' shapes: ((B, Sq, Skv, Hq, Hkv, D),
#: causal, window): llama-3.2-vision-11b's self blocks, the whisper
#: encoder's bidirectional attention over 1500 frames, gemma-7b's D 256,
#: starcoder2-3b's window of 4096 over 6144 tokens, hymba-1.5b's 25/5
#: heads and window of 2048, kimi-k2's D 112 (zero-padded to 128).
#: tests/test_torch_vlm_audio_gpu.py holds the kernel to the first two,
#: tests/test_torch_families_gpu.py to D 112 and the smoke configs' D.
FLASH_PATH_SHAPES = [((PREFILL_B, PREFILL_S, PREFILL_S, 32, 8, 128), True, 0),
                     ((PREFILL_B, 1500, 1500, 20, 20, 64), False, 0),
                     ((4, 2048, 2048, 16, 16, 256), True, 0),
                     ((2, 6144, 6144, 24, 2, 128), True, 4096),
                     ((2, 4096, 4096, 25, 5, 64), True, 2048),
                     ((4, 2048, 2048, 64, 8, 112), True, 0)]
#: Flash attention's edge cases: (B, Sq, Skv, Hq, Hkv, D, causal, window,
#: q scale).  Lengths that are multiples of no tile, Sq != Skv both ways,
#: GQA groups 1, 4 and 8, windows whose first key falls mid-tile, q scaled
#: by 8 (logits x 8), and, in the last three, a causal window of 20 over 70
#: keys, which leaves rows 89-199 seeing no key: such rows must be exactly
#: 0.  tests/test_torch_attention_gpu.py::FLASH_EDGES must match this list.
FLASH_EDGES = [
    (1, 333, 251, 4, 4, 64, True, 0, 1.0),
    (2, 190, 517, 8, 2, 64, False, 0, 1.0),
    (1, 300, 300, 8, 8, 64, True, 37, 1.0),
    (1, 300, 300, 8, 2, 64, True, 100, 8.0),
    (1, 300, 300, 8, 1, 64, False, 77, 1.0),
    (1, 129, 131, 4, 1, 128, True, 45, 1.0),
    (1, 257, 70, 2, 2, 128, False, 0, 8.0),
    (1, 97, 161, 4, 1, 256, True, 0, 1.0),
    (1, 161, 97, 2, 1, 256, False, 33, 8.0),
    (1, 200, 70, 2, 1, 64, True, 20, 1.0),
    (1, 200, 70, 2, 1, 128, True, 20, 1.0),
    (1, 200, 70, 2, 1, 256, True, 20, 1.0),
]


def _line(tag: str, text: str) -> None:
    print(f"[{tag}] {text}", flush=True)


def _gpu_ms(fn, iters: int = 200) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters``
    back-to-back calls, queued behind a device-side sleep so that the
    host's launch time does not show as gaps between them."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wall_ms(fn, reps: int = 3) -> float:
    """Host wall time of ``fn`` ending in a synchronise: median of ``reps``
    runs after one warm run."""
    import numpy as np
    import torch

    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


class _DeviceEvents:
    """One name's device activities (kernels, copies, sets) in a profile:
    ``key``, ``count`` and ``self_device_time_total`` (us), the fields
    ``key_averages()`` gives them."""

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def _device_events(prof):
    """The profile's device activities summed by name from the raw trace.
    These are ``key_averages()``'s CUDA entries without its tree of host
    events, whose building takes minutes on a trace of 100 k launches."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        entry = by_name.get(e.name())
        if entry is None:
            entry = by_name[e.name()] = _DeviceEvents(e.name())
        entry.count += 1
        entry.self_device_time_total += e.duration_ns() / 1e3
    return list(by_name.values())


def _device_profile(fn, tries: int = 6):
    """Run ``fn`` once under ``torch.profiler``: (profiled wall seconds,
    the CUDA kernels' sums by name (:func:`_device_events`), a function
    giving one's device us).  A window in which the profiler recorded no
    CUDA event at all lost its events (every caller's ``fn`` launches
    kernels): it is profiled again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels_seen = _device_events(prof)
        if kernels_seen:
            break
        _line("profile", "the profiler recorded no CUDA event in a window "
              "that launched kernels; profiling it again")

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0.0)
                or getattr(e, "self_cuda_time_total", 0.0))

    return wall, kernels_seen, dev_us


def _ptxas_summary(log: str):
    """One line per compiled function: its registers, shared memory and
    spills, from ``-Xptxas -v``."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln:
            spill = ln
        elif "ptxas info" in ln and "Used" in ln:
            # The mangled name: the identifier that ends in "kernel" and
            # its template arguments (I...E), which tell the
            # instantiations apart.
            short = name
            at = name.find("kernel")
            if at >= 0:
                start = at
                while start > 0 and (name[start - 1].isalpha()
                                     or name[start - 1] == "_"):
                    start -= 1
                end = at + len("kernel")
                if name.startswith("I", end) and "EE" in name[end:]:
                    end = name.find("EE", end) + 2
                short = name[start:end]
            out.append(f"{short[:56]}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


def _attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """How many (query, key) pairs the ``sq`` query rows attend, in all."""
    import numpy as np

    i = np.arange(sq)
    hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def _sync_warnings(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    warnings of the host synchronisations it made (not the notice, printed
    once a process, that the debug mode is a prototype)."""
    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [w for w in seen if "synchroniz" in str(w.message)
            and "prototype" not in str(w.message)]


def _audited(fn):
    """The messages of :func:`_sync_warnings`."""
    return [str(w.message) for w in _sync_warnings(fn)]


def _close(got, want, tol: float, what: str) -> float:
    """Max abs error of ``got`` against ``want``; raises past
    ``tol`` abs + ``tol`` rel."""
    import torch

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {err:.3e} past {tol} abs/rel")
    return err


class HostDraws:
    """The port's default draws, made on the CPU and copied to ``device``:
    a race on the card and a race on the CPU then see the same numbers."""

    def __init__(self, seed: int, device):
        from repro_torch.smt.scan_engine import TorchDraws

        self._cpu = TorchDraws(seed, "cpu")
        self.device = device

    def noise(self, q, n):
        return self._cpu.noise(q, n).to(self.device)

    def phase(self, q, lam):
        return self._cpu.phase(q, lam.cpu()).to(self.device)

    def linux(self, k, q, n):
        return tuple(t.to(self.device) for t in self._cpu.linux(k, q, n))


def _policies(model, scan_engine, isc):
    return {
        "linux": scan_engine.ScanPolicy(kind="linux"),
        "random": scan_engine.ScanPolicy(kind="static"),
        "synpa4": scan_engine.ScanPolicy(kind="synpa",
                                         method=isc.SYNPA4_R_FEBE,
                                         model=model),
    }


def _race_inputs(tables, policies, dev):
    """The main path's race inputs as ``run_quanta_scan`` commits them
    (seed ``RACE_SEED``): ``(dt, init_mpart, init_st, draws)``, to run a
    race built by ``build_race`` alone (sync audits, profiles)."""
    import numpy as np
    import torch

    from repro_torch.smt import scan_engine

    n = int(tables.n_apps)
    p_pad = scan_engine.fused_pad(n)
    init_mpart = torch.as_tensor(np.stack([
        scan_engine._initial_mpart(n, p_pad,
                                   np.random.default_rng(RACE_SEED + 7919))
        for _ in policies]), device=dev)
    init_st = torch.as_tensor(np.stack(
        [scan_engine._uniform_stacks(s, n) for s in policies.values()]),
        device=dev)
    return (scan_engine.DeviceTables.build(tables, dev), init_mpart, init_st,
            scan_engine.TorchDraws(RACE_SEED, dev))


def _pair_score_check(dev, rng, ps_kernel):
    """Phase 3: pair_score against its plain version on the card, unfused
    (sentinels only) and fused (the matcher's cost preparation: a valid
    mask with empty slots, the idle vertex at row n_valid), at
    PAIR_SCORE_SIZES and a few older shapes.  DIAG and IDLE_COST entries
    must be exact, the rest within TOL abs/rel.  Returns the max abs
    error."""
    import numpy as np
    import torch

    from repro_torch.kernels.pair_score.ref import (
        DIAG, IDLE_COST, fixed_entries, pair_costs_plain)

    coeffs = torch.as_tensor(rng.normal(0.3, 0.5, (4, 4)).astype(np.float32),
                             device=dev)
    cases = [(p, n_valid, n_cat, False)
             for p, n_valid, n_cat in ((8, 8, 4), (264, 257, 3),
                                       (1032, 1024, 4), (1032, 1032, 3))]
    for p in PAIR_SCORE_SIZES:
        n_valid = max(1, p - 1 - p // 64)
        cases += [(p, n_valid, 4, False), (p, n_valid, 4, True)]
    max_err = 0.0
    for p, n_valid, n_cat, fused in cases:
        st = torch.as_tensor(
            rng.dirichlet(np.ones(4), size=p).astype(np.float32), device=dev)
        kw = {}
        if fused:
            valid = rng.random(n_valid) > 0.15
            valid[n_valid - 1] = False
            kw = dict(valid=torch.as_tensor(valid, device=dev),
                      idle_row=n_valid if n_valid < p else -1, p=p)
            st = st[:n_valid].clone()
        got = ps_kernel.pair_score_cuda(st, coeffs, n_cat, n_valid, **kw)
        want = pair_costs_plain(st, coeffs, n_cat, n_valid, **kw)
        torch.cuda.synchronize()
        what = (f"pair_score P={p} n_valid={n_valid} C={n_cat} "
                f"{'fused' if fused else 'unfused'}")
        diag, idle = fixed_entries(p, n_valid, kw.get("valid"),
                                   kw.get("idle_row", -1), dev)
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)}")
        for name, mask, value in (("DIAG", diag, DIAG),
                                  ("IDLE_COST", idle, IDLE_COST)):
            if not (bool((got[mask] == value).all())
                    and bool((want[mask] == value).all())):
                raise AssertionError(
                    f"{what}: {int((got[mask] != value).sum())} {name} "
                    f"entries of {int(mask.sum())} differ")
        fixed = diag | idle
        err = _close(got[~fixed], want[~fixed], TOL, what)
        max_err = max(max_err, err)
        _line("kernel", f"{what}: max abs err {err:.3e} (limit {TOL} "
              f"abs/rel), {int(diag.sum())} DIAG and {int(idle.sum())} "
              "IDLE_COST entries exact")
    return max_err


def _cost_prep_layers(dev, model, st, valid_mask, idle: bool) -> None:
    """Phase 6: Step 2 plus the matcher's cost preparation at the race's
    shape, as the fused step ran it before the fusion (the unfused kernel
    and eleven tensor ops, rebuilt here) against the fused call: kernels
    launched and device time under the profiler, host wall time."""
    import numpy as np
    import torch

    from repro_torch.core import isc, matching, regression
    from repro_torch.core.synpa import fused_pad
    from repro_torch.kernels.pair_score import kernel as ps_kernel

    n = st.shape[0]
    p = fused_pad(n)
    uniform = torch.as_tensor(isc.uniform_stack(model.n_categories),
                              device=dev)

    def before():
        stp = torch.cat([st, uniform[None, :].expand(p - n, -1)], dim=0)
        cost = ps_kernel.pair_score_cuda(stp, model.coeffs,
                                         model.n_categories, n)
        validp = torch.cat(
            [valid_mask, torch.zeros(p - n, dtype=torch.bool, device=dev)])
        pairv = validp[:, None] & validp[None, :]
        cost = torch.where(pairv, cost, matching.BIG)
        is_idle = (torch.arange(p, device=dev) == n) & idle
        cost = torch.where(is_idle[:, None] & validp[None, :],
                           matching.IDLE_COST, cost)
        return torch.where(validp[:, None] & is_idle[None, :],
                           matching.IDLE_COST, cost)

    def after():
        return regression.pair_cost_matrix(
            model, st, n_valid=n, valid=valid_mask,
            idle_row=n if idle else -1, p=p)

    if not torch.equal(before(), after()):
        raise AssertionError("Step 2 + cost prep: the fused call differs "
                             "from the chain it replaces")
    reps = 20
    out = {}
    for label, fn in (("before", before), ("after", after)):
        launched = []

        def window():
            launches = ps_kernel.LAUNCHES
            for _ in range(reps):
                fn()
            launched.append(ps_kernel.LAUNCHES - launches)

        _, seen, dev_us = _device_profile(window)
        if launched[-1] != reps:
            raise AssertionError(f"Step 2 + cost prep {label}: "
                                 f"{launched[-1]} pair_score launches in "
                                 f"{reps} calls")
        walls = []
        for _ in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[label] = (sum(e.count for e in seen) / reps,
                      sum(dev_us(e) for e in seen) / reps,
                      float(np.median(walls)))
    (k0, us0, w0), (k1, us1, w1) = out["before"], out["after"]
    # The profiler may drop an event of a window (section 7 of PERF.md):
    # the kernels a call launches are the per-call count rounded.
    _line("layers", f"Step 2 + cost prep, P={p} n={n} idle={idle}: before "
          f"(unfused kernel + tensor ops) {round(k0)} kernels ({k0:g} seen "
          f"a call), {us0:.3f} us device, {w0:.3f} ms wall; after (fused "
          f"kernel) {round(k1)} kernel ({k1:g} seen a call), {us1:.3f} us "
          f"device, {w1:.3f} ms wall; outputs identical")
    if round(k1) != 1:
        raise AssertionError(f"the fused cost matrix took {k1:g} kernels")


def _pair_score_times(dev, rng, model, ps_kernel):
    """Phase 7: pair_score at the race's shape (P = fused_pad(1024),
    n_valid = 1024, four categories, the fitted coefficients) in both
    modes: CUDA events over back-to-back launches, the kernel alone under
    the profiler, the plain version, and the bound.  Returns
    ``{mode: (ms, profiled us, plain ms, bound ms, bound_by)}``."""
    import numpy as np
    import torch

    from repro_torch.core.synpa import fused_pad
    from repro_torch.kernels.pair_score.ref import pair_costs_plain

    p, n_valid = fused_pad(N_APPS), N_APPS
    st = torch.as_tensor(
        rng.dirichlet(np.ones(4), size=n_valid).astype(np.float32),
        device=dev)
    st_p = torch.cat([st, st[: p - n_valid]])
    valid = torch.ones(n_valid, dtype=torch.bool, device=dev)
    coeffs = model.coeffs.contiguous()
    calls = {
        "unfused": ((st_p, coeffs, 4, n_valid), 0),
        "fused": ((st, coeffs, 4, n_valid, valid, -1, p), n_valid),
    }
    if not torch.equal(ps_kernel.pair_score_cuda(*calls["unfused"][0]),
                       ps_kernel.pair_score_cuda(*calls["fused"][0])):
        raise AssertionError("pair_score: the two modes differ on the race's "
                             "arguments")
    rows = {}
    for mode, (args, valid_bytes) in calls.items():
        ms = _gpu_ms(lambda: ps_kernel.pair_score_cuda(*args))
        plain_ms = _gpu_ms(lambda: pair_costs_plain(*args), iters=20)
        _, seen, dev_us = _device_profile(
            lambda: [ps_kernel.pair_score_cuda(*args) for _ in range(50)])
        mine = [e for e in seen if "pair_score_kernel" in e.key]
        prof_us = (sum(dev_us(e) for e in mine)
                   / max(1, sum(e.count for e in mine)))
        # Each input read once (the n_valid stacks that are read, the
        # coefficients, the valid mask), the output written once.
        n_bytes = n_valid * 16 + 16 * 4 + valid_bytes + p * p * 4
        # 17 operations per category and entry, 5 for the clips and the sum,
        # on the valid off-diagonal entries (the rest are sentinel stores).
        n_ops = (17 * 4 + 5) * n_valid * (n_valid - 1)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        _line("kernel", f"pair_score {mode} P={p} n_valid={n_valid}: "
              f"{ms * 1e3:.3f} us (CUDA events), {prof_us:.3f} us a launch "
              f"under the profiler, plain {plain_ms * 1e3:.3f} us; bound "
              f"{bound_ms * 1e3:.3f} us by {bound_by} ({n_bytes} B, {n_ops} "
              f"f32 ops; {100 * bound_ms / ms:.1f}% of the bound), which "
              "assumes the output's writes reach HBM; no single PyTorch call "
              "computes this function")
        if ms < bound_ms or prof_us * 1e-3 < bound_ms:
            _line("kernel", f"pair_score {mode}: under the bound: the "
                  f"{p * p * 4} B output fits in the 50 MB L2, and a launch "
                  "can end before its writes reach HBM")
        rows[mode] = (ms, prof_us, plain_ms, bound_ms, bound_by)
    return rows


def _serving_kernels_check(dev, rng):
    """Phase 8: each serving kernel against its plain version on the card.
    Returns each kernel's max abs error (float32 and bfloat16 cases) and
    the launches the checks made."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rms_norm_plain

    # Standard normals drawn on the card: the main paths' shapes hold up
    # to 59 M values a tensor, slow to draw on the host.
    gen = torch.Generator(device=dev).manual_seed(8)

    def normal(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    mods = {"flash_attention": fa_kernel, "decode_attention": da_kernel,
            "rmsnorm": rn_kernel}
    before = {n: m.LAUNCHES for n, m in mods.items()}
    errs = {n: {"f32": 0.0, "bf16": 0.0} for n in mods}

    def record(name, dtype, got, want, what):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        tol = TOL_BF16 if kind == "bf16" else TOL_F32
        err = _close(got, want, tol, f"{name} {what}")
        errs[name][kind] = max(errs[name][kind], err)
        return err

    # flash_attention: the reference tests' shapes x three masks, one
    # bfloat16 case, the serving prefill's shape, and the moe prefill's
    # shape and type (phase 28: qwen2-moe-a2.7b, 16 heads of 128,
    # bfloat16).
    cases = [((b, s, hq, hkv, d), causal, window, torch.float32)
             for b, s, hq, hkv, d in ((1, 128, 1, 1, 64), (2, 256, 8, 2, 64),
                                      (1, 200, 8, 8, 128), (1, 384, 4, 1, 256))
             for causal, window in ((True, 0), (True, 64), (False, 0))]
    cases = [((b, s, s, hq, hkv, d), causal, window, dtype, 1.0)
             for (b, s, hq, hkv, d), causal, window, dtype in cases]
    cases.append(((1, 256, 256, 4, 2, 64), True, 0, torch.bfloat16, 1.0))
    cases.append(((PREFILL_B, PREFILL_S, PREFILL_S, 16, 16, 64), True, 0,
                  torch.float32, 1.0))
    cases.append(((PREFILL_B, PREFILL_S, PREFILL_S, 16, 16, 128), True, 0,
                  torch.bfloat16, 1.0))
    for shape, causal, window in FLASH_PATH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((shape, causal, window, dtype, 1.0))
    # The tensor-core design's edges, in both types (as
    # tests/test_torch_attention_gpu.py::FLASH_EDGES): lengths that are
    # multiples of no tile, Sq != Skv, GQA groups 1, 4 and 8, windows
    # starting mid-tile, q x 8 (logits x 8), fully masked rows.
    for *shape, causal, window, q_scale in FLASH_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((tuple(shape), causal, window, dtype, q_scale))
    for (b, sq, skv, hq, hkv, d), causal, window, dtype, q_scale in cases:
        q = (normal((b, sq, hq, d)) * q_scale).to(dtype)
        k = normal((b, skv, hkv, d), dtype)
        v = normal((b, skv, hkv, d), dtype)
        got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        what = (f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} "
                f"causal={causal} window={window} q x{q_scale:g} "
                f"{str(dtype)[6:]}")
        err = record("flash_attention", dtype, got, want, what)
        i = np.arange(sq)
        hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv)
        lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq)
        dead = torch.as_tensor(hi <= lo, device=dev)
        if not bool((got[:, dead] == 0).all()):
            raise AssertionError(f"flash_attention {what}: a row that sees "
                                 "no key is not 0")
        _line("kernel", f"flash_attention {what}: max abs err {err:.3e}, "
              f"{int(dead.sum())} rows see no key and are 0")

    # decode_attention: the reference tests' shapes with window 0 and 200,
    # one bfloat16 case and a serving shape with mixed lengths.
    cases = [((b, hq, hkv, d, s), window, torch.float32)
             for b, hq, hkv, d, s in ((1, 1, 1, 64, 512), (2, 8, 2, 64, 700),
                                      (4, 16, 16, 128, 1024))
             for window in (0, 200)]
    cases.append(((3, 8, 2, 64, 512), 0, torch.bfloat16))
    cases.append(((DECODE_B, DECODE_H, DECODE_H, DECODE_D, DECODE_S), 0,
                  torch.float32))
    for (b, hq, hkv, d, s), window, dtype in cases:
        q = normal((b, hq, d), dtype)
        kc = normal((b, s, hkv, d), dtype)
        vc = normal((b, s, hkv, d), dtype)
        lens = torch.as_tensor(rng.integers(0, s, size=(b,)).astype(np.int32),
                               device=dev)
        got = da_ops.decode_attention(q, kc, vc, lens, window=window)
        want = decode_attention_plain(q, kc, vc, lens, window)
        torch.cuda.synchronize()
        what = (f"B={b} Hq={hq} Hkv={hkv} D={d} S={s} window={window} "
                f"{str(dtype)[6:]} lengths {lens.tolist()}")
        err = record("decode_attention", dtype, got, want, what)
        _line("kernel", f"decode_attention {what[:110]}: max abs err {err:.3e}")

    # rmsnorm: the reference tests' shapes in both types, and the serving
    # path's activations.
    for shape in ((7, 64), (3, 77, 256), (2, 4, 8, 512), (RMS_T, RMS_D)):
        for dtype in (torch.float32, torch.bfloat16):
            x = normal(shape, dtype)
            sc = torch.as_tensor(
                rng.normal(1.0, 0.1, (shape[-1],)).astype(np.float32),
                device=dev)
            got = rn_ops.rms_norm(x, sc)
            want = rms_norm_plain(x, sc)
            torch.cuda.synchronize()
            if got.dtype != dtype:
                raise AssertionError(f"rmsnorm returned {got.dtype}")
            what = f"{shape} {str(dtype)[6:]}"
            err = record("rmsnorm", dtype, got, want, what)
            _line("kernel", f"rmsnorm {what}: max abs err {err:.3e}")
    for name, e in errs.items():
        e["launches"] = mods[name].LAUNCHES - before[name]
        _line("kernel", f"{name}: agrees with its plain version, max abs err "
              f"{e['f32']:.3e} in float32 (limit {TOL_F32} abs/rel), "
              f"{e['bf16']:.3e} in bfloat16 (limit {TOL_BF16}); "
              f"{e['launches']} launches")
    return errs


def _batch_extras(cfg, rng, b: int):
    """A batch's embeddings for ``cfg``'s family, drawn from ``rng`` as
    host arrays: image patch embeddings (vlm), audio frames (audio),
    nothing for the others."""
    import numpy as np

    key, t = {"vlm": ("image_embeds", cfg.n_image_tokens),
              "audio": ("audio_frames", cfg.encoder_seq)}.get(cfg.family,
                                                             (None, 0))
    if key is None:
        return {}
    return {key: rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)}


def _cache_extras(model, extras):
    """What ``model``'s decode cache attends for a batch's embeddings, on
    its device: the image embeddings, or the encoder's output of the
    frames."""
    import torch

    with torch.no_grad():
        if "audio_frames" in extras:
            return {"enc": model._encoder(extras["audio_frames"])}
        return {k: torch.as_tensor(v, device=model.device).to(
            model.cfg.activation_dtype()) for k, v in extras.items()}


def _open_gates(model, gate: float = GATE) -> None:
    """Every cross block's gate to ``gate``: at its initial 0 the
    cross-attention adds nothing to the stream."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                p.fill_(gate)


def _serving_reference(dev, arch: str = SERVE_ARCH, twins=None) -> None:
    """Phases 9, 27 and 29: ``arch``'s serving path, card against CPU, the
    same weights on both: ``twins`` (on the CPU, on the card), by default
    ``arch`` at full width and depth 2 drawn on the CPU.  A vlm or audio
    prefill takes its batch's embeddings, and its decode cache holds them
    or the encoder's output."""
    import numpy as np
    import torch

    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serve.engine import ServeEngine

    if twins is None:
        cfg = get_config(arch, dtype="float32", param_dtype="float32",
                         n_layers=2, attention_impl="kernel")
        on_cpu = build_model(cfg, device="cpu", seed=0)
        on_card = copy.deepcopy(on_cpu).to(dev)
    else:
        on_cpu, on_card = twins
        cfg = on_cpu.cfg
    what = f"{arch} depth {cfg.n_layers}" + (
        f" + encoder {cfg.encoder_layers}" if cfg.family == "audio" else "")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
    extras = _batch_extras(cfg, rng, 1)
    batch = {"tokens": toks, **extras}
    want = ServeEngine(on_cpu, 64, 2).prefill(batch)
    got = ServeEngine(on_card, 64, 2).prefill(batch).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    top2 = torch.topk(want[0], 2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    shapes = {k: tuple(v.shape) for k, v in extras.items()}
    _line("reference", f"{what}, prefill 1 x 256 {shapes}: max |logit| "
          f"{scale:.4f}, max abs diff card vs CPU {err:.3e} (limit 1e-4 x "
          f"{scale:.4f}); least top-2 gap {gap:.4f}")
    if not (got.shape == want.shape and err <= 1e-4 * scale):
        raise AssertionError("serving prefill: card and CPU logits differ")
    # The decode path: 16 tokens through decode steps into the KV cache,
    # the cache holding each side's own image embeddings or encoder output.
    want, _ = ServeEngine(on_cpu, 64, 1).prefill_into_cache(
        toks[:, :16], extras=_cache_extras(on_cpu, extras))
    got, _ = ServeEngine(on_card, 64, 1).prefill_into_cache(
        toks[:, :16], extras=_cache_extras(on_card, extras))
    scale = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    _line("reference", f"16 decode steps: last logits max abs diff card vs "
          f"CPU {err:.3e} (limit 1e-4 x {scale:.4f})")
    if not err <= 1e-4 * scale:
        raise AssertionError("serving decode: card and CPU logits differ")
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
               .astype(np.int32) for _ in range(3)]
    # Both sides' slots attend the same embeddings (the CPU's encoder
    # output, for audio), so the tokens test the decoder alone.
    slots = _cache_extras(on_cpu, _batch_extras(cfg, rng, 2))
    out_cpu = ServeEngine(on_cpu, 64, 2).generate(
        prompts, max_new_tokens=8, extras=slots)
    out_card = ServeEngine(on_card, 64, 2).generate(
        prompts, max_new_tokens=8,
        extras={k: v.to(dev) for k, v in slots.items()})
    same = all(np.array_equal(a, b) for a, b in zip(out_cpu, out_card))
    _line("reference", f"greedy generate, 3 requests, 2 slots, 8 new tokens: "
          f"card {[o.tolist() for o in out_card]}, identical to CPU: {same}")
    if not same or len(out_card) != 3:
        raise AssertionError("serving generate: card and CPU tokens differ")


def _serving_main_path(dev, kernel_mods, arch: str = SERVE_ARCH,
                       dtype: str = "float32", seq: int = PREFILL_S,
                       expect=None, prefill_b: int = PREFILL_B, decode=(64, 32),
                       demo: bool = True, overrides=None, readings=None):
    """Phases 10, 28, 30, 31 and 33-37: ``arch``'s serving main path at
    full width and depth (or ``overrides``) in ``dtype``: one prefill of
    ``prefill_b`` x ``seq`` tokens (with the batch's image or frame
    embeddings for vlm and audio), which must launch ``flash_attention``
    ``expect`` = (all, non-causal) times (by default once a layer,
    causally), timings and profiles, a decode step of 4 slots on a cache
    of ``decode`` = (max_len, the slots' position), the time loops apart
    from the products for hybrid and ssm, then, with ``demo``,
    ``serve_demo`` (its own float32 model, built once the prefill's model
    is gone; its decode steps clocked by :class:`_ServeClock`).  Returns
    every kernel's launches in the prefill and ``serve_demo``, and the
    prefill's non-causal flash launches; fills ``readings``, if given,
    with what phase 42 holds its run to: the first prefill's logits'
    float64 sum and largest |logit| (``prefill_sum``, ``prefill_absmax``),
    the decode step's wall, kernels and device busy share (``step_ms``,
    ``step_kernels``, ``step_busy``), the peak memory (``peak``),
    ``serve_demo``'s result (``demo``) and its decode steps' times
    (``demo_step_ms``)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import serve_demo
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch, dtype=dtype, param_dtype=dtype,
                     attention_impl="kernel", **(overrides or {}))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, seed=0)
    # The draws' float32 buffers (22.5 GB for one of kimi-k2's expert
    # stacks) go back to the card, not to blocks that later tensors split.
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in model.parameters())
    max_len, at = decode
    engine = ServeEngine(model, max_len=max_len, batch_size=4)
    rng = np.random.default_rng(10)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (prefill_b, seq)).astype(np.int32), device=dev)
    extras = {k: torch.as_tensor(v, device=dev).to(cfg.activation_dtype())
              for k, v in _batch_extras(cfg, rng, prefill_b).items()}
    batch = {"tokens": toks, **extras}
    expect = expect or (cfg.n_layers, 0)
    fa = kernel_mods["flash_attention"]

    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    fa.NONCAUSAL_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = engine.prefill(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    prefill_launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    noncausal = fa.NONCAUSAL_LAUNCHES
    if tuple(logits.shape) != (prefill_b, seq, cfg.vocab_size):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite")
    if readings is not None:
        lo, hi = torch.aminmax(logits)
        readings.update(prefill_sum=float(logits.sum(dtype=torch.float64)),
                        prefill_absmax=max(-float(lo), float(hi)))
    del logits
    shapes = {k: tuple(v.shape) for k, v in extras.items()}
    _line("serve", f"{arch} full width ({cfg.n_layers} layers"
          + (f" + {cfg.encoder_layers} encoder" if cfg.family == "audio"
             else "")
          + f", {n_params} parameters, {dtype}): prefill {prefill_b} x "
          f"{seq} {shapes} first call {first_s:.3f} s, launches "
          f"{prefill_launches}, {noncausal} of flash's non-causal")
    if (prefill_launches["flash_attention"], noncausal) != tuple(expect):
        raise AssertionError(f"flash_attention launched "
                             f"{prefill_launches['flash_attention']} times "
                             f"({noncausal} non-causal) in one prefill, "
                             f"expected {expect[0]} ({expect[1]})")

    # Wall times (host clock, synchronised; median of 3 after a warm call).
    prefill_ms = _wall_ms(lambda: engine.prefill(batch))
    n_tok = prefill_b * seq
    cache = model.init_cache(4, max_len, extras=_cache_extras(model, extras))
    cache["pos"].fill_(at)
    step_tok = torch.as_tensor(np.arange(4, dtype=np.int32)[:, None],
                               device=dev)
    step_ms = _wall_ms(lambda: engine.serve_step(cache, step_tok), reps=9)
    ring = ("" if "k" not in cache else
            f", a KV cache of {cache['k'].shape[2]} slots")
    _line("serve", f"prefill {prefill_b} x {seq}: {prefill_ms:.3f} ms, "
          f"{n_tok / prefill_ms * 1e3:.1f} tokens/s; decode step (4 slots, "
          f"position {at}{ring}): {step_ms:.3f} ms, "
          f"{4 / step_ms * 1e3:.1f} tokens/s")
    summary = {}
    for label, fn in (("prefill", lambda: engine.prefill(batch)),
                      ("decode step", lambda: engine.serve_step(cache,
                                                                step_tok))):
        wall, seen, dev_us = _device_profile(fn)
        busy_ms = sum(dev_us(e) for e in seen) / 1e3
        summary[label] = (sum(e.count for e in seen),
                          100 * busy_ms / (wall * 1e3))
        _line("profile", f"one {label} under the profiler: wall "
              f"{wall * 1e3:.3f} ms, {sum(e.count for e in seen)} kernels, "
              f"device busy {busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%"
              f" of the profiled wall)")
        for e in sorted(seen, key=dev_us, reverse=True)[:8]:
            _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:100]}")
        for name in ("prep_kernel", "flash_attention_kernel"):
            mine = [e for e in seen if name in e.key]
            if not mine:
                continue
            _line("profile", f"{label}: flash's {name}: "
                  f"{sum(dev_us(e) for e in mine) / 1e3:.3f} ms in "
                  f"{sum(e.count for e in mine)} launches")
    if cfg.family in ("hybrid", "ssm"):
        _scan_split(model, prefill_b, seq, prefill_ms)
    peak = torch.cuda.max_memory_allocated()
    (n_pre, busy_pre), (n_step, busy_step) = (summary["prefill"],
                                              summary["decode step"])
    _line("serve", f"{arch} summary ({dtype}, {cfg.n_layers} layers): "
          f"prefill {prefill_b} x {seq} {prefill_ms:.3f} ms, "
          f"{n_tok / prefill_ms * 1e3:.1f} tokens/s, {n_pre} kernels, device"
          f" busy {busy_pre:.1f}%; decode step {step_ms:.3f} ms, {n_step} "
          f"kernels a step, device busy {busy_step:.1f}%; flash launches a "
          f"prefill {prefill_launches['flash_attention']}; peak memory "
          f"{peak / 1e9:.2f} GB ({peak / 2**30:.3f} GiB)")
    if readings is not None:
        readings.update(step_ms=step_ms, peak=peak, step_kernels=n_step,
                        step_busy=busy_step)
    del model, engine, cache, batch, extras
    torch.cuda.empty_cache()

    launches = dict(prefill_launches)
    if demo:
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0
        with _ServeClock() as clock:
            out = serve_demo(arch, smoke=False, device=dev)
        launches = {n: prefill_launches[n] + m.LAUNCHES
                    for n, m in kernel_mods.items()}
        steps = clock.step_ms()
        _line("serve", f"serve_demo: {out['requests']} requests, "
              f"{out['tokens']} tokens in {out['seconds']:.3f} s "
              f"({out['tok_per_s']:.1f} tok/s); {len(steps)} decode steps, "
              f"median {float(np.median(steps)):.3f} ms (CUDA events); "
              f"samples {out['outputs']}")
        if readings is not None:
            readings.update(demo=out, demo_step_ms=steps)
        if out["requests"] != 12 or out["tokens"] != 12 * 16:
            raise AssertionError(f"serve_demo served {out['requests']} "
                                 f"requests, {out['tokens']} tokens")
    _line("serve", f"launches over prefill"
          + (" + serve_demo" if demo else "") + f": {launches}")
    torch.cuda.empty_cache()
    return launches, noncausal


def _scan_split(model, batch: int, seq: int, prefill_ms: float) -> None:
    """Phases 35-36: one block's time loop apart from its products, at
    the prefill's shape: host wall (synchronised, median of 3 after a warm
    call) of the products before the loop, the loop, and the products
    after it; the loop's kernels and device busy share under the
    profiler; and the loops of all the blocks against the prefill."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import ssm
    from repro_torch.models.layers import dot

    cfg = model.cfg
    blk = model.blocks[0]
    gen = torch.Generator(device=model.device).manual_seed(3)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    device=model.device).to(cfg.activation_dtype())
    with torch.no_grad():
        if cfg.family == "hybrid":
            ins = ssm._mamba_inputs(blk.ssm, x)
            y = ssm._mamba_scan(blk.ssm, *ins)
            parts = {
                "products before": lambda: ssm._mamba_inputs(blk.ssm, x),
                "time loop": lambda: ssm._mamba_scan(blk.ssm, *ins),
                "products after": lambda: dot(y.to(x.dtype), blk.ssm.w_out),
            }
        else:
            prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
            r, k, v, g, w = ssm._rwkv_time_inputs(blk.rwkv, x.float(),
                                                  prev.float())
            h = cfg.resolved_ssm_heads
            parts = {
                "products before": lambda: ssm._rwkv_time_inputs(
                    blk.rwkv, x.float(), prev.float()),
                "time loop": lambda: ssm._rwkv_scan(blk.rwkv, r, k, v, w, h),
                "products after": lambda: (
                    ssm.rwkv6_channel_mix(blk.rwkv, x, prev),
                    dot(r.to(x.dtype), blk.rwkv.w_out)),
            }
        ms = {name: _wall_ms(fn) for name, fn in parts.items()}
        wall, seen, dev_us = _device_profile(parts["time loop"])
    busy_ms = sum(dev_us(e) for e in seen) / 1e3
    n = len(model.blocks)
    loops = n * ms["time loop"]
    _line("scan", f"{model.cfg.name} one block at {batch} x {seq}: products"
          f" before the loop {ms['products before']:.3f} ms, the loop "
          f"{ms['time loop']:.3f} ms ({sum(e.count for e in seen)} kernels, "
          f"device busy {busy_ms:.3f} ms, {100 * busy_ms / (wall * 1e3):.1f}%"
          f" of the profiled wall), products after "
          f"{ms['products after']:.3f} ms; {n} blocks' loops "
          f"{loops:.1f} ms, {100 * loops / prefill_ms:.1f}% of the "
          f"{prefill_ms:.1f} ms prefill")


def _serving_kernel_times(dev, rng, errs, path_launches):
    """Phase 11: each serving kernel's time at the path's shapes beside its
    plain version's, its bound and one PyTorch call's.  Returns the
    kernels' entries of the JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm.ref import rms_norm_plain

    gen = torch.Generator(device=dev).manual_seed(11)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    mods = {"flash_attention": fa_kernel, "decode_attention": da_kernel,
            "rmsnorm": rn_kernel}
    before = {n: m.LAUNCHES for n, m in mods.items()}
    rows = {}

    # flash_attention at one prefill layer: (4, 2048, 16/16, 64), causal.
    b, s, h, d = PREFILL_B, PREFILL_S, 16, 64
    q, k, v = normal((b, s, h, d)), normal((b, s, h, d)), normal((b, s, h, d))
    pairs = _attention_pairs(s, s, True, 0) * b * h
    rows["flash_attention"] = dict(
        ms=_gpu_ms(lambda: fa_kernel.flash_attention_cuda(q, k, v), iters=20),
        plain_ms=_gpu_ms(lambda: flash_attention_plain(q, k, v), iters=3),
        library_ms=_gpu_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True), iters=20),
        n_bytes=4 * q.numel() * 4, n_ops=4 * d * pairs,
        ops_per_s=TF32_OPS_PER_S / TF32_PER_F32,
        bound_rate="float32 ops as 3 TF32 products at 495 TFLOP/s",
        shape=f"B={b} S={s} H={h} D={d} causal")
    # Which SDPA backend ran the float32 yardstick: the aten operator it
    # dispatched to and the CUDA kernels it launched, under the profiler.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)
        torch.cuda.synchronize()
    events = prof.key_averages()
    sdpa_ops = sorted({e.key for e in events
                       if e.key.startswith("aten::_scaled_dot_product")
                       or e.key.startswith("aten::_cudnn_attention")})
    sdpa_kernels = sorted({e.key[:80] for e in events
                           if e.device_type == DeviceType.CUDA})
    rows["flash_attention"]["library_backend"] = "; ".join(
        sdpa_ops + sdpa_kernels)
    simt_ms = 4 * d * pairs / F32_OPS_PER_S * 1e3
    _line("kernel", f"flash_attention: SDPA (float32, is_causal) ran "
          f"{sdpa_ops}, kernels {sdpa_kernels}; the float32 SIMT bound of "
          f"the earlier design, for comparison: {simt_ms * 1e3:.3f} us")
    # The wrapper's two kernels apart: the pre-pass (reads K and V once,
    # writes their planes into the scratch) and the attention kernel.
    units = fa_kernel.LIB.call("flash_attention_scratch", b, s, h, d, 0)
    prep_bytes = 2 * k.numel() * 4 + 16 * units * 4
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fa_kernel.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
    for name in ("prep_kernel", "flash_attention_kernel"):
        mine = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 or getattr(e, "self_cuda_time_total", 0.0)
                 for e in mine) / max(1, sum(e.count for e in mine))
        bound = (f"; its bytes bound {prep_bytes / HBM_BYTES_PER_S * 1e6:.3f}"
                 f" us ({prep_bytes} B)" if name == "prep_kernel" else "")
        _line("kernel", f"flash_attention {rows['flash_attention']['shape']}:"
              f" {name} {us:.3f} us a launch under the profiler{bound}")
    # The bfloat16 route at the same shape: one bf16 tensor-core product
    # per product.
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    bf16_ms = _gpu_ms(lambda: fa_kernel.flash_attention_cuda(qb, kb, vb),
                      iters=20)
    bf16_sdpa_ms = _gpu_ms(lambda: F.scaled_dot_product_attention(
        qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
        is_causal=True), iters=20)
    _line("kernel", f"flash_attention {rows['flash_attention']['shape']} "
          f"bfloat16: {bf16_ms * 1e3:.3f} us, SDPA {bf16_sdpa_ms * 1e3:.3f} "
          f"us; bound {4 * d * pairs / BF16_OPS_PER_S * 1e6:.3f} us by "
          f"operations (989 TFLOP/s)")
    rows["flash_attention"]["path_shapes"] = _flash_path_times(
        normal, fa_kernel, flash_attention_plain)

    # decode_attention: 8 slots, every position of a 4096-token cache valid.
    b, s, h, d = DECODE_B, DECODE_S, DECODE_H, DECODE_D
    qd = normal((b, h, d))
    kc, vc = normal((b, s, h, d)), normal((b, s, h, d))
    lens = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    valid = int((lens.cpu().numpy().astype(np.int64) + 1).sum())
    mask = (torch.arange(s, device=dev)[None, :] <= lens[:, None].long())
    mask = mask[:, None, None, :]
    rows["decode_attention"] = dict(
        ms=_gpu_ms(lambda: da_kernel.decode_attention_cuda(qd, kc, vc, lens)),
        plain_ms=_gpu_ms(lambda: decode_attention_plain(qd, kc, vc, lens),
                         iters=20),
        library_ms=_gpu_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask)),
        n_bytes=valid * h * d * 4 * 2 + 2 * qd.numel() * 4 + b * 4,
        n_ops=4 * d * h * valid,
        shape=f"B={b} S={s} H={h} D={d} lengths {s - 1}")

    # rmsnorm over the serving path's activations: (8192, 1024) float32.
    x = normal((RMS_T, RMS_D))
    sc = torch.as_tensor(rng.normal(1.0, 0.1, (RMS_D,)).astype(np.float32),
                         device=dev)
    rows["rmsnorm"] = dict(
        ms=_gpu_ms(lambda: rn_kernel.rms_norm_cuda(x, sc)),
        plain_ms=_gpu_ms(lambda: rms_norm_plain(x, sc)),
        library_ms=_gpu_ms(lambda: F.rms_norm(x, (RMS_D,), sc, 1e-6)),
        n_bytes=2 * x.numel() * 4 + RMS_D * 4, n_ops=4 * x.numel(),
        shape=f"T={RMS_T} D={RMS_D} float32")

    sources = {
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:37"),
        "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/"
                             "decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:30"),
        "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:20"),
    }
    entries = []
    for name, r in rows.items():
        bytes_ms = r["n_bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["n_ops"] / r.get("ops_per_s", F32_OPS_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        rate = r.get("bound_rate", "float32 ops at 67 TFLOP/s")
        timed = mods[name].LAUNCHES - before[name]
        _line("kernel", f"{name} {r['shape']}: {r['ms'] * 1e3:.3f} us, plain "
              f"{r['plain_ms'] * 1e3:.3f} us, library {r['library_ms'] * 1e3:.3f}"
              f" us, bound {bound_ms * 1e3:.3f} us by {bound_by} ({rate}) "
              f"({r['n_bytes']} B, {r['n_ops']} f32 ops; "
              f"{100 * bound_ms / r['ms']:.1f}% of the bound); "
              f"{timed} launches timed")
        extra = {}
        if name == "flash_attention":
            extra = {"bound_rate": rate,
                     "library_backend": r["library_backend"],
                     "path_shapes": r["path_shapes"]}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": path_launches[name],
            "max_abs_err": errs[name]["f32"],
            "max_abs_err_bf16": errs[name]["bf16"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": r["library_ms"],
            "phase_launches": {"8": errs[name]["launches"], "11": timed},
            **extra,
        })
    return entries


def _flash_path_times(normal, fa_kernel, flash_attention_plain):
    """Phase 11's flash attention at ``FLASH_PATH_SHAPES`` in float32 and
    bfloat16: the kernel, its plain version and SDPA (``is_causal`` as the
    path has it, a window as a boolean mask, grouped heads through
    ``enable_gqa``) on the same inputs, and the bound, counted from the
    (query, key) pairs the mask keeps.  At a head dim that is no tile of
    the kernel's, the wrapper's zero-padded copies of q, k, v and the
    slice of the output are timed apart (``pad_ms``).  Returns one row a
    shape and type."""
    import torch
    import torch.nn.functional as F

    out = []
    for (b, sq, skv, hq, hkv, d), causal, window in FLASH_PATH_SHAPES:
        pairs = _attention_pairs(sq, skv, causal, window) * b * hq
        q32, k32, v32 = (normal((b, sq, hq, d)), normal((b, skv, hkv, d)),
                         normal((b, skv, hkv, d)))
        mask = None
        if window > 0:
            qpos = torch.arange(sq, device=q32.device)[:, None]
            kpos = torch.arange(skv, device=q32.device)[None, :]
            mask = (kpos <= qpos) if causal else torch.ones_like(kpos > qpos)
            mask &= kpos > qpos - window
        tile = next(t for t in fa_kernel.HEAD_DIMS if t >= d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            ms = _gpu_ms(lambda: fa_kernel.flash_attention_cuda(
                q, k, v, causal, window), iters=10)
            plain_ms = _gpu_ms(lambda: flash_attention_plain(
                q, k, v, causal, window), iters=2)
            library_ms = _gpu_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=hq != hkv), iters=10)
            pad_ms = None
            if tile != d:
                wide = torch.empty((b, sq, hq, tile), dtype=dtype,
                                   device=q.device)
                pad_ms = (_gpu_ms(lambda: [F.pad(t, (0, tile - d))
                                           for t in (q, k, v)], iters=10)
                          + _gpu_ms(lambda: wide[..., :d].contiguous(),
                                    iters=10))
            n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
            n_ops = 4 * d * pairs
            f32 = dtype == torch.float32
            rate = (TF32_OPS_PER_S / TF32_PER_F32) if f32 else BF16_OPS_PER_S
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / rate * 1e3
            row = dict(
                shape=(f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} "
                       f"{'causal' if causal else 'non-causal'}"
                       + (f" window={window}" if window else "")),
                dtype=str(dtype)[6:], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate=("float32 ops as 3 TF32 products at 495 TFLOP/s"
                            if f32 else "bfloat16 at 989 TFLOP/s"))
            if pad_ms is not None:
                row["pad_ms"] = pad_ms
            out.append(row)
            pad = ("" if pad_ms is None else
                   f"; of the kernel's time, the zero-padded copies to D "
                   f"{tile} and the output's slice {pad_ms * 1e3:.3f} us")
            _line("kernel", f"flash_attention {row['shape']} {row['dtype']}: "
                  f"{ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, SDPA "
                  f"{library_ms * 1e3:.3f} us, bound "
                  f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
                  f"({row['bound_rate']}; {n_bytes} B, {n_ops} ops; "
                  f"{100 * row['bound_ms'] / ms:.1f}% of the bound){pad}")
    return out


def mean_service_quanta(machine) -> float:
    """Expected quanta a job holds a context: solo quanta under the scaled
    §6.2 target times the typical SMT slowdown (as
    ``benchmarks/online_churn.py`` maps rho to an arrival rate)."""
    return (machine.params.solo_reference_quanta * TARGET_SCALE
            * MEAN_SERVICE_SLOWDOWN)


def _fault_profile(FaultProfile, name: str, n_cores: int, quanta: int):
    """A profile of ``benchmarks/online_churn.py``'s fault grid at this
    size."""
    k = max(1, n_cores // 8)
    down_q, up_q = quanta // 4, (3 * quanta) // 4
    crash = tuple((down_q + i % 3, i) for i in range(k))
    heal = tuple((up_q + i % 3, i) for i in range(k))
    band = tuple((c, quanta // 3, (2 * quanta) // 3, 0.5)
                 for c in range(n_cores - max(1, n_cores // 8), n_cores))
    if name == "crash-wave":
        return FaultProfile(fail=crash, recover=heal)
    if name == "mttf-churn":
        return FaultProfile(mttf_quanta=3.0 * quanta,
                            mttr_quanta=quanta / 6.0)
    if name == "stragglers":
        return FaultProfile(straggle=band)
    assert name == "combined", name
    return FaultProfile(fail=crash, recover=heal, straggle=band,
                        mttf_quanta=6.0 * quanta, mttr_quanta=quanta / 6.0)


def _same_open_run(card, cpu, what: str) -> None:
    """Phase 12's comparison: every integer log identical, finish quanta
    within 1e-4."""
    import numpy as np

    if (card.n_arrived, card.n_admitted, card.n_completed) != \
            (cpu.n_arrived, cpu.n_admitted, cpu.n_completed):
        raise AssertionError(
            f"{what}: jobs card {(card.n_arrived, card.n_admitted, card.n_completed)}"
            f" vs CPU {(cpu.n_arrived, cpu.n_admitted, cpu.n_completed)}")
    series = ["queue_depth", "active", "solo_quanta", "admissions"]
    if cpu.has_faults:
        series += ["evictions", "requeues"]
    for name in series:
        if not np.array_equal(getattr(card, name), getattr(cpu, name)):
            raise AssertionError(f"{what}: {name} differs card vs CPU")
    a = {r.job_id: r for r in card.completed}
    b = {r.job_id: r for r in cpu.completed}
    if a.keys() != b.keys() or any(
            (a[j].admit_q, a[j].retries) != (b[j].admit_q, b[j].retries)
            for j in a):
        raise AssertionError(f"{what}: admission quanta or retries differ")
    for j in a:
        if not abs(a[j].finish_q - b[j].finish_q) <= 1e-4 * abs(b[j].finish_q):
            raise AssertionError(f"{what}: job {j} finishes at "
                                 f"{a[j].finish_q!r} on the card, "
                                 f"{b[j].finish_q!r} on the CPU")


def _open_reference(dev, model) -> None:
    """Phase 12: the open system at capacity 16, card against CPU, on the
    same draws and the same synergy tables."""
    import numpy as np
    import torch

    from repro_torch.core import isc
    from repro_torch.kernels.pair_score.ref import DIAG
    from repro_torch.online import (ClusterSim, FaultProfile,
                                    SynergyAdmission, TraceArrivals)
    from repro_torch.smt.apps import pool_profiles
    from repro_torch.smt.machine import MachineParams, SMTMachine
    from repro_torch.smt.scan_engine import ScanPolicy

    # torch.argmin must take the first of tied minima on the card, as
    # jnp.argmin does: synergy placement breaks its ties so.
    rng = np.random.default_rng(12)
    for n in (16, 1024):
        for _ in range(20):
            x = rng.integers(0, 4, n).astype(np.float32)
            x[rng.random(n) < 0.3] = np.inf
            got = int(torch.argmin(torch.as_tensor(x, device=dev)))
            if got != int(np.argmin(x)):
                raise AssertionError(f"argmin on the card: {got}, first "
                                     f"minimum at {int(np.argmin(x))}")
    _line("open", "torch.argmin on the card takes the first of tied minima "
          "(40 draws at 16 and 1024 slots)")

    machine = SMTMachine(MachineParams(), seed=0)
    pool = pool_profiles()
    model_cpu = model.to("cpu")
    # Fresh machines: a solo profile draws its phase lengths from the
    # machine's generator.
    syn = SynergyAdmission(SMTMachine(MachineParams(), seed=0), pool,
                           isc.SYNPA4_R_FEBE, model, quanta=12)
    syn_cpu = SynergyAdmission(SMTMachine(MachineParams(), seed=0), pool,
                               isc.SYNPA4_R_FEBE, model_cpu, quanta=12)
    off = ~np.eye(len(pool), dtype=bool)
    diff = np.abs(syn.pool_cost - syn_cpu.pool_cost)[off]
    err = float(diff.max())
    if not ((diff <= TOL + TOL * np.abs(syn_cpu.pool_cost[off])).all()
            and (np.diag(syn.pool_cost) == DIAG).all()):
        raise AssertionError(f"synergy pool cost card vs CPU: {err:.3e}")
    _line("open", f"synergy pool cost ({len(pool)} x {len(pool)}, the "
          f"pair_score kernel on the card): max abs diff card vs CPU "
          f"{err:.3e} (limit {TOL} abs/rel), diagonal DIAG")

    # 15 jobs at quantum 0 (an odd population: the idle vertex from the
    # first quantum), then 3 at every odd quantum: queueing, and the
    # parity toggles as jobs leave.
    q = SMALL_QUANTA
    events = [(0, k) for k in range(15)] + [
        (t, (7 * t + i) % len(pool)) for t in range(1, q, 2) for i in range(3)]

    def synpa(m):
        return ScanPolicy(kind="synpa", method=isc.SYNPA4_R_FEBE, model=m)

    crash = _fault_profile(FaultProfile, "crash-wave", SMALL_CORES, q)
    cases = {
        "adjacent": (ScanPolicy(kind="adjacent"), ScanPolicy(kind="adjacent"),
                     {}),
        "synpa4 fifo": (synpa(model), synpa(model_cpu), {}),
        "synpa4 synergy": (synpa(model), synpa(model_cpu),
                           dict(admission="synergy", synergy=syn)),
        "synpa4 crash-wave": (synpa(model), synpa(model_cpu),
                              dict(faults=crash)),
    }
    for name, (pol_card, pol_cpu, kw) in cases.items():
        out = {}
        for where, pol in ((dev, pol_card), ("cpu", pol_cpu)):
            sim = ClusterSim(machine, pool, SMALL_CORES, pol,
                             TraceArrivals(events), seed=SMALL_SEED,
                             target_scale=0.1, engine="scan", device=where,
                             **kw)
            out[str(where)] = sim.run(q, warmup=False,
                                      draws=HostDraws(SMALL_SEED, where))
        card, cpu = out[str(dev)], out["cpu"]
        _same_open_run(card, cpu, f"open capacity 16 {name}")
        faults = (f", evictions {int(card.evictions.sum())}, requeues "
                  f"{int(card.requeues.sum())}" if card.has_faults else "")
        _line("open", f"capacity 16 {name}: {card.n_arrived} arrived, "
              f"{card.n_admitted} admitted, {card.n_completed} completed, "
              f"max queue {int(card.queue_depth.max())}, solo quanta "
              f"{int(card.solo_quanta.sum())}{faults}; mean slowdown card "
              f"{card.mean_slowdown!r} CPU {cpu.mean_slowdown!r}: identical "
              "integer logs, finish quanta within 1e-4")
        if card.n_completed == 0 or card.queue_depth.max() == 0 or \
                card.solo_quanta.sum() == 0:
            raise AssertionError(f"open capacity 16 {name}: the check saw no "
                                 "completion, no queue or no odd population")


def _open_main_path(dev, model, kernel_mods):
    """Phase 13: the open system at capacity 1024.  Returns the kernels'
    launches over the four runs, and for phases 20-21 each run's sim,
    stats, host syncs and wall per quantum."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import isc, matching, regression
    from repro_torch.online import (ClusterSim, FaultProfile,
                                    PoissonArrivals, SynergyAdmission)
    from repro_torch.online import device_sim
    from repro_torch.smt.apps import pool_profiles
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine
    from repro_torch.smt.scan_engine import ScanPolicy

    machine = SMTMachine(MachineParams(), seed=0)
    pool = pool_profiles()
    tables = PhaseTables.build(pool)
    n_cores = OPEN_CAPACITY // 2
    rate = OPEN_RHO * OPEN_CAPACITY / mean_service_quanta(machine)
    t0 = time.perf_counter()
    syn = SynergyAdmission(machine, pool, isc.SYNPA4_R_FEBE, model)
    _line("open", f"synergy tables ({len(pool)} pool apps, 40 solo quanta "
          f"each) in {time.perf_counter() - t0:.2f} s")
    synpa = ScanPolicy(kind="synpa", method=isc.SYNPA4_R_FEBE, model=model,
                       matcher="refine", name="synpa4")
    runs = {
        "adjacent": (ScanPolicy(kind="adjacent", name="adjacent"), {}),
        "synpa4 fifo": (synpa, {}),
        "synpa4 synergy": (dataclasses.replace(synpa, name="synpa4-syn"),
                           dict(admission="synergy", synergy=syn)),
        "synpa4 fifo combined faults": (
            synpa, dict(faults=_fault_profile(FaultProfile, "combined",
                                              n_cores, OPEN_QUANTA))),
    }
    counters = ("NEED_FB_SYNCS", "TWO_OPT_SYNCS", "ADMIT_SYNCS")
    owners = (regression, matching, device_sim)
    sims, stats, total = {}, {}, {n: 0 for n in kernel_mods}
    run_syncs, run_per_q = {}, {}
    for name, (pol, kw) in runs.items():
        sim = ClusterSim(machine, pool, n_cores, pol,
                         PoissonArrivals(rate=rate, n_pool=len(pool)),
                         seed=OPEN_SEED, target_scale=TARGET_SCALE,
                         tables=tables, engine="scan", device=dev, **kw)
        sims[name] = sim
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0
        before = [getattr(m, c) for m, c in zip(owners, counters)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run(OPEN_QUANTA, warmup=False)
        first_s = time.perf_counter() - t0
        launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
        syncs = [getattr(m, c) - b for m, c, b in zip(owners, counters,
                                                       before)]
        for n in total:
            total[n] += launches[n]
        want = OPEN_QUANTA if pol.kind == "synpa" else 0
        if launches["pair_score"] != want or any(
                v for n, v in launches.items() if n != "pair_score"):
            raise AssertionError(f"open {name}: launches {launches}, "
                                 f"expected pair_score {want} and no other")
        timed = sim.run(OPEN_QUANTA, repeats=3)
        per_q_ms = float(timed.policy_s[0]) * 1e3
        if (timed.n_completed, timed.mean_slowdown) != \
                (st.n_completed, st.mean_slowdown):
            raise AssertionError(f"open {name}: a rerun differs")
        if not (st.n_completed > 0 and math.isfinite(st.mean_slowdown)):
            raise AssertionError(f"open {name}: no completed job")
        stats[name] = st
        run_syncs[name], run_per_q[name] = syncs, per_q_ms
        faults = ""
        if st.has_faults:
            faults = (f"; faults: {int(st.failures.sum())} core failures, "
                      f"{st.n_evicted} evictions, {st.n_requeued} requeues, "
                      f"{st.n_dropped} dropped, {st.n_retry_waiting} waiting,"
                      f" {st.n_in_flight} in flight: conservation holds")
        _line("open", f"capacity {OPEN_CAPACITY} {name}: {st.n_arrived} "
              f"arrived, {st.n_admitted} admitted, {st.n_completed} "
              f"completed; slowdown mean {st.mean_slowdown!r} p95 "
              f"{st.slowdown_percentile(95.0)!r}; mean turnaround "
              f"{st.mean_turnaround_s!r} s; mean queue depth "
              f"{st.mean_queue_depth!r}; wall {per_q_ms:.3f} ms a quantum "
              f"(median of 3 after a warm run; first run {first_s:.3f} s); "
              f"launches {launches}; host syncs: fallback flag {syncs[0]}, "
              f"2-opt flag {syncs[1]}, admission count {syncs[2]}{faults}")
    if not (stats["synpa4 fifo"].mean_slowdown
            < stats["adjacent"].mean_slowdown):
        raise AssertionError("open: synpa4 does not beat adjacent on mean "
                             "slowdown")

    def race_of(name):
        run = _grid_run([sims[name]], OPEN_QUANTA)
        torch.cuda.synchronize()
        return run

    # Host syncs of one synergy run: every one a counted exit.
    fn = race_of("synpa4 synergy")
    counted0 = sum(getattr(m, c) for m, c in zip(owners, counters))
    seen = _audited(fn)
    torch.cuda.synchronize()
    counted = sum(getattr(m, c) for m, c in zip(owners, counters)) - counted0
    _line("syncs", f"one open synergy run: {len(seen)} sync warnings, "
          f"{counted} syncs counted (fallback, 2-opt and admission flags)")
    if len(seen) != counted:
        for msg in sorted(set(seen)):
            _line("syncs", msg[:200])
        raise AssertionError("uncounted host syncs in the open run")

    # Where one fifo run's time goes, under the profiler.
    fn = race_of("synpa4 fifo")
    fn()
    wall, seen, dev_us = _device_profile(fn)
    busy_ms = sum(dev_us(e) for e in seen) / 1e3
    n_kernels = sum(e.count for e in seen)
    _line("profile", f"one open synpa4 fifo run ({OPEN_QUANTA} quanta) under "
          f"the profiler: wall {wall * 1e3:.3f} ms, {n_kernels} kernels "
          f"({n_kernels / OPEN_QUANTA:.1f} a quantum), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}% of the "
          "profiled wall)")
    for e in sorted(seen, key=dev_us, reverse=True)[:10]:
        _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:100]}")
    return total, dict(sims=sims, stats=stats, syncs=run_syncs,
                       per_q_ms=run_per_q)


def _pair_score_flag_times(dev, rng, model, ps_kernel):
    """Phase 14: pair_score with the idle vertex's flag in device memory
    against the host-int variant, at the open path's shape (P = 1032,
    n_valid = 1024, 5% of the slots empty, the idle vertex at row 1024).
    Returns ``(flag ms, host-int ms)``."""
    import numpy as np
    import torch

    from repro_torch.core.synpa import fused_pad

    p, n_valid = fused_pad(OPEN_CAPACITY), OPEN_CAPACITY
    st = torch.as_tensor(
        rng.dirichlet(np.ones(4), size=n_valid).astype(np.float32),
        device=dev)
    valid = torch.as_tensor(rng.random(n_valid) > 0.05, device=dev)
    coeffs = model.coeffs.contiguous()
    on = torch.ones(1, dtype=torch.bool, device=dev)
    off = torch.zeros(1, dtype=torch.bool, device=dev)
    for flag, host_row in ((on, n_valid), (off, -1)):
        got = ps_kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid,
                                        n_valid, p, idle_flag=flag)
        want = ps_kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid,
                                         host_row, p)
        if not torch.equal(got, want):
            raise AssertionError(f"pair_score: the device flag "
                                 f"{bool(flag)} differs from idle_row "
                                 f"{host_row}")

    def with_flag():
        return ps_kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid,
                                         n_valid, p, idle_flag=on)

    def with_int():
        return ps_kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid,
                                         n_valid, p)

    # Host int, flag, flag, host int: the two rounds show the noise.
    times = {"int": [], "flag": []}
    for name in ("int", "flag", "flag", "int"):
        times[name].append(_gpu_ms(with_int if name == "int" else with_flag))
    flag_ms, int_ms = (float(np.median(times[k])) for k in ("flag", "int"))
    _line("kernel", f"pair_score fused P={p} n_valid={n_valid}, idle vertex "
          f"at {n_valid}: flag in device memory {flag_ms * 1e3:.3f} us "
          f"({', '.join(f'{t * 1e3:.3f}' for t in times['flag'])}), host int "
          f"{int_ms * 1e3:.3f} us ({', '.join(f'{t * 1e3:.3f}' for t in times['int'])}); "
          "outputs identical for both flag values")
    return flag_ms, int_ms


def _grid_run(sims, n_quanta: int, draws=None):
    """A grid of open-system lanes, built and committed on the sims'
    device: ``run()`` runs the whole horizon once, as
    ``run_device_sim_batched`` does."""
    from repro_torch.online import batch_sim, device_sim

    preps, j_pad, syn_tables, draws = batch_sim._grid(sims, n_quanta, draws)
    return device_sim._grid_race(sims, preps, n_quanta, j_pad, syn_tables,
                                 draws)


def _first_divergence(a, b) -> str:
    """Where two open runs part ways: the first quantum whose queue depth,
    active or solo count differs, with both values."""
    import numpy as np

    for name in ("queue_depth", "active", "solo_quanta", "admissions"):
        x, y = getattr(a, name), getattr(b, name)
        diff = np.flatnonzero(np.asarray(x) != np.asarray(y))
        if diff.size:
            q = int(diff[0])
            return f"{name} first differs at quantum {q}: {x[q]!r} vs {y[q]!r}"
    return "no per-quantum series differs"


def _pair_score_lanes(dev, rng, model, ps_kernel):
    """Phase 15: pair_score with a lane axis at the open grid's shape.
    Returns the entry's extra keys."""
    import numpy as np
    import torch

    from repro_torch.core.synpa import fused_pad
    from repro_torch.kernels.pair_score.ref import (
        DIAG, IDLE_COST, fixed_entries, pair_costs_plain)

    lanes, p, n_valid = GRID_LANES, fused_pad(OPEN_CAPACITY), OPEN_CAPACITY
    st = torch.as_tensor(rng.dirichlet(np.ones(4), size=(lanes, n_valid))
                         .astype(np.float32), device=dev)
    valid = torch.as_tensor(rng.random((lanes, n_valid)) > 0.05, device=dev)
    flag = torch.as_tensor(np.arange(lanes) % 2 == 0, device=dev)
    coeffs = model.coeffs.contiguous()

    def batched():
        return ps_kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid,
                                         n_valid, p, idle_flag=flag)

    def singles():
        return [ps_kernel.pair_score_cuda(st[k], coeffs, 4, n_valid,
                                          valid[k], n_valid, p,
                                          idle_flag=flag[k:k + 1])
                for k in range(lanes)]

    def plain():
        return pair_costs_plain(st, coeffs, 4, n_valid, valid, n_valid, p,
                                idle_flag=flag)

    got, one, want = batched(), singles(), plain()
    torch.cuda.synchronize()
    if got.shape != (lanes, p, p):
        raise AssertionError(f"pair_score lanes: shape {tuple(got.shape)}")
    max_err = 0.0
    for k in range(lanes):
        if not torch.equal(got[k], one[k]):
            raise AssertionError(f"pair_score lane {k}: the batched launch "
                                 "differs from a one-lane launch")
        diag, idle = fixed_entries(p, n_valid, valid[k],
                                   n_valid if bool(flag[k]) else -1, dev)
        for name, mask, value in (("DIAG", diag, DIAG),
                                  ("IDLE_COST", idle, IDLE_COST)):
            if not (bool((got[k][mask] == value).all())
                    and bool((want[k][mask] == value).all())):
                raise AssertionError(f"pair_score lane {k}: {name} entries "
                                     "differ")
        fixed = diag | idle
        max_err = max(max_err, _close(got[k][~fixed], want[k][~fixed], TOL,
                                      f"pair_score lane {k}"))
    # Batched, singles, singles, batched: the two rounds show the noise.
    times = {"batched": [], "singles": []}
    for name in ("batched", "singles", "singles", "batched"):
        times[name].append(_gpu_ms(batched if name == "batched" else singles,
                                   iters=50))
    batched_ms, singles_ms = (float(np.median(times[k]))
                              for k in ("batched", "singles"))
    plain_ms = _gpu_ms(plain, iters=3)
    # Each input read once (the stacks, the valid masks, the flags, the
    # coefficients), the outputs written once; the operations of the
    # valid off-diagonal entries this run's masks leave.
    nv = valid.sum(1).to(torch.float64)
    n_bytes = lanes * (n_valid * 16 + n_valid + 1 + p * p * 4) + 16 * 4
    n_ops = int((17 * 4 + 5) * float((nv * (nv - 1)).sum()))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    _line("kernel", f"pair_score lanes L={lanes} P={p} n_valid={n_valid}, "
          f"{int(valid.sum())} valid slots in all, the idle vertex live in "
          f"{int(flag.sum())} lanes: every lane's slab equal to a one-lane "
          f"launch bit for bit; max abs err against the plain version "
          f"{max_err:.3e} (limit {TOL} abs/rel)")
    _line("kernel", f"pair_score lanes: one launch {batched_ms * 1e3:.3f} us "
          f"({', '.join(f'{t * 1e3:.3f}' for t in times['batched'])}); "
          f"{lanes} one-lane launches {singles_ms * 1e3:.3f} us "
          f"({', '.join(f'{t * 1e3:.3f}' for t in times['singles'])}), "
          f"{singles_ms / lanes * 1e3:.3f} us a lane; plain "
          f"{plain_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.3f} us by "
          f"{bound_by} ({n_bytes} B, {n_ops} f32 ops; "
          f"{100 * bound_ms / batched_ms:.1f}% of the bound)")
    return {"lanes": lanes, "batched_ms": batched_ms,
            "batched_bound_ms": bound_ms, "batched_bound_by": bound_by,
            "batched_plain_ms": plain_ms, "singles_ms": singles_ms,
            "batched_max_abs_err": max_err}


def _grid_sims(machine, pool, tables, spec, n_cores, quanta_of_rate,
               seeds, synergy, device, rhos=GRID_RHOS,
               admissions=GRID_ADMISSIONS):
    """The scenario grid rho x admission x seed, as
    ``record_batched_ab`` orders it: (sims, labels)."""
    from repro_torch.online import ClusterSim, PoissonArrivals

    sims, labels = [], []
    for rho in rhos:
        arrivals = PoissonArrivals(rate=rho * quanta_of_rate,
                                   n_pool=len(pool))
        for adm in admissions:
            kw = (dict(admission="synergy", synergy=synergy)
                  if adm == "synergy" else {})
            for sd in seeds:
                sims.append(ClusterSim(machine, pool, n_cores, spec, arrivals,
                                       seed=sd, target_scale=TARGET_SCALE,
                                       tables=tables, engine="scan",
                                       device=device, **kw))
                labels.append(f"rho={rho}/{adm}/seed={sd}")
    return sims, labels


def _open_grid_reference(dev, model) -> None:
    """Phase 16: the lane-batched open grid at capacity 16, card against
    the CPU and against the card's single runs, on the same draws."""
    from repro_torch.core import isc
    from repro_torch.online import (ClusterSim, FaultProfile, PoissonArrivals,
                                    SynergyAdmission, run_device_sim_batched)
    from repro_torch.online.device_sim import run_device_sim
    from repro_torch.smt.apps import pool_profiles
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine
    from repro_torch.smt.scan_engine import LaneDraws, ScanPolicy

    machine = SMTMachine(MachineParams(), seed=0)
    pool = pool_profiles()
    tables = PhaseTables.build(pool)
    q = SMALL_QUANTA
    capacity = 2 * SMALL_CORES
    syn = SynergyAdmission(SMTMachine(MachineParams(), seed=0), pool,
                           isc.SYNPA4_R_FEBE, model, quanta=12)
    specs = {str(where): ScanPolicy(kind="synpa", method=isc.SYNPA4_R_FEBE,
                                    model=m, name="synpa4")
             for where, m in ((dev, model), ("cpu", model.to("cpu")))}
    per_rho = capacity / mean_service_quanta(machine)
    seeds = GRID_SEEDS[:2]

    def faulted(where):
        """The healthy lane and the fault grid of online_churn.py at rho
        1.0, fifo admission, the first seed."""
        arrivals = PoissonArrivals(rate=per_rho, n_pool=len(pool))
        out, labels = [], []
        for name in ("none", "crash-wave", "mttf-churn", "stragglers",
                     "combined"):
            faults = (None if name == "none" else
                      _fault_profile(FaultProfile, name, SMALL_CORES, q))
            out.append(ClusterSim(machine, pool, SMALL_CORES,
                                  specs[str(where)],
                                  arrivals, seed=seeds[0],
                                  target_scale=TARGET_SCALE, tables=tables,
                                  engine="scan", device=where, faults=faults))
            labels.append(f"faults={name}")
        return out, labels

    def rho_admission_seed(where):
        return _grid_sims(machine, pool, tables, specs[str(where)],
                          SMALL_CORES, per_rho, seeds, syn, where)

    def synergy_only(where):
        """Every lane admits by synergy: each stops at its own trips."""
        return _grid_sims(machine, pool, tables, specs[str(where)],
                          SMALL_CORES, per_rho, seeds, syn, where,
                          admissions=("synergy",))

    # A scenario's CPU lane and single run on the card, by label: the
    # synergy-only grid's scenarios are the mixed grid's synergy lanes.
    cpu_lanes, singles = {}, {}
    for make in (rho_admission_seed, synergy_only, faulted):
        card, labels = make(dev)
        got = run_device_sim_batched(card, q, warmup=False, draws=LaneDraws(
            [HostDraws(s.seed, dev) for s in card]))
        if not all(lab in cpu_lanes for lab in labels):
            cpu, _ = make("cpu")
            cpu_lanes.update(zip(labels, run_device_sim_batched(
                cpu, q, warmup=False,
                draws=LaneDraws([HostDraws(s.seed, "cpu") for s in cpu]))))
        for i, lab in enumerate(labels):
            if lab not in singles:
                singles[lab] = run_device_sim(
                    card[i], q, warmup=False,
                    draws=HostDraws(card[i].seed, dev))
            alone, ref = singles[lab], cpu_lanes[lab]
            what = f"open grid capacity {capacity} {lab}"
            _same_open_run(got[i], ref, f"{what} card vs CPU")
            _same_open_run(got[i], alone, f"{what} lane vs its single run")
            bitwise = (_finish(got[i]) == _finish(alone)).all()
            st = got[i]
            faults = ""
            if st.has_faults:
                faults = (f"; {st.n_evicted} evictions, {st.n_requeued} "
                          f"requeues, {st.n_dropped} dropped, "
                          f"{st.n_retry_waiting} waiting: conservation holds")
            _line("grid", f"{what}: {st.n_arrived} arrived, {st.n_completed} "
                  f"completed, solo quanta {int(st.solo_quanta.sum())}; mean "
                  f"slowdown card {st.mean_slowdown!r} CPU "
                  f"{ref.mean_slowdown!r} single {alone.mean_slowdown!r}; "
                  f"integer logs identical, finish quanta within 1e-4 (lane "
                  f"and single run bit for bit: {bool(bitwise)}){faults}")
            if st.n_completed == 0:
                raise AssertionError(f"{what}: no job completed")


def _finish(stats):
    import numpy as np

    return np.array([r.finish_q for r in sorted(stats.completed,
                                                key=lambda r: r.job_id)])


def _open_grid_main_path(dev, model, kernel_mods):
    """Phase 17: the open grid at capacity 1024.  Returns the kernels'
    launches of the grid's main-path run, and for phase 20 the grid's
    sims, stats and host syncs."""
    import numpy as np
    import torch

    from repro_torch.core import isc, matching, regression
    from repro_torch.online import (SynergyAdmission, device_sim,
                                    run_device_sim_batched)
    from repro_torch.online.device_sim import run_device_sim
    from repro_torch.smt.apps import pool_profiles
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine
    from repro_torch.smt.scan_engine import LaneDraws, ScanPolicy, TorchDraws

    machine = SMTMachine(MachineParams(), seed=0)
    pool = pool_profiles()
    tables = PhaseTables.build(pool)
    n_cores = OPEN_CAPACITY // 2
    q = OPEN_QUANTA
    syn = SynergyAdmission(machine, pool, isc.SYNPA4_R_FEBE, model)
    per_rho = OPEN_CAPACITY / mean_service_quanta(machine)
    spec = ScanPolicy(kind="synpa", method=isc.SYNPA4_R_FEBE, model=model,
                      matcher="refine", name="synpa4")
    sims, labels = _grid_sims(machine, pool, tables, spec, n_cores, per_rho,
                              GRID_SEEDS, syn, dev)
    n_lanes = len(sims)
    counters = ("NEED_FB_SYNCS", "TWO_OPT_SYNCS", "ADMIT_SYNCS")
    owners = (regression, matching, device_sim)

    def syncs_of(fn):
        before = [getattr(m, c) for m, c in zip(owners, counters)]
        out = fn()
        return out, [getattr(m, c) - b for m, c, b in zip(owners, counters,
                                                          before)]

    # A warm run, then the main path with the counts at 0.
    run_device_sim_batched(sims, q, warmup=False)
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    fb_runs = regression.FALLBACK_RUNS
    t0 = time.perf_counter()
    grid, grid_syncs = syncs_of(
        lambda: run_device_sim_batched(sims, q, warmup=False))
    first_s = time.perf_counter() - t0
    grid_fb = regression.FALLBACK_RUNS - fb_runs
    launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    if launches["pair_score"] != q or any(
            v for n, v in launches.items() if n != "pair_score"):
        raise AssertionError(f"open grid: launches {launches}, expected "
                             f"pair_score {q} (once a quantum for all "
                             f"{n_lanes} lanes) and no other")
    timed = run_device_sim_batched(sims, q, repeats=3)
    grid_ms = float(timed[0].policy_s[0]) * n_lanes * q * 1e3

    # The same scenarios one after another, each alone.
    seq, seq_syncs = [], None
    torch.cuda.synchronize()
    fb_runs = regression.FALLBACK_RUNS
    t0 = time.perf_counter()
    for sim in sims:
        st, syncs = syncs_of(lambda: run_device_sim(sim, q, warmup=False))
        seq.append(st)
        if sim.admission == "synergy" and seq_syncs is None:
            seq_syncs = syncs
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    seq_fb = regression.FALLBACK_RUNS - fb_runs
    seq_run_ms = sum(float(st.policy_s[0]) * q for st in seq) * 1e3
    _line("grid", f"capacity {OPEN_CAPACITY}, {q} quanta, {n_lanes} lanes "
          f"(rho {GRID_RHOS} x {GRID_ADMISSIONS} x seeds {GRID_SEEDS}): grid "
          f"wall {grid_ms:.3f} ms (median of 3 after a warm run), "
          f"{grid_ms / (n_lanes * q):.3f} ms a lane-quantum, "
          f"{grid_ms / q:.3f} ms a quantum; first main-path run "
          f"{first_s:.3f} s; the {n_lanes} scenarios one after another "
          f"through run_device_sim: {seq_ms:.3f} ms in all ({seq_run_ms:.3f} "
          f"ms inside the runs), {seq_ms / (n_lanes * q):.3f} ms a "
          f"lane-quantum; {seq_ms / grid_ms:.2f}x the grid; launches "
          f"{launches}")
    for i, lab in enumerate(labels):
        a, b = grid[i], seq[i]
        same = True
        try:
            _same_open_run(a, b, f"open grid {lab}")
        except AssertionError as err:
            same = False
            _line("grid", f"{lab}: parts from its sequential twin: {err}; "
                  f"{_first_divergence(a, b)}")
        _line("grid", f"{lab}: {a.n_arrived} arrived, {a.n_completed} "
              f"completed; slowdown mean {a.mean_slowdown!r} p95 "
              f"{a.slowdown_percentile(95.0)!r}; mean queue depth "
              f"{a.mean_queue_depth!r}; sequential twin mean "
              f"{b.mean_slowdown!r}; integer logs equal to the twin's: "
              f"{same}")
        if not same:
            raise AssertionError(f"open grid {lab}: the lane parts from its "
                                 "sequential twin")
        if not (a.n_completed > 0 and math.isfinite(a.mean_slowdown)):
            raise AssertionError(f"open grid {lab}: no completed job")
    grid_per_q = [s / q for s in grid_syncs]
    _line("grid", f"host syncs of the grid's main-path run: fallback flag "
          f"{grid_syncs[0]}, 2-opt flag {grid_syncs[1]}, admission count "
          f"{grid_syncs[2]} ({grid_per_q[0]:g}, {grid_per_q[1]:g} and "
          f"{grid_per_q[2]:g} a quantum); one synergy lane alone: "
          f"{seq_syncs}; the heavy-ball fallback ran in {grid_fb} of the "
          f"grid's {q} quanta (some lane flagged a row), and in {seq_fb} of "
          f"the {n_lanes * q} quanta of the sequential runs")
    if grid_syncs[0] != q or grid_syncs[2] != q or any(
            g > s for g, s in zip(grid_syncs, seq_syncs)):
        raise AssertionError(f"open grid: syncs {grid_syncs} against one "
                             f"lane's {seq_syncs}")

    # adjacent on the same grid: synpa4 must beat it in the fifo lanes at
    # rho 1.2.
    adj_spec = ScanPolicy(kind="adjacent", name="adjacent")
    adj_sims, _ = _grid_sims(machine, pool, tables, adj_spec, n_cores,
                             per_rho, GRID_SEEDS, syn, dev)
    adj = run_device_sim_batched(adj_sims, q, warmup=False)
    lanes = [i for i, lab in enumerate(labels)
             if lab.startswith(f"rho={GRID_RHOS[-1]}/fifo/")]
    ours = float(np.mean([grid[i].mean_slowdown for i in lanes]))
    theirs = float(np.mean([adj[i].mean_slowdown for i in lanes]))
    _line("grid", f"rho {GRID_RHOS[-1]} fifo lanes: synpa4 mean slowdown "
          f"{ours!r} (lanes {[grid[i].mean_slowdown for i in lanes]}) "
          f"against adjacent {theirs!r} (lanes "
          f"{[adj[i].mean_slowdown for i in lanes]})")
    if not ours < theirs:
        raise AssertionError("open grid: synpa4 does not beat adjacent in "
                             "the fifo lanes at rho 1.2")

    def fb_profile(fn):
        """``_device_profile`` of ``fn``, and the heavy-ball fallback runs
        inside its profiled call."""
        runs = []

        def counted():
            fb0 = regression.FALLBACK_RUNS
            fn()
            runs.append(regression.FALLBACK_RUNS - fb0)

        return _device_profile(counted) + (runs[-1],)

    # Where one grid run's time goes, and its host syncs audited.
    run = _grid_run(sims, q)
    run()
    wall, seen, dev_us, fb_grid = fb_profile(run)
    busy_ms = sum(dev_us(e) for e in seen) / 1e3
    n_kernels = sum(e.count for e in seen)
    _line("profile", f"one open grid run ({n_lanes} lanes, {q} quanta) "
          f"under the profiler: wall {wall * 1e3:.3f} ms, {n_kernels} kernels "
          f"({n_kernels / q:.1f} a quantum), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}% of the profiled wall)")
    for e in sorted(seen, key=dev_us, reverse=True)[:10]:
        _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:100]}")
    # One synergy lane alone, the launch count the grid's is held to.
    lab = f"rho={GRID_RHOS[-1]}/synergy/seed={GRID_SEEDS[0]}"
    alone = _grid_run([sims[labels.index(lab)]], q)
    alone()
    wall1, seen1, dev_us1, fb_one = fb_profile(alone)
    k1 = sum(e.count for e in seen1)
    busy1 = sum(dev_us1(e) for e in seen1) / 1e3
    _line("profile", f"one lane alone ({lab}) under the profiler: wall "
          f"{wall1 * 1e3:.3f} ms, {k1 / q:.1f} kernels a quantum, device "
          f"busy {busy1:.3f} ms ({100 * busy1 / (wall1 * 1e3):.1f}%); the "
          f"grid launches {n_kernels / max(k1, 1):.2f}x its kernels for "
          f"{n_lanes} lanes")
    # The synergy lanes alone as one grid (one rule, no fifo), held to
    # their sequential twins, and the draws alone: together they break
    # the grid's extra launches down.
    syn_idx = [i for i, lb in enumerate(labels) if "/synergy/" in lb]
    syn_sims = [sims[i] for i in syn_idx]
    for k, st in enumerate(run_device_sim_batched(syn_sims, q,
                                                  warmup=False)):
        _same_open_run(st, seq[syn_idx[k]],
                       f"open synergy grid {labels[syn_idx[k]]}")
    syn_run = _grid_run(syn_sims, q)    # warm: the checked run above
    wall_s, seen_s, dev_us_s, fb_syn = fb_profile(syn_run)
    k_syn = sum(e.count for e in seen_s)
    busy_s = sum(dev_us_s(e) for e in seen_s) / 1e3

    def draw_kernels(n: int) -> float:
        """Kernels a quantum of ``n`` lanes' default draws alone."""
        draws = LaneDraws([TorchDraws(s.seed, dev) for s in sims[:n]])
        lam = torch.full((n, OPEN_CAPACITY), 20.0, device=dev)

        def draw_all():
            for qq in range(q):
                draws.noise(qq, OPEN_CAPACITY)
                draws.phase(qq, lam)

        draw_all()
        return sum(e.count for e in _device_profile(draw_all)[1]) / q

    d_all, d_syn, d_one = (draw_kernels(n)
                           for n in (n_lanes, len(syn_idx), 1))
    # One heavy-ball fallback run (its launches do not depend on shape).
    frac = torch.as_tensor(np.random.default_rng(0).dirichlet(
        np.ones(4), (2, 512)).astype(np.float32), device=dev)

    def one_fallback():
        hb_i, hb_j = regression._hb_best_of(model, frac[0], frac[1], 80, 1.5)
        regression.inverse_residual(model, frac[0], frac[1], hb_i, hb_j)

    one_fallback()
    k_fb = sum(e.count for e in _device_profile(one_fallback)[1])
    adm = np.array([grid[i].admissions for i in syn_idx])
    trips_grid = int(adm.max(0).sum())
    trips_one = int(grid[labels.index(lab)].admissions.sum())
    _line("profile", f"the {len(syn_idx)} synergy lanes alone as one grid: "
          f"lanes equal their sequential twins; wall {wall_s * 1e3:.3f} ms, "
          f"{k_syn / q:.1f} kernels a quantum, device busy {busy_s:.3f} ms "
          f"({100 * busy_s / (wall_s * 1e3):.1f}%)")
    _line("profile", f"draws alone, kernels a quantum: {d_all:.1f} for "
          f"{n_lanes} lanes, {d_syn:.1f} for {len(syn_idx)}, {d_one:.1f} for "
          f"one; synergy trips (the busiest synergy lane's admissions) "
          f"{trips_grid} in the grid's {q} quanta against the lone lane's "
          f"{trips_one}; heavy-ball fallback runs in the profiled runs: "
          f"grid {fb_grid}, synergy grid {fb_syn}, lone lane {fb_one}, "
          f"{k_fb} kernels each")
    fifo_sel = ((n_kernels - k_syn) / q - (d_all - d_syn)
                - (fb_grid - fb_syn) * k_fb / q)
    trips = (k_syn - k1) / q - (d_syn - d_one) - (fb_syn - fb_one) * k_fb / q
    _line("profile", f"the grid's {(n_kernels - k1) / q:.1f} kernels a "
          f"quantum over one synergy lane's: draws of {n_lanes - 1} more "
          f"lanes {d_all - d_one:.1f}; heavy-ball fallback "
          f"{(fb_grid - fb_one) * k_fb / q:.1f}; fifo's rule and the "
          f"per-lane selection {fifo_sel:.1f}; the synergy lanes' trips "
          f"and trip mask {trips:.1f}")
    counted0 = sum(getattr(m, c) for m, c in zip(owners, counters))
    warned = _audited(run)
    torch.cuda.synchronize()
    counted = sum(getattr(m, c) for m, c in zip(owners, counters)) - counted0
    _line("syncs", f"one open grid run ({n_lanes} lanes): {len(warned)} sync "
          f"warnings, {counted} syncs counted (fallback, 2-opt and "
          "admission flags)")
    if len(warned) != counted:
        for msg in sorted(set(warned)):
            _line("syncs", msg[:200])
        raise AssertionError("uncounted host syncs in the open grid")
    return launches, dict(sims=sims, stats=grid, syncs=grid_syncs)


def _batched_race(dev, model, kernel_mods, race_res, race_per_q):
    """Phase 18: the closed race over seed lanes, and the card's draws.
    Returns the kernels' launches of the batched race's main-path run."""
    import numpy as np
    import torch

    from repro_torch.core import isc
    from repro_torch.smt import scan_engine
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine
    from repro_torch.smt.workloads import scaled_workload

    machine = SMTMachine(MachineParams(), seed=0)
    params = machine.params
    profiles = scaled_workload(N_APPS, seed=N_APPS)
    tables = PhaseTables.build(profiles)
    policies = _policies(model, scan_engine, isc)
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = scan_engine.run_quanta_multi_batched(
        machine, profiles, policies, RACE_SEEDS, n_quanta=N_QUANTA,
        tables=tables, device=dev, repeats=0)
    first_s = time.perf_counter() - t0
    launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    if launches["pair_score"] != N_QUANTA - 1 or any(
            v for n, v in launches.items() if n != "pair_score"):
        raise AssertionError(f"batched race: launches {launches}")

    def close(a, b):
        return abs(a - b) <= 1e-4 * abs(b)

    singles = {RACE_SEEDS[0]: race_res}
    for sd in RACE_SEEDS[1:]:
        singles[sd] = scan_engine.run_quanta_scan(
            params, profiles, policies, n_quanta=N_QUANTA, seed=sd,
            device=dev, repeats=0)
    for i, sd in enumerate(RACE_SEEDS):
        for name in policies:
            b, s = lanes[name][i], singles[sd][name]
            ok = (close(b.mean_true_slowdown, s.mean_true_slowdown)
                  and close(b.total_retired, s.total_retired))
            _line("batched", f"N={N_APPS} seed {sd} {name}: lane mean true "
                  f"slowdown {b.mean_true_slowdown!r}, run_quanta_scan "
                  f"{s.mean_true_slowdown!r}; retired {b.total_retired!r} "
                  f"and {s.total_retired!r}; bit for bit: "
                  f"{b.total_retired == s.total_retired and b.mean_true_slowdown == s.mean_true_slowdown}")
            if not ok:
                raise AssertionError(f"batched race seed {sd} {name}: the "
                                     "lane differs from run_quanta_scan past "
                                     "rtol 1e-4")
    one = scan_engine.run_quanta_multi_batched(
        machine, profiles, policies, RACE_SEEDS[:1], n_quanta=N_QUANTA,
        tables=tables, device=dev, repeats=0)
    for name in policies:
        b, s = one[name][0], race_res[name]
        if not (b.total_retired == s.total_retired
                and b.mean_true_slowdown == s.mean_true_slowdown
                and np.array_equal(b.ipc, s.ipc)):
            raise AssertionError(f"one-lane batched race {name} differs from "
                                 "phase 6 bit for bit")
    timed = scan_engine.run_quanta_multi_batched(
        machine, profiles, policies, RACE_SEEDS, n_quanta=N_QUANTA,
        tables=tables, device=dev, repeats=3)
    per_lane_q = timed["synpa4"][0].machine_s_per_quantum
    _line("batched", f"a one-lane batch equals phase 6 bit for bit; "
          f"{len(RACE_SEEDS)} seed lanes: {per_lane_q * 1e3:.3f} ms a "
          f"lane-quantum (median of 3 after a warm run; 3 policies), "
          f"{per_lane_q * len(RACE_SEEDS) * 1e3:.3f} ms a quantum for all "
          f"lanes, against phase 6's {race_per_q * 1e3:.3f} ms a quantum for "
          f"one seed ({race_per_q / per_lane_q:.2f}x a lane); first run "
          f"{first_s:.3f} s; launches {launches}")

    # The card's draws against the reference's distributions: the counter
    # noise's log-ratio moments, and a free-running static race against
    # the CPU's.
    n = 64
    small = scaled_workload(n, seed=n)
    dt = scan_engine.DeviceTables.build(PhaseTables.build(small), dev)
    idx = torch.arange(n, device=dev)
    ph = torch.zeros(n, dtype=torch.int64, device=dev)
    comps = scan_engine._corun_components_scan(dt, ph, idx.flip(0), params)
    cycles = float(np.float32(params.quantum_cycles))
    base = scan_engine._pmu_counters_scan(comps, dt.omega, dt.retire, cycles,
                                          params)
    draws = scan_engine.TorchDraws(0, dev)
    logs = torch.cat([torch.log(scan_engine._pmu_counters_scan(
        comps, dt.omega, dt.retire, cycles, params, draws.noise(q, n))[:, 1:]
        / base[:, 1:]).ravel() for q in range(200)]).double().cpu().numpy()
    sigma = params.noise_sigma
    mean_lim = 3 * sigma / math.sqrt(logs.size)
    # The phase-length draws at the pool's means, standardised: Poisson
    # draws have mean 0 and variance 1.
    live = (torch.arange(dt.duration.shape[1], device=dev)
            < dt.n_phases[:, None])
    lam = dt.duration[live]
    x = torch.stack([draws.phase(q, lam) for q in range(200)]).double()
    z = ((x - lam.double()) / lam.double().sqrt()).cpu().numpy().ravel()
    z_lim = 3 / math.sqrt(z.size)
    integral = bool((x >= 0).all()) and bool((x == x.round()).all())
    static = {"static": scan_engine.ScanPolicy(kind="static")}
    card = scan_engine.run_quanta_scan(params, small, static, n_quanta=40,
                                       seed=9, device=dev, repeats=0)["static"]
    cpu = scan_engine.run_quanta_scan(params, small, static, n_quanta=40,
                                      seed=9, device="cpu",
                                      repeats=0)["static"]
    _line("draws", f"TorchDraws on the card, counter noise over 200 quanta "
          f"x {n} slots x 4 columns: log-ratio mean {logs.mean():.3e} (limit "
          f"{mean_lim:.3e}), std {logs.std():.6f} against sigma {sigma} "
          f"(limit 5%); phase draws over 200 quanta x {lam.numel()} phases: "
          f"standardised mean {z.mean():.3e} (limit {z_lim:.3e}), variance "
          f"{z.var():.6f} against 1 (limit 5%), whole and non-negative: "
          f"{integral}; static race N={n}, 40 quanta, seed 9: card mean true "
          f"slowdown {card.mean_true_slowdown!r}, IPC geomean "
          f"{card.ipc_geomean!r}; CPU {cpu.mean_true_slowdown!r} and "
          f"{cpu.ipc_geomean!r} (limit 3%)")
    if not (abs(logs.mean()) < mean_lim
            and abs(logs.std() - sigma) < 0.05 * sigma
            and abs(z.mean()) < z_lim and abs(z.var() - 1.0) < 0.05
            and integral
            and abs(card.mean_true_slowdown - cpu.mean_true_slowdown)
            < 0.03 * cpu.mean_true_slowdown
            and abs(card.ipc_geomean - cpu.ipc_geomean)
            < 0.03 * cpu.ipc_geomean):
        raise AssertionError("the card's draws are not distribution-equal")
    return launches


def _bitwise_open(a, b, what: str) -> None:
    """Two open runs equal bit for bit: phase 12's integer logs, and every
    finish quantum and the mean slowdown exactly."""
    import numpy as np

    _same_open_run(a, b, what)
    if not (np.array_equal(_finish(a), _finish(b))
            and (a.mean_slowdown == b.mean_slowdown
                 or (math.isnan(a.mean_slowdown)
                     and math.isnan(b.mean_slowdown)))):
        raise AssertionError(f"{what}: finish quanta or mean slowdown differ")
    if b.has_faults:
        for name in ("evictions", "requeues", "failures", "recoveries",
                     "straggling"):
            if not np.array_equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"{what}: {name} differs")


#: Ring columns whose values are integers, held exactly card against CPU;
#: the GN columns are held to the plateau limit (``_ring_close``).
RING_INT = ("queue_head", "queue_tail", "queue_depth", "admissions",
            "departures", "active", "solo", "repair_dirty", "two_opt_rounds",
            "failures", "recoveries", "evictions", "requeues", "straggling")


def _ring_close(got, want, fields, what: str) -> float:
    """A ring of the card against the CPU's on the same draws: integer
    columns exact, float columns within rtol 1e-4 (sums run in each
    device's order); the GN diagnostics within the plateau limit of
    ROADMAP §3 (plateaued rows stop at float-dependent points): step
    counts and fallbacks within 1, the worst residual within rtol 1e-3
    (atol 1e-7).  Returns the largest relative difference of the float
    columns."""
    import numpy as np

    worst = 0.0
    for k, f in enumerate(fields):
        g, w = got[..., k], want[..., k]
        if f in RING_INT:
            ok = np.array_equal(g, w)
        elif f in ("gn_iters_mean", "gn_iters_max", "gn_fallbacks"):
            ok = bool(np.all(np.abs(g - w) <= 1.0))
        elif f == "gn_residual_max":
            ok = bool(np.all(np.abs(g - w) <= 1e-7 + 1e-3 * np.abs(w)))
        else:
            ok = bool(np.all(np.abs(g - w) <= 1e-12 + 1e-4 * np.abs(w)))
            worst = max(worst, float(np.max(
                np.abs(g - w) / np.maximum(np.abs(w), 1e-30), initial=0.0)))
        if not ok:
            raise AssertionError(f"{what}: ring column {f} differs card vs "
                                 f"CPU past its limit: {g!r} vs {w!r}")
    return worst


def _app_ring_close(got, want, what: str) -> float:
    """A per-app ring of the card against the CPU's: ids exact, slowdowns
    within rtol 1e-4, the residual (a difference of the two) within 1e-4
    of the largest prediction, the ST estimates within 1e-4 (the plateau
    limit).  Returns the slowdowns' largest relative difference."""
    import numpy as np

    if not np.array_equal(got[..., :2], want[..., :2]):
        raise AssertionError(f"{what}: app or partner ids differ")
    g, w = got[..., 2:4], want[..., 2:4]
    rel = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30),
                       initial=0.0))
    pred_max = max(float(np.abs(want[..., 2]).max(initial=0.0)), 1.0)
    if not (rel <= 1e-4
            and np.abs(got[..., 4] - want[..., 4]).max(initial=0.0)
            <= 1e-4 * pred_max
            and np.abs(got[..., 5:] - want[..., 5:]).max(initial=0.0)
            <= 1e-4):
        raise AssertionError(f"{what}: per-app slowdowns, residuals or ST "
                             "estimates past their limits")
    return rel


def _closed_rings(dev, model, kernel_mods, race_res, race_syncs):
    """Phase 19: phase 6's race with both rings.  Returns the kernels'
    launches of the ringed race."""
    import numpy as np
    import torch

    from repro_torch.core import isc, matching, regression
    from repro_torch.obs import accuracy
    from repro_torch.obs.telemetry import APP_FIELDS, CLOSED_FIELDS
    from repro_torch.smt import scan_engine
    from repro_torch.smt.machine import MachineParams, PhaseTables
    from repro_torch.smt.workloads import scaled_workload

    params = MachineParams()
    profiles = scaled_workload(N_APPS, seed=N_APPS)
    policies = _policies(model, scan_engine, isc)
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rings = scan_engine.run_quanta_scan(
        params, profiles, policies, n_quanta=N_QUANTA, seed=RACE_SEED,
        device=dev, repeats=0, app_telemetry=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    if launches["pair_score"] != N_QUANTA - 1 or any(
            v for n, v in launches.items() if n != "pair_score"):
        raise AssertionError(f"race with rings: launches {launches}")
    for name, r in rings.items():
        w = race_res[name]
        if not (r.total_retired == w.total_retired
                and r.mean_true_slowdown == w.mean_true_slowdown
                and np.array_equal(r.ipc, w.ipc)):
            raise AssertionError(f"race with rings {name}: differs from "
                                 "phase 6")
        tl, app = r.telemetry, r.app_telemetry
        if (tl.data.shape != (N_QUANTA, len(CLOSED_FIELDS))
                or app.data.shape != (N_QUANTA, N_APPS, len(APP_FIELDS))
                or not np.isfinite(tl.data).all()
                or not np.isfinite(app.data).all()):
            raise AssertionError(f"race with rings {name}: ring shapes "
                                 f"{tl.data.shape}, {app.data.shape}")
        if abs(tl.timeline("real_slowdown_mean").mean()
               - r.mean_true_slowdown) > 1e-5 * r.mean_true_slowdown:
            raise AssertionError(f"race with rings {name}: the ring's "
                                 "slowdown means are not the race's")
        _line("rings", f"N={N_APPS} {name}: results equal phase 6 bit for "
              f"bit; rings {tl.data.shape} and {app.data.shape}; real "
              f"slowdown max {float(tl.timeline('real_slowdown_max').max())!r}, "
              f"pred cost mean by quantum "
              f"{[round(float(x), 4) for x in tl.timeline('pred_cost_mean')]}"
              f", 2-opt rounds {tl.timeline('two_opt_rounds').astype(int).tolist()}"
              f", GN steps max {tl.timeline('gn_iters_max').astype(int).tolist()}"
              f", fallback rows {int(tl.timeline('gn_fallbacks').sum())}")
    # What the rings cost: the race with and without them, in turns.
    walls = {False: [], True: []}
    for ringed in (False, True, True, False):
        walls[ringed].append(scan_engine.run_quanta_scan(
            params, profiles, policies, n_quanta=N_QUANTA, seed=RACE_SEED,
            device=dev, repeats=3, app_telemetry=ringed)[
                "synpa4"].machine_s_per_quantum * 1e3)
    _line("rings", f"first ringed race {first_s:.3f} s; launches {launches}; "
          f"wall per quantum (3 policies, median of 3 after a warm run, "
          f"taken off, on, on, off): without rings {walls[False]} ms, with "
          f"both rings {walls[True]} ms")

    # Host syncs of one ringed race: the ring-off race's, every one counted.
    tables = PhaseTables.build(profiles)
    race = scan_engine.build_race(tables, params, list(policies.values()),
                                  N_QUANTA, dev, app_telemetry=True)
    dt, init_mpart, init_st, draws = _race_inputs(tables, policies, dev)
    torch.cuda.synchronize()
    counted0 = regression.NEED_FB_SYNCS + matching.TWO_OPT_SYNCS
    seen = _audited(lambda: race(dt, init_mpart, init_st, draws))
    torch.cuda.synchronize()
    counted = regression.NEED_FB_SYNCS + matching.TWO_OPT_SYNCS - counted0
    _line("syncs", f"one race with both rings: {len(seen)} sync warnings, "
          f"{counted} syncs counted; without rings (phase 6) {race_syncs}")
    if len(seen) != counted or counted != race_syncs:
        for msg in sorted(set(seen)):
            _line("syncs", msg[:200])
        raise AssertionError("the rings changed the race's host syncs")

    # The card's rings against the CPU's at N = 16, on the same draws.
    small = scaled_workload(16, seed=16)
    card = scan_engine.run_quanta_scan(
        params, small, policies, n_quanta=N_QUANTA, seed=5, device=dev,
        draws=HostDraws(5, dev), repeats=0, app_telemetry=True)
    cpu = scan_engine.run_quanta_scan(
        params, small, _policies(model.to("cpu"), scan_engine, isc),
        n_quanta=N_QUANTA, seed=5, device="cpu", draws=HostDraws(5, "cpu"),
        repeats=0, app_telemetry=True)
    for name in policies:
        worst = _ring_close(card[name].telemetry.data,
                            cpu[name].telemetry.data, CLOSED_FIELDS,
                            f"N=16 {name}")
        worst_app = _app_ring_close(card[name].app_telemetry.data,
                                    cpu[name].app_telemetry.data,
                                    f"N=16 {name} per-app")
        st_err = float(np.abs(card[name].app_telemetry.data[..., 5:]
                              - cpu[name].app_telemetry.data[..., 5:]).max())
        same = (np.array_equal(card[name].telemetry.data,
                               cpu[name].telemetry.data)
                and np.array_equal(card[name].app_telemetry.data,
                                   cpu[name].app_telemetry.data))
        _line("rings", f"N=16 {name}: card's rings against the CPU's on the "
              f"same draws: integer columns equal, float columns within "
              f"{worst:.3e} (scalar) and {worst_app:.3e} (per-app) relative, "
              f"ST estimates within {st_err:.3e}; bit for bit: {same}")

    rep = accuracy.accuracy_report(rings["synpa4"].app_telemetry, window=4)
    ov = rep["overall"]
    worst_app = max(rep["per_app"].items(), key=lambda kv: kv[1]["mape"])
    _line("accuracy", f"N={N_APPS} synpa4 per-app prediction error over "
          f"{ov['n']} scored events: MAPE {ov['mape']!r}, bias "
          f"{ov['bias']!r}, RMSE {ov['rmse']!r}; worst app {worst_app[0]} "
          f"MAPE {worst_app[1]['mape']!r} over {worst_app[1]['n']}; "
          f"P(|err| > 5%) {rep['ccdf']['p_gt'][2]!r}, P(|err| > 10%) "
          f"{rep['ccdf']['p_gt'][3]!r}; drift windows of 4 quanta MAPE "
          f"{rep['drift']['mape']}, flagged {rep['drift']['flagged']}")
    if ov["n"] == 0:
        raise AssertionError("synpa4's app ring scored no prediction")
    return launches


def _open_rings(dev, kernel_mods, open_runs, grid_runs):
    """Phase 20: phase 13's synpa runs and phase 17's grid with both rings.
    Returns the kernels' launches of the three runs and of the grid."""
    import numpy as np
    import torch

    from repro_torch.core import matching, regression
    from repro_torch.obs.telemetry import APP_FIELDS, OPEN_FIELDS
    from repro_torch.online import device_sim, run_device_sim_batched
    from repro_torch.smt.scan_engine import LaneDraws, TorchDraws

    counters = ("NEED_FB_SYNCS", "TWO_OPT_SYNCS", "ADMIT_SYNCS")
    owners = (regression, matching, device_sim)

    def counted(fn):
        before = [getattr(m, c) for m, c in zip(owners, counters)]
        out = fn()
        return out, [getattr(m, c) - b
                     for m, c, b in zip(owners, counters, before)]

    def timelines_match(st, what):
        tl = st.telemetry
        for col, series in (("queue_depth", st.queue_depth),
                            ("active", st.active),
                            ("departures", st.departures),
                            ("admissions", st.admissions),
                            ("solo", st.solo_quanta)):
            if not np.array_equal(tl.timeline(col), series):
                raise AssertionError(f"{what}: ring column {col} is not the "
                                     "stats' timeline")
        if st.has_faults and not np.array_equal(tl.timeline("evictions"),
                                                st.evictions):
            raise AssertionError(f"{what}: ring evictions differ")
        valid = st.app_telemetry.valid()
        if not np.array_equal(valid.sum(1), st.active):
            raise AssertionError(f"{what}: app ring occupancy differs")

    total = {n: 0 for n in kernel_mods}
    for name in ("synpa4 fifo", "synpa4 synergy",
                 "synpa4 fifo combined faults"):
        sim = open_runs["sims"][name]
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, syncs = counted(lambda: sim.run(OPEN_QUANTA, warmup=False,
                                            app_telemetry=True))
        run_s = time.perf_counter() - t0
        for n, m in kernel_mods.items():
            total[n] += m.LAUNCHES
        if kernel_mods["pair_score"].LAUNCHES != OPEN_QUANTA:
            raise AssertionError(f"open {name} with rings: pair_score "
                                 f"launched {kernel_mods['pair_score'].LAUNCHES}")
        _bitwise_open(st, open_runs["stats"][name], f"open {name} with rings")
        if syncs != open_runs["syncs"][name]:
            raise AssertionError(f"open {name}: syncs with rings {syncs}, "
                                 f"without {open_runs['syncs'][name]}")
        timelines_match(st, f"open {name}")
        tl = st.telemetry
        if (tl.data.shape != (OPEN_QUANTA, len(OPEN_FIELDS))
                or st.app_telemetry.data.shape
                != (OPEN_QUANTA, OPEN_CAPACITY, len(APP_FIELDS))):
            raise AssertionError(f"open {name}: ring shapes")
        _line("rings", f"capacity {OPEN_CAPACITY} {name}: logs equal phase "
              f"13 bit for bit; host syncs {syncs} as without rings; ring "
              f"columns queue, active, solo, admissions and departures equal "
              f"the stats' timelines; real slowdown mean over quanta "
              f"{float(tl.timeline('real_slowdown_mean').mean())!r}, pred cost mean "
              f"{float(tl.timeline('pred_cost_mean').mean())!r}; repair dirty "
              f"{int(tl.timeline('repair_dirty').sum())} in all, 2-opt rounds "
              f"{int(tl.timeline('two_opt_rounds').sum())}, fallback rows "
              f"{int(tl.timeline('gn_fallbacks').sum())}, evictions "
              f"{int(tl.timeline('evictions').sum())}; one run {run_s:.3f} s "
              f"(first, unwarmed)")

    # What the rings add to a run: kernels a quantum and device time of
    # the fifo run's first RING_PROFILE_QUANTA quanta without and with
    # them, under the profiler (a short window: the profiler's own
    # bookkeeping of a whole run takes tens of seconds).
    sim = open_runs["sims"]["synpa4 fifo"]
    q_prof = RING_PROFILE_QUANTA
    prep = device_sim._prepare_inputs(sim, q_prof)
    profiled = {}
    for ringed in (False, True):
        run = device_sim._grid_race(
            [sim], [prep], q_prof, prep["j_pad"],
            (prep["syn_cost"], prep["syn_mean"], prep["syn_stacks"]),
            LaneDraws([TorchDraws(sim.seed, dev)]), app_telemetry=ringed)
        run()
        wall, seen, dev_us = _device_profile(run)
        profiled[ringed] = (wall * 1e3,
                            sum(e.count for e in seen) / q_prof,
                            sum(dev_us(e) for e in seen) / 1e3)
    _line("profile", f"the open synpa4 fifo run's first {q_prof} quanta "
          f"under the profiler, without and with both rings: "
          f"{profiled[False][1]:.1f} and "
          f"{profiled[True][1]:.1f} kernels a quantum "
          f"(+{profiled[True][1] - profiled[False][1]:.1f}); device busy "
          f"{profiled[False][2]:.3f} and {profiled[True][2]:.3f} ms; "
          f"profiled wall {profiled[False][0]:.3f} and "
          f"{profiled[True][0]:.3f} ms")

    sims, q = grid_runs["sims"], OPEN_QUANTA
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    grid, syncs = counted(lambda: run_device_sim_batched(
        sims, q, warmup=False, app_telemetry=True))
    grid_launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    if grid_launches["pair_score"] != q:
        raise AssertionError(f"open grid with rings: launches {grid_launches}")
    for i, st in enumerate(grid):
        _bitwise_open(st, grid_runs["stats"][i], f"open grid lane {i} with "
                      "rings")
        timelines_match(st, f"open grid lane {i}")
    if syncs != grid_runs["syncs"]:
        raise AssertionError(f"open grid: syncs with rings {syncs}, without "
                             f"{grid_runs['syncs']}")
    single = device_sim.run_device_sim(sims[0], q, warmup=False,
                                       app_telemetry=True)
    _same_open_run(grid[0], single, "open grid lane 0 against its single run")
    worst = _ring_close(grid[0].telemetry.data, single.telemetry.data,
                        OPEN_FIELDS, "open grid lane 0 against its single run")
    same = (np.array_equal(grid[0].telemetry.data, single.telemetry.data)
            and np.array_equal(grid[0].app_telemetry.data,
                               single.app_telemetry.data))
    _line("rings", f"the {len(sims)}-lane grid with rings: every lane's logs "
          f"equal phase 17's bit for bit; host syncs {syncs} as without "
          f"rings; lane 0's ring against its single run: integer columns "
          f"equal, float columns within {worst:.3e} relative; bit for bit: "
          f"{same}; launches {grid_launches}")
    return total, grid_launches


def _checkpointed_run(dev, kernel_mods, open_runs):
    """Phase 21: phase 13's faulted synpa4 fifo run in segments of
    ``CKPT_SEG`` quanta with a snapshot after each.  Returns the kernels'
    launches of the uninterrupted run."""
    import tempfile

    import torch

    from repro_torch.core import matching, regression
    from repro_torch.obs import trace as obs_trace
    from repro_torch.online import device_sim, run_device_sim_checkpointed

    name = "synpa4 fifo combined faults"
    sim, ref = open_runs["sims"][name], open_runs["stats"][name]
    q, seg = OPEN_QUANTA, CKPT_SEG
    counters = ("NEED_FB_SYNCS", "TWO_OPT_SYNCS", "ADMIT_SYNCS",
                "CKPT_SYNCS")
    owners = (regression, matching, device_sim, device_sim)

    def counts():
        return [getattr(m, c) for m, c in zip(owners, counters)]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0
        before = counts()
        obs_trace.enable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = run_device_sim_checkpointed(sim, q, seg, f"{tmp}/full")
        wall_s = time.perf_counter() - t0
        obs_trace.disable()
        spans = obs_trace.breakdown()
        obs_trace.clear()
        syncs = [a - b for a, b in zip(counts(), before)]
        launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
        if launches["pair_score"] != q:
            raise AssertionError(f"checkpointed run: launches {launches}")
        _bitwise_open(full, ref, "checkpointed run against run_device_sim")
        if syncs[:3] != open_runs["syncs"][name] or syncs[3] != q // seg:
            raise AssertionError(f"checkpointed run: syncs {syncs}, "
                                 f"run_device_sim's {open_runs['syncs'][name]}"
                                 f" plus {q // seg} snapshots")
        snap_bytes = sum(
            os.path.getsize(os.path.join(dp, f))
            for dp, _, fs in os.walk(f"{tmp}/full/step_{q:08d}") for f in fs)

        # Killed after one segment, then resumed.
        if run_device_sim_checkpointed(sim, q, seg, f"{tmp}/kill",
                                       max_segments=1) is not None:
            raise AssertionError("max_segments=1 did not stop the run")
        resumed = run_device_sim_checkpointed(sim, q, seg, f"{tmp}/kill")
        _bitwise_open(resumed, full, "killed and resumed run")

        # The newest snapshot corrupted: resume from the one before.
        with open(f"{tmp}/full/step_{q:08d}/arrays.npz", "r+b") as f:
            f.seek(64)
            f.write(b"\xde\xad\xbe\xef")
        ck0 = device_sim.CKPT_SYNCS
        again = run_device_sim_checkpointed(sim, q, seg, f"{tmp}/full")
        if device_sim.CKPT_SYNCS - ck0 != 1:
            raise AssertionError("a corrupt newest snapshot: the run did not "
                                 "resume from the one before")
        _bitwise_open(again, full, "run resumed past a corrupt snapshot")

        # Wall per quantum, warm, in turns: run_device_sim (one timed run
        # after its warm run) and the checkpointed run (a fresh directory
        # each time, so every call writes its three snapshots), its spans
        # splitting it into the segments (run and copy) and the snapshots.
        per_q = {"plain": [], "ckpt": []}
        split = []
        for k, what in enumerate(("plain", "ckpt", "ckpt", "plain")):
            if what == "plain":
                st = sim.run(q, repeats=1)
            else:
                obs_trace.enable()
                st = run_device_sim_checkpointed(sim, q, seg,
                                                 f"{tmp}/timed{k}")
                obs_trace.disable()
                rows = obs_trace.breakdown()
                obs_trace.clear()
                split.append(tuple(
                    rows[nm]["total_us"] / 1e3 / q
                    for nm in ("device_sim.dispatch",
                               "device_sim.checkpoint")))
            per_q[what].append(float(st.policy_s[0]) * 1e3)

        # The segment loop's host syncs, audited: the run's own plus one a
        # segment, every one counted.
        loop = device_sim._checkpointed(sim, q, seg, f"{tmp}/audit")
        torch.cuda.synchronize()
        c0 = counts()
        seen = _audited(lambda: loop(None))
        torch.cuda.synchronize()
        audit = [a - b for a, b in zip(counts(), c0)]
    _line("syncs", f"one checkpointed run ({q // seg} segments): {len(seen)} "
          f"sync warnings, {sum(audit)} syncs counted (fallback, 2-opt, "
          f"admission {audit[:3]}, snapshots {audit[3]})")
    if len(seen) != sum(audit) or audit[3] != q // seg:
        for msg in sorted(set(seen)):
            _line("syncs", msg[:200])
        raise AssertionError("uncounted host syncs in the checkpointed run")
    snap = spans["device_sim.checkpoint"]
    _line("ckpt", f"capacity {OPEN_CAPACITY} {name}, {q} quanta in segments "
          f"of {seg}: equal to phase 13's run_device_sim bit for bit; killed "
          f"after 1 segment and resumed: bit for bit; newest snapshot "
          f"corrupted: resumed from the one before, bit for bit; first run "
          f"{wall_s:.3f} s; wall per quantum in turns (plain, checkpointed, "
          f"checkpointed, plain): run_device_sim {per_q['plain']} ms, "
          f"checkpointed {per_q['ckpt']} ms, snapshots included, of which "
          f"segments (run and copy) and snapshots "
          f"{[tuple(round(x, 3) for x in t) for t in split]} ms; snapshot "
          f"write {snap['mean_us'] / 1e3:.3f} ms a segment (mean of "
          f"{snap['count']}), {snap_bytes} bytes each; host syncs {syncs}; "
          f"launches {launches}")
    return launches


#: The paper's §6.2 race (phase 22): ``benchmarks/fig9_hysched.py``'s
#: policies on three of its quick workloads, two repeats, fixed base seeds
#: (the benchmark's ``abs(hash(w))`` changes from process to process).
RACE6_WORKLOADS = {"fb0": 101, "be0": 202, "fe0": 303}
RACE6_REPEATS = 2
#: The card against the CPU on the open host loop (phase 24).
HOST_SMALL_CORES, HOST_SMALL_QUANTA = 8, 40


class _Synced:
    """Host syncs the host tier counts: the cost copy, the fallback flag,
    the 2-opt flag and the device matcher's partner copy."""

    def __init__(self):
        from repro_torch.core import matching, regression, synpa

        self.owners = ((synpa, "HOST_COST_COPIES"),
                       (regression, "NEED_FB_SYNCS"),
                       (matching, "TWO_OPT_SYNCS"),
                       (matching, "HOST_PARTNER_COPIES"))
        self.start = self.now()

    def now(self):
        return [getattr(m, c) for m, c in self.owners]

    def since(self):
        return [a - b for a, b in zip(self.now(), self.start)]


def _audited_run(fn, what: str):
    """Run ``fn`` once under the sync audit: every host sync it makes must
    be one the host tier counts.  Returns ``(fn's result, [cost copies,
    fallback flags, 2-opt flags, partner copies])``."""
    import collections

    import torch

    torch.cuda.synchronize()
    counted = _Synced()
    out = []
    seen = _sync_warnings(lambda: out.append(fn()))
    torch.cuda.synchronize()
    syncs = counted.since()
    if len(seen) != sum(syncs):
        where = collections.Counter(f"{w.filename}:{w.lineno}" for w in seen)
        for loc, k in where.most_common():
            _line("syncs", f"{k} at {loc}")
        raise AssertionError(f"{what}: {len(seen)} sync warnings, "
                             f"{sum(syncs)} counted {syncs}")
    return out[0], syncs


def _split_ms(timings):
    """Medians of the host tier's per-quantum (step, copy, matcher)
    timings, in ms."""
    import numpy as np

    t = np.asarray(timings, np.float64).reshape(-1, 3)
    return tuple(float(np.median(t[:, k])) * 1e3 for k in range(3))


def _workload_race(dev, model, kernel_mods):
    """Phase 22: the paper's §6.2 race on the card.  Returns the kernels'
    launches of the race."""
    import numpy as np

    from repro_torch.core import isc, regression
    from repro_torch.core.baselines import HySchedScheduler, LinuxScheduler
    from repro_torch.core.synpa import SynpaScheduler
    from repro_torch.smt import metrics, workloads
    from repro_torch.smt.machine import MachineParams, SMTMachine

    machine = SMTMachine(MachineParams(), seed=0)
    wls = workloads.make_workloads(SMTMachine(MachineParams(), seed=0))
    # Built before the audited race: a scheduler's construction copies
    # its constants to the card once.
    synpas = [SynpaScheduler(isc.SYNPA4_R_FEBE, model, device=dev)
              for _ in range(len(RACE6_WORKLOADS) * RACE6_REPEATS)]
    built = iter(synpas)

    policies = {"linux": LinuxScheduler, "hy-sched": HySchedScheduler,
                "SYNPA4_R-FEBE": lambda: next(built)}
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    fb0 = regression.FALLBACK_RUNS
    t0 = time.perf_counter()

    def race():
        return {w: {p: metrics.run_repeated(
            machine, workloads.workload_profiles(wls[w]), f,
            repeats=RACE6_REPEATS, base_seed=seed)
            for p, f in policies.items()}
            for w, seed in RACE6_WORKLOADS.items()}

    res, syncs = _audited_run(race, "the §6.2 race")
    race_s = time.perf_counter() - t0
    launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    steps = sum(len(s.timings) for s in synpas)
    if launches["pair_score"] != steps or any(
            v for n, v in launches.items() if n != "pair_score"):
        raise AssertionError(f"§6.2 race: launches {launches}, expected "
                             f"pair_score {steps} (one a SYNPA quantum)")
    if syncs[0] != steps or syncs[2:] != [0, 0]:
        raise AssertionError(f"§6.2 race: syncs {syncs}, expected {steps} "
                             "cost copies")
    speedups = {}
    for w, row in res.items():
        for p, st in row.items():
            if not (math.isfinite(st.makespan_s) and st.makespan_s > 0):
                raise AssertionError(f"§6.2 race {w} {p}: makespan "
                                     f"{st.makespan_s!r}")
            _line("workload", f"{w} {p}: makespan {st.makespan_s!r} s, "
                  f"average turnaround {st.avg_turnaround_s!r} s, IPC "
                  f"geomean {st.ipc_geomean!r} (repeats {st.n_runs}, kept "
                  f"{st.n_kept}, cv {st.cv:.4f})")
        speedups[w] = {p: metrics.speedup(row["linux"].makespan_s,
                                          st.makespan_s)
                       for p, st in row.items()}
    mean = {p: float(np.mean([speedups[w][p] for w in speedups]))
            for p in policies}
    _line("workload", "TT speedup over linux (makespan), per workload: "
          + "; ".join(f"{w} " + ", ".join(f"{p} {v:.4f}" for p, v in s.items())
                      for w, s in speedups.items())
          + "; mean " + ", ".join(f"{p} {v!r}" for p, v in mean.items()))
    step, copy, match = _split_ms([t for s in synpas for t in s.timings])
    _line("workload", f"{steps} SYNPA quanta, {launches['pair_score']} "
          f"pair_score launches; per quantum (medians) fused step on the "
          f"card {step:.3f} ms, cost copy {copy:.3f} ms, host matcher "
          f"{match:.3f} ms; the heavy-ball fallback ran in "
          f"{regression.FALLBACK_RUNS - fb0} of {steps} steps; host syncs: "
          f"cost copies {syncs[0]}, fallback flags {syncs[1]}, all counted; "
          f"race wall {race_s:.3f} s")
    if not mean["SYNPA4_R-FEBE"] > 1.0:
        raise AssertionError("§6.2 race: SYNPA4_R-FEBE's mean TT speedup "
                             f"over linux {mean['SYNPA4_R-FEBE']!r} <= 1")

    # The card against the CPU on fb0, first repeat's seed: the same
    # pairing every quantum, equal turnaround.
    profs = workloads.workload_profiles(wls["fb0"])
    out, logs = {}, {}
    for where in (dev, "cpu"):
        pol = SynpaScheduler(isc.SYNPA4_R_FEBE, model, device=where)
        log, inner = [], pol.schedule
        pol.schedule = lambda q, s, p, inner=inner, log=log: (
            log.append(inner(q, s, p)) or log[-1])
        out[str(where)] = SMTMachine(MachineParams(), seed=0).run_workload(
            profs, pol, seed=RACE6_WORKLOADS["fb0"])
        logs[str(where)] = log
    card, cpu = out[str(dev)], out["cpu"]
    if logs[str(dev)] != logs["cpu"]:
        q = next(k for k, (a, b) in enumerate(zip(logs[str(dev)],
                                                  logs["cpu"])) if a != b)
        raise AssertionError(f"fb0: the card's pairing differs from the "
                             f"CPU's at quantum {q}")
    err = float(np.max(np.abs(card.turnaround_s - cpu.turnaround_s)
                       / cpu.turnaround_s))
    if err > 1e-5:
        raise AssertionError(f"fb0: turnaround card vs CPU {err:.3e} rel")
    _line("workload", f"fb0 card against CPU: the same pairing in all "
          f"{len(logs['cpu'])} quanta, turnaround max rel diff {err:.3e} "
          f"(limit 1e-5), makespan card {card.makespan_s!r} CPU "
          f"{cpu.makespan_s!r}")
    return launches


def _host_race(dev, model, kernel_mods, race_res):
    """Phase 23: phase 6's cluster-scale race through the host matchers
    (``run_quanta_multi(engine="vector")``, ``SynpaScheduler``, the tiled
    matcher at N = 1024).  Returns the kernels' launches."""
    from repro_torch.core import isc, regression
    from repro_torch.core.baselines import (LinuxScheduler,
                                            RandomStaticScheduler)
    from repro_torch.core.synpa import SynpaScheduler
    from repro_torch.smt.machine import MachineParams, SMTMachine
    from repro_torch.smt.workloads import scaled_workload

    profiles = scaled_workload(N_APPS, seed=N_APPS)
    synpa = SynpaScheduler(isc.SYNPA4_R_FEBE, model, device=dev)
    policies = {"linux": LinuxScheduler, "random": RandomStaticScheduler,
                "synpa4": lambda: synpa}
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    fb0 = regression.FALLBACK_RUNS
    t0 = time.perf_counter()
    res, syncs = _audited_run(
        lambda: SMTMachine(MachineParams(), seed=0).run_quanta_multi(
            profiles, policies, n_quanta=N_QUANTA, seed=RACE_SEED,
            engine="vector"), "the host race")
    race_s = time.perf_counter() - t0
    launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    steps = len(synpa.timings)
    if launches["pair_score"] != steps or steps != N_QUANTA - 1 or any(
            v for n, v in launches.items() if n != "pair_score"):
        raise AssertionError(f"host race: launches {launches}, expected "
                             f"pair_score {N_QUANTA - 1}")
    for name, r in res.items():
        if r.ipc.shape != (N_APPS,) or not math.isfinite(
                r.mean_true_slowdown):
            raise AssertionError(f"host race {name}: bad result")
        _line("host", f"N={N_APPS} {name}: mean true slowdown "
              f"{r.mean_true_slowdown!r}, IPC geomean {r.ipc_geomean!r}; "
              f"wall per quantum: policy {r.sched_s_per_quantum * 1e3:.3f}"
              f" ms (median {r.sched_s_per_quantum_median * 1e3:.3f}), "
              f"machine {r.machine_s_per_quantum * 1e3:.3f} ms")
    step, copy, match = _split_ms(synpa.timings)
    _line("host", f"synpa4 per quantum (medians of {steps}): fused step on "
          f"the card {step:.3f} ms, cost copy {copy:.3f} ms, host matcher "
          f"(tiled) {match:.3f} ms; pair_score launches "
          f"{launches['pair_score']}; the heavy-ball fallback ran in "
          f"{regression.FALLBACK_RUNS - fb0} of {steps} steps; host syncs: "
          f"cost copies {syncs[0]}, "
          f"fallback flags {syncs[1]}, all counted; race {race_s:.3f} s")
    _line("host", f"phase 6 (scan engine, the device matcher, the port's "
          f"torch draws) synpa4 {race_res['synpa4'].mean_true_slowdown!r}, "
          f"random {race_res['random'].mean_true_slowdown!r}, linux "
          f"{race_res['linux'].mean_true_slowdown!r}: printed beside, not "
          "compared (the numpy machine draws other noise)")
    for other in ("linux", "random"):
        if not (res["synpa4"].mean_true_slowdown
                < res[other].mean_true_slowdown):
            raise AssertionError(f"host race: synpa4 does not beat {other}")
    return launches


def _same_host_run(card, cpu, what: str) -> None:
    """Two host open runs: integer logs identical, floats rtol 1e-5."""
    import numpy as np

    ints = [(r.job_id, r.app_name, r.arrive_q, r.admit_q, r.retries)
            for r in card.completed]
    if ints != [(r.job_id, r.app_name, r.arrive_q, r.admit_q, r.retries)
                for r in cpu.completed]:
        raise AssertionError(f"{what}: job logs differ card vs CPU")
    for name in ("queue_depth", "active", "solo_quanta", "arrivals",
                 "admissions", "departures"):
        if not np.array_equal(getattr(card, name), getattr(cpu, name)):
            raise AssertionError(f"{what}: {name} differs card vs CPU")
    for a, b in zip(card.completed, cpu.completed):
        if not abs(a.finish_q - b.finish_q) <= 1e-5 * abs(b.finish_q):
            raise AssertionError(f"{what}: job {a.job_id} finishes at "
                                 f"{a.finish_q!r} on the card, "
                                 f"{b.finish_q!r} on the CPU")


def _host_open(dev, model, kernel_mods, open_runs):
    """Phase 24: the open system's host event loop with
    ``StreamingAllocator`` at capacity 1024 (phase 13's cell).  Returns
    the kernels' launches over its runs."""
    import numpy as np

    from repro_torch.core import isc, regression
    from repro_torch.online import (ClusterSim, FaultProfile, LinuxOnline,
                                    PoissonArrivals, StreamingAllocator,
                                    SynergyAdmission)
    from repro_torch.smt.apps import pool_profiles
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine

    machine = SMTMachine(MachineParams(), seed=0)
    pool = pool_profiles()
    tables = PhaseTables.build(pool)
    n_cores = OPEN_CAPACITY // 2
    rate = OPEN_RHO * OPEN_CAPACITY / mean_service_quanta(machine)
    syn = SynergyAdmission(machine, pool, isc.SYNPA4_R_FEBE, model)

    def stream():
        return StreamingAllocator(isc.SYNPA4_R_FEBE, model,
                                  name="synpa4-stream", device=dev)

    runs = {
        "linux": (LinuxOnline, {}),
        "synpa4-stream fifo": (stream, {}),
        "synpa4-stream synergy": (stream, dict(admission="synergy",
                                               synergy=syn)),
        "synpa4-stream fifo combined faults": (
            stream, dict(faults=_fault_profile(FaultProfile, "combined",
                                               n_cores, OPEN_QUANTA))),
    }
    total = {n: 0 for n in kernel_mods}
    stats = {}
    for name, (make, kw) in runs.items():
        pol = make()
        sim = ClusterSim(machine, pool, n_cores, pol,
                         PoissonArrivals(rate=rate, n_pool=len(pool)),
                         seed=OPEN_SEED, target_scale=TARGET_SCALE,
                         tables=tables, engine="host", device=dev, **kw)
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0
        fb0 = regression.FALLBACK_RUNS
        t0 = time.perf_counter()
        st, syncs = _audited_run(lambda: sim.run(OPEN_QUANTA),
                                 f"open host {name}")
        wall_s = time.perf_counter() - t0
        launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
        for n in total:
            total[n] += launches[n]
        steps = len(getattr(pol, "timings", ()))
        if launches["pair_score"] != steps or any(
                v for n, v in launches.items() if n != "pair_score"):
            raise AssertionError(f"open host {name}: launches {launches}, "
                                 f"expected pair_score {steps}")
        if not (st.n_completed > 0 and math.isfinite(st.mean_slowdown)):
            raise AssertionError(f"open host {name}: no completed job")
        stats[name] = st
        split = ""
        if steps:
            step, copy, match = _split_ms(pol.timings)
            split = (f"; per SYNPA quantum (medians of {steps}) fused step "
                     f"on the card {step:.3f} ms, cost copy {copy:.3f} ms, "
                     f"host matcher {match:.3f} ms; the heavy-ball fallback "
                     f"ran in {regression.FALLBACK_RUNS - fb0} of {steps} "
                     "steps")
        faults = ""
        if st.has_faults:
            faults = (f"; faults: {int(st.failures.sum())} core failures, "
                      f"{st.n_evicted} evictions, {st.n_requeued} requeues, "
                      f"{st.n_dropped} dropped, straggler flags "
                      f"{int(st.straggler_flags.sum())} core-quanta")
        _line("hostopen", f"capacity {OPEN_CAPACITY} {name}: {st.n_arrived} "
              f"arrived, {st.n_admitted} admitted, {st.n_completed} "
              f"completed; slowdown mean {st.mean_slowdown!r} p95 "
              f"{st.slowdown_percentile(95.0)!r}; mean queue depth "
              f"{st.mean_queue_depth!r}; wall {wall_s * 1e3 / OPEN_QUANTA:.3f}"
              f" ms a quantum, policy {st.policy_us_per_quantum / 1e3:.3f} "
              f"ms (median {st.policy_us_per_quantum_median / 1e3:.3f}){split};"
              f" launches {launches['pair_score']}; host syncs: cost copies "
              f"{syncs[0]}, fallback flags {syncs[1]}, all counted{faults}")
    if not (stats["synpa4-stream fifo"].mean_slowdown
            < stats["linux"].mean_slowdown):
        raise AssertionError("open host: synpa4-stream does not beat "
                             "LinuxOnline on mean slowdown")
    scan = open_runs["stats"]
    _line("hostopen", "phase 13 (scan engine, device matcher, torch draws) "
          "mean slowdown: " + ", ".join(
              f"{k} {v.mean_slowdown!r}" for k, v in scan.items())
          + ": printed beside, not compared")

    # The card against the CPU at capacity 16: the same pairs every
    # quantum, the same job logs.
    out, logs = {}, {}
    for where, m in ((dev, model), ("cpu", model.to("cpu"))):
        alloc = StreamingAllocator(isc.SYNPA4_R_FEBE, m, device=where)
        log, inner = [], alloc.pair
        alloc.pair = lambda *a, inner=inner, log=log, **k: (
            log.append(inner(*a, **k)) or log[-1])
        sim = ClusterSim(SMTMachine(MachineParams(), seed=0), pool,
                         HOST_SMALL_CORES, alloc,
                         PoissonArrivals(rate=2.0, n_pool=len(pool)),
                         seed=SMALL_SEED, target_scale=0.1, device=where)
        out[str(where)] = sim.run(HOST_SMALL_QUANTA)
        logs[str(where)] = log
    if logs[str(dev)] != logs["cpu"]:
        raise AssertionError("open host capacity 16: the card's pairs "
                             "differ from the CPU's")
    card, cpu = out[str(dev)], out["cpu"]
    _same_host_run(card, cpu, "open host capacity 16")
    _line("hostopen", f"capacity 16 card against CPU: the same pairs in all "
          f"{len(logs['cpu'])} quanta; {card.n_completed} jobs, identical "
          f"integer logs, finish quanta within 1e-5; mean slowdown card "
          f"{card.mean_slowdown!r} CPU {cpu.mean_slowdown!r}")
    return total


class _ServeClock:
    """Wraps ``ServeEngine.serve_step`` while in use: a CUDA event before
    and after each decode step, read after the run.  Nothing is read back
    to the host during it, so the wrapped run keeps its syncs."""

    def __enter__(self):
        import torch

        from repro_torch.serve.engine import ServeEngine

        self.events = []
        self._orig = ServeEngine.serve_step
        clock = self

        def timed(engine, cache, tokens):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = clock._orig(engine, cache, tokens)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            clock.events.append((start, end))
            return out

        ServeEngine.serve_step = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.engine import ServeEngine

        ServeEngine.serve_step = self._orig
        return False

    def step_ms(self):
        """Each decode step's time on the card's clock, start to end."""
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class _StepClock:
    """Wraps ``TrainStepBuilder.train_step`` while in use: a CUDA event
    after each step (and one before the first), and each step's metrics
    kept on the card.  Neither reads anything back to the host, so the
    wrapped run keeps its syncs.  ``last`` holds the last step's builder,
    state and batch."""

    def __enter__(self):
        import torch

        from repro_torch.train import step as step_mod

        self.events, self.metrics = [], []
        self._cls, self._orig = step_mod.TrainStepBuilder, \
            step_mod.TrainStepBuilder.train_step
        clock = self

        def timed(builder, state, batch, **kw):
            if not clock.events:
                clock.events.append(torch.cuda.Event(enable_timing=True))
                clock.events[0].record()
            out = clock._orig(builder, state, batch, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            clock.events.append(ev)
            clock.metrics.append(out[1])
            clock.last = (builder, out[0], batch)
            return out

        self._cls.train_step = timed
        return self

    def __exit__(self, *exc):
        self._cls.train_step = self._orig
        return False

    def step_ms(self):
        """Each step's time on the card's clock, end to end."""
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                  self.events[1:])]


#: The QKV biases start at zero, so after a few steps they hold AdamW's
#: steps alone, each normalised to about the learning rate whatever the
#: gradient's size.  The key bias is added before RoPE: in the dimensions
#: that RoPE turns slowly a shift of every key barely changes the scores,
#: so there its gradient is near zero, at the float error, and its sign
#: follows the order of the sums.
ZERO_INIT = ("attn.bq", "attn.bk", "attn.bv")


def _gap(got, want, what: str, atol_of=lambda name: None) -> float:
    """The largest error of ``got``'s tensors against ``want``'s, relative
    to each tensor's largest |value|; raises past 1e-4.  A tensor for
    which ``atol_of`` gives a number is held to that absolute error
    instead."""
    worst = 0.0
    for name, p in want.items():
        a = got[name].detach().float().cpu()
        b = p.detach().float().cpu()
        err = float((a - b).abs().max())
        atol = atol_of(name)
        if atol is not None:
            if err > atol:
                raise AssertionError(f"{what}: {name} off by {err:.3e}, past "
                                     f"{atol:.3e}")
            continue
        rel = err / max(float(b.abs().max()), 1e-30)
        worst = max(worst, rel)
        if rel > 1e-4:
            raise AssertionError(f"{what}: {name} off by {rel:.3e} of its "
                                 "largest |value| (limit 1e-4)")
    return worst


def _param_gap(got, want, lr_sum: float, what: str) -> float:
    """Parameters: the QKV biases within the learning rates' sum."""
    return _gap(got, want, what,
                lambda n: lr_sum if n.endswith(ZERO_INIT) else None)


def _moment_gap(got, want, what: str) -> float:
    """First moments (a decayed sum of the gradients): the key bias's,
    near zero in its slowly turning dimensions, within 1e-4 of the
    largest first moment of all."""
    top = max(float(t.abs().max()) for t in want.values())
    return _gap(got, want, what,
                lambda n: 1e-4 * top if n.endswith("attn.bk") else None)


def _train_reference(dev, runs=None) -> None:
    """Phases 25 and 29: three training steps on the card against the same
    steps on the CPU, float32, the same weights and batches.  ``runs``:
    (arch, smoke config, depth or None, batch, sequence); by default
    qwen1.5-0.5b at depth 2 and qwen2-moe-a2.7b at depth 1, full width.
    A vlm or audio batch carries its embeddings, and every gate is at
    ``GATE``."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainStepBuilder

    # AdamW moves every element by about the learning rate, whatever its
    # gradient's size, so an element whose gradient is near its float
    # error (the sums run in another order on the card) moves by another
    # fraction of it: at lr 1e-3 the moe's attn.wo differed by 1.06e-4 of
    # its largest |value| after 3 steps.  At lr 1e-4 a step is 0.2% of
    # the weights' scale and that spread stays 10x under the limit.
    lr = 1e-4
    runs = runs or ((TRAIN_ARCH, False, 2, 2, 128),
                    (MOE_ARCH, False, 1, 2, 64))
    for arch, smoke, depth, batch, seq in runs:
        cfg = get_config(arch, smoke=smoke, dtype="float32",
                         param_dtype="float32",
                         **({"n_layers": depth} if depth else {}))
        on_cpu = build_model(cfg, device="cpu", seed=0)
        _open_gates(on_cpu)
        on_card = copy.deepcopy(on_cpu).to(dev)
        data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
        batches = [{**data.global_batch_at(it), **_batch_extras(
            cfg, np.random.default_rng(it), batch)} for it in range(3)]
        runs = {}
        slots = moe_mod._slots
        for side, model in (("cpu", on_cpu), ("card", on_card)):
            builder = TrainStepBuilder(model, AdamWConfig(lr=lr),
                                       warmup_steps=1, total_steps=10)
            state = builder.fresh_state()
            keeps, metrics = [], []

            def recorded(topi, cfg_, c):
                out = slots(topi, cfg_, c)
                keeps.append(out[2].cpu())
                return out

            moe_mod._slots = recorded
            try:
                t0 = time.perf_counter()
                for it in range(3):
                    state, m = builder.train_step(state, batches[it])
                    metrics.append({k: float(v) for k, v in m.items()})
                secs = time.perf_counter() - t0
            finally:
                moe_mod._slots = slots
            runs[side] = (metrics, state["params"], state["opt"]["mu"],
                          keeps, secs)
        (want, want_p, want_mu, want_k, cpu_s) = runs["cpu"]
        (got, got_p, got_mu, got_k, card_s) = runs["card"]
        for w, g in zip(want, got):
            for key in ("loss", "aux"):
                if not abs(g[key] - w[key]) <= 1e-4 * abs(w[key]):
                    raise AssertionError(f"{arch} train: {key} card "
                                         f"{g[key]!r} vs CPU {w[key]!r}")
        lr_sum = sum(m["lr"] for m in want)
        gap = _param_gap(got_p, want_p, lr_sum, f"{arch} train")
        mu_gap = _moment_gap(got_mu, want_mu, f"{arch} train first moment")
        same = (len(got_k) == len(want_k)
                and all(torch.equal(a, b) for a, b in zip(got_k, want_k)))
        dropped = [int((~k).sum()) for k in want_k]
        size = (f"smoke config ({cfg.n_layers} layers, d_model "
                f"{cfg.d_model})" if smoke else f"full width depth {depth}")
        _line("train-ref", f"{arch} {size} float32, 3 "
              f"steps of {batch} x {seq}: losses card "
              f"{[m['loss'] for m in got]} CPU {[m['loss'] for m in want]}; "
              f"aux card {[m['aux'] for m in got]}; lr {[m['lr'] for m in got]}"
              f"; parameters within {gap:.3e} and first moments within "
              f"{mu_gap:.3e} of each tensor's largest |value| (limit 1e-4; "
              f"the QKV biases within the learning rates' sum); CPU "
              f"{cpu_s:.1f} s, card {card_s:.1f} s")
        if cfg.family == "moe":
            _line("train-ref", f"{arch}: dropped (token, slot) pairs per "
                  f"routing call {dropped} of {want_k[0].numel()}; identical "
                  f"card vs CPU in all {len(want_k)} calls: {same}")
            if not same:
                raise AssertionError(f"{arch} train: the card dropped other "
                                     "(token, slot) pairs than the CPU")
        del on_cpu, on_card, runs
        torch.cuda.empty_cache()


def _train_run(dev, kernel_mods, arch: str, what: str, **kw):
    """One ``launch.train.train`` run on the card with every kernel's
    launch count set to 0 just before and read just after, its host syncs
    audited (only the counted loss reads may sync), its steps clocked.
    Returns (result, launches, step times ms, the :class:`_StepClock`,
    peak bytes, host syncs)."""
    import torch

    from repro_torch.launch import train as train_mod

    box = {}

    def run():
        box["out"] = train_mod.train(arch, smoke=False, device=dev, **kw)

    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    reads0 = train_mod.LOSS_READS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _StepClock() as clock:
        seen = _audited(run)
    wall = time.perf_counter() - t0
    launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    peak = torch.cuda.max_memory_allocated()
    out = box["out"]
    reads = train_mod.LOSS_READS - reads0
    step_ms = clock.step_ms()
    _line("train", f"{what}: {len(step_ms)} steps in {wall:.3f} s (model "
          f"build included); launches {launches}; host syncs {len(seen)}, "
          f"loss reads counted {reads}")
    if len(seen) != reads:
        for msg in sorted(set(seen)):
            _line("syncs", msg[:200])
        raise AssertionError(f"{what}: {len(seen)} host syncs, {reads} "
                             "counted loss reads")
    if any(launches.values()):
        raise AssertionError(f"{what}: training launched kernels {launches}")
    return out, launches, step_ms, clock, peak, len(seen)


def _train_main_path(dev, kernel_mods):
    """Phase 26: the training main path, then ``grad_accum`` and the
    checkpointed run.  The killed-and-resumed run trains the smoke config
    (d_model 64, 2 layers, 4 x 64 tokens): the full size's state is 4.64
    GB a checkpoint, which the check would write five times.  Returns
    every kernel's launches in the main path's run."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainStepBuilder

    out, launches, step_ms, clock, peak, syncs = _train_run(
        dev, kernel_mods, TRAIN_ARCH, f"{TRAIN_ARCH} train", steps=TRAIN_STEPS,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=10)
    del clock   # it holds the run's last state
    med = float(np.median(step_ms[-10:]))
    toks = TRAIN_BATCH * TRAIN_SEQ
    readings = {"losses": out["losses"], "step_ms": med,
                "tokens_s": toks / med * 1e3, "peak": peak, "syncs": syncs}
    _line("train", f"{TRAIN_ARCH} full width and depth, bfloat16, "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: loss "
          f"{out['first_loss']!r} (first log) -> {out['final_loss']!r} "
          f"(last); step wall {med:.3f} ms (median of the last 10, CUDA "
          f"events between step ends), {toks / med * 1e3:.1f} training "
          f"tokens/s; steps {[round(x, 3) for x in step_ms]}; peak memory "
          f"{peak / 2**30:.3f} GiB")
    if not out["final_loss"] < out["first_loss"]:
        raise AssertionError(f"{TRAIN_ARCH} train: the loss did not fall")

    # One step under the profiler, on a builder of the same model.
    cfg = get_config(TRAIN_ARCH)
    builder = TrainStepBuilder(build_model(cfg, device=dev, seed=0),
                               AdamWConfig(lr=3e-3), warmup_steps=3,
                               total_steps=TRAIN_STEPS)
    state = builder.fresh_state()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).global_batch_at(0).items()}
    box = [state]

    def one_step():
        box[0], _ = builder.train_step(box[0], batch)

    one_step()
    wall, seen, dev_us = _device_profile(one_step)
    busy_ms = sum(dev_us(e) for e in seen) / 1e3
    _line("profile", f"one {TRAIN_ARCH} train step under the profiler: wall "
          f"{wall * 1e3:.3f} ms, {sum(e.count for e in seen)} kernels, device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}% of the "
          "profiled wall)")
    for e in sorted(seen, key=dev_us, reverse=True)[:10]:
        _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")
    del builder, state, box
    torch.cuda.empty_cache()

    # grad_accum=2 against 1 on one batch, depth 2, float32.
    cfg = get_config(TRAIN_ARCH, dtype="float32", param_dtype="float32",
                     n_layers=2)
    base = build_model(cfg, device=dev, seed=1)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=2).global_batch_at(0)
    res = {}
    for accum in (1, 2):
        # A first AdamW step moves an element by lr g / (|g| + eps), which
        # for gradients near their float error differs with the order of
        # the sums: at lr 1e-4 mlp.wo differed by 1.12e-4 of its largest
        # |value|.  So the accumulated gradient is compared as the first
        # moment (0.1 g), and the parameters at lr 1e-5.
        builder = TrainStepBuilder(copy.deepcopy(base), AdamWConfig(lr=1e-5),
                                   grad_accum=accum, warmup_steps=0,
                                   total_steps=10)
        state, m = builder.train_step(builder.fresh_state(), batch)
        res[accum] = (float(m["loss"]), float(m["lr"]), state["params"],
                      state["opt"]["mu"])
    (l1, lr1, p1, mu1), (l2, _, p2, mu2) = res[1], res[2]
    if not abs(l2 - l1) <= 1e-4 * abs(l1):
        raise AssertionError("grad_accum=2: loss differs from grad_accum=1")
    mu_gap = _moment_gap(mu2, mu1, "grad_accum=2 first moment")
    gap = _param_gap(p2, p1, lr1, "grad_accum=2")
    _line("train", f"grad_accum=2 against 1 on one {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} batch, depth 2, float32, lr {lr1:.1e}: loss {l2!r} "
          f"vs {l1!r}; first moments (0.1 x the gradient) within "
          f"{mu_gap:.3e} and parameters within {gap:.3e} of each tensor's "
          "largest |value| (limit 1e-4; the QKV biases within lr)")
    del base, res, builder, state
    torch.cuda.empty_cache()

    # Killed after the step-4 checkpoint, resumed to 8: 8 steps bit for bit.
    killed_at, n, same = _killed_and_resumed(dev, contextlib.nullcontext)
    _line("train", f"{TRAIN_ARCH} smoke, bfloat16: killed after the step-"
          f"{killed_at} checkpoint and resumed to step 8: {n} leaves "
          f"equal to 8 uninterrupted steps bit for bit: {same}")
    if killed_at != 4 or not same:
        raise AssertionError("the resumed training run differs from the "
                             "uninterrupted one")
    return launches, readings


#: The smoke run that a checkpoint check kills after its step-4 checkpoint
#: and resumes to step 8 (phases 26 and 41): d_model 64, 2 layers, 4 x 64
#: tokens (a full-size checkpoint is 4.64 GB).
CKPT_RUN = dict(smoke=True, steps=8, batch=4, seq=64, ckpt_every=4,
                log_every=4)


def _killed_and_resumed(dev, killed_in):
    """``CKPT_RUN`` killed right after its step-4 checkpoint (inside the
    context ``killed_in()`` gives), then resumed to step 8 in a plain run,
    against 8 uninterrupted plain steps.  Returns (the step it was killed
    after, leaves, whether every leaf is equal bit for bit)."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as train_mod

    class _Killed(Exception):
        pass

    run = dict(CKPT_RUN, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        full, split = os.path.join(tmp, "full"), os.path.join(tmp, "split")
        train_mod.train(TRAIN_ARCH, ckpt_dir=full, **run)
        save = CheckpointManager.save

        def dying(self, step, tree, meta=None):
            save(self, step, tree, meta)
            raise _Killed(step)

        CheckpointManager.save = dying
        try:
            with killed_in():
                train_mod.train(TRAIN_ARCH, ckpt_dir=split, **run)
            raise AssertionError("the killed run was not killed")
        except _Killed:
            pass
        finally:
            CheckpointManager.save = save
        killed_at = CheckpointManager(split).latest_step()
        train_mod.train(TRAIN_ARCH, ckpt_dir=split, **run)
        trees = [CheckpointManager(d).restore_latest()[1] for d in (full, split)]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    a, b = dict(leaves(trees[0])), dict(leaves(trees[1]))
    same = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        for k in a)
    return killed_at, len(a), same


@contextlib.contextmanager
def _nccl_rank():
    """A process group of one NCCL rank, this process, for the block (its
    store a file in a temporary directory); destroyed on the way out."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _train_mesh(dev, kernel_mods, plain):
    """Phase 41: phase 26's run over a one-rank NCCL group (a (1, 1)
    mesh, the state and batches as DTensors), its losses held to
    ``plain``'s (phase 26's readings), then the checkpoint check with the
    killed run on the group and the resumed one without.  Returns every
    kernel's launches in the mesh run."""
    import numpy as np
    import torch

    from repro_torch.sharding import make_plan, step_layout

    with _nccl_rank():
        out, launches, step_ms, clock, peak, syncs = _train_run(
            dev, kernel_mods, TRAIN_ARCH,
            f"{TRAIN_ARCH} train over a one-rank NCCL mesh",
            steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=10)
        # One more step of the run's state under the profiler, in the
        # layout the run's steps took.
        builder, state, batch = clock.last
        mesh = next(iter(state["params"].values())).device_mesh
        with step_layout(make_plan(fsdp=False), mesh):
            wall, seen, dev_us = _device_profile(
                lambda: builder.train_step(state, batch))
        del builder, state, batch, clock
    busy_ms = sum(dev_us(e) for e in seen) / 1e3
    _line("profile", f"one {TRAIN_ARCH} train step over the one-rank NCCL "
          f"mesh under the profiler: wall {wall * 1e3:.3f} ms, "
          f"{sum(e.count for e in seen)} kernels, device busy {busy_ms:.3f} "
          f"ms ({100 * busy_ms / (wall * 1e3):.1f}% of the profiled wall)")
    for e in sorted(seen, key=dev_us, reverse=True)[:5]:
        _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}")
    med = float(np.median(step_ms[-10:]))
    toks = TRAIN_BATCH * TRAIN_SEQ
    got, want = np.array(out["losses"]), np.array(plain["losses"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    same = got.tobytes() == want.tobytes()
    _line("trainmesh", f"{TRAIN_ARCH} full width and depth, bfloat16, "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} over a "
          f"one-rank NCCL mesh: losses {out['losses']}; against phase 26's "
          f"within {rel:.3e} relative (limit {MESH_LOSS_RTOL:g}), bit for "
          f"bit: {same}; launches {launches}")
    _line("trainmesh", f"step wall {med:.3f} ms (median of the last 10) "
          f"against phase 26's {plain['step_ms']:.3f} ms, "
          f"{toks / med * 1e3:.1f} against {plain['tokens_s']:.1f} training "
          f"tokens/s; peak memory {peak / 2**30:.3f} against "
          f"{plain['peak'] / 2**30:.3f} GiB; host syncs {syncs} against "
          f"{plain['syncs']} (every one a counted loss read); steps "
          f"{[round(x, 3) for x in step_ms]}")
    if len(got) != len(want) or not rel <= MESH_LOSS_RTOL:
        raise AssertionError(f"the mesh run's losses differ from phase 26's "
                             f"by {rel:.3e} relative")
    torch.cuda.empty_cache()

    killed_at, n, same = _killed_and_resumed(dev, _nccl_rank)
    _line("trainmesh", f"{TRAIN_ARCH} smoke, bfloat16: killed after the "
          f"step-{killed_at} checkpoint over the one-rank NCCL mesh and "
          f"resumed to step 8 without a group: {n} leaves equal to 8 "
          f"uninterrupted steps bit for bit: {same}")
    if killed_at != 4 or not same:
        raise AssertionError("the mesh run resumed without a group differs "
                             "from the uninterrupted one")
    return launches


def _greedy_steps(model, steps: int = MESH_DECODE_STEPS):
    """``steps`` greedy decode steps of 4 slots on a 64-token cache from
    seeded tokens (under a mesh, the tokens whole on every rank): every
    step's tokens, on the host."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import whole

    engine = ServeEngine(model, max_len=64, batch_size=4)
    cache = model.init_cache(4, 64)
    tok = torch.as_tensor(np.random.default_rng(42).integers(
        0, model.cfg.vocab_size, (4, 1)), device=model.device)
    out = []
    for _ in range(steps):
        logits, cache = engine.serve_step(cache, tok)
        tok = whole(torch.argmax(logits[:, -1], dim=-1))[:, None]
        out.append(tok.cpu().numpy())
    return np.concatenate(out, axis=1)


def _serve_mesh(dev, kernel_mods, phase10):
    """Phase 42: serving over a one-rank NCCL group (a (1, 1) mesh; the
    weights, the decode cache and each step's tokens as DTensors), held to
    phase 10 (``phase10``, its readings): (a) ``serve_demo`` at its
    defaults, its tokens, launches (none), host syncs (the counted token
    reads alone) and decode steps; (b) phase 10's prefill through
    ``ServeEngine.prefill`` over the group, the flash kernel on each
    rank's local tensors; (c) hymba-1.5b and rwkv6-3b, full width, depth
    ``MESH_STATE_DEPTH``, through ``MESH_DECODE_STEPS`` greedy steps with
    and without the group.  (b) also times and profiles one decode step of
    its laid-out model as phase 10 does its own.  Returns every kernel's
    launches in (a) and (b)'s prefill."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_demo
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import engine as engine_mod
    from repro_torch.sharding import distribute_model, make_plan, step_layout

    plan = make_plan(fsdp=False)
    with _nccl_rank():
        # (a) serve_demo joined to the group, its token reads counted on
        # its traced serve.generate spans.
        box = {}
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0
        torch.cuda.synchronize()
        obs_trace.enable()
        with _ServeClock() as clock:
            seen = _audited(lambda: box.setdefault(
                "out", serve_demo(SERVE_ARCH, smoke=False, device=dev)))
        obs_trace.disable()
        reads = sum(e["args"]["token_reads"] for e in obs_trace.events()
                    if e["name"] == "serve.generate")
        obs_trace.clear()
        demo_launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
        out, want = box["out"], phase10["demo"]
        steps, want_steps = clock.step_ms(), phase10["demo_step_ms"]
        med, want_med = float(np.median(steps)), float(np.median(want_steps))
        same = out["generated"] == want["generated"]
        _line("servemesh", f"{SERVE_ARCH} full size, float32: serve_demo "
              f"over a one-rank NCCL mesh ({out['ranks']} rank): "
              f"{out['requests']} requests, {out['tokens']} tokens identical"
              f" to phase 10's: {same}; launches {demo_launches}; host syncs "
              f"{len(seen)}, token reads counted {reads}")
        _line("servemesh", f"decode step wall {med:.3f} ms (median of "
              f"{len(steps)}, CUDA events) against phase 10's {want_med:.3f}"
              f" ms (median of {len(want_steps)}), {med / want_med:.2f}x; "
              f"{out['tok_per_s']:.1f} against {want['tok_per_s']:.1f} tok/s "
              f"({out['seconds']:.3f} against {want['seconds']:.3f} s); "
              f"phase 10's decode step at position 32 alone "
              f"{phase10['step_ms']:.3f} ms")
        if len(seen) != reads:
            for msg in sorted(set(seen)):
                _line("syncs", msg[:200])
            raise AssertionError(f"serve_demo over the mesh: {len(seen)} host "
                                 f"syncs, {reads} counted token reads")
        if not same or out["ranks"] != 1:
            raise AssertionError("serve_demo over the mesh: tokens differ "
                                 "from phase 10's")
        if any(demo_launches.values()):
            raise AssertionError(f"serve_demo launched {demo_launches}")
        torch.cuda.empty_cache()

        # (b) phase 10's prefill, one device and then over the group.
        cfg = get_config(SERVE_ARCH, dtype="float32", param_dtype="float32",
                         attention_impl="kernel")
        model = build_model(cfg, device=dev, seed=0)
        engine = engine_mod.ServeEngine(model, max_len=64, batch_size=4)
        toks = torch.as_tensor(np.random.default_rng(10).integers(
            0, cfg.vocab_size, (PREFILL_B, PREFILL_S)).astype(np.int32),
            device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        plain = engine.prefill({"tokens": toks})
        plain_peak = torch.cuda.max_memory_allocated()
        lo, hi = torch.aminmax(plain)
        scale = max(-float(lo), float(hi))
        again = (float(plain.sum(dtype=torch.float64)) == phase10["prefill_sum"]
                 and scale == phase10["prefill_absmax"])
        plain = plain.cpu()
        mesh = make_host_mesh(1)
        distribute_model(model, plan, mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with step_layout(plan, mesh):
            logits = engine.prefill({"tokens": toks})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        prefill_launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
        peak = torch.cuda.max_memory_allocated()
        local = logits.to_local()
        err, same = 0.0, tuple(logits.shape) == tuple(plain.shape)
        for b in range(PREFILL_B):
            row = plain[b].to(dev)
            err = max(err, float((local[b] - row).abs().max()))
            same &= bool(torch.equal(local[b], row))
        _line("servemesh", f"prefill {PREFILL_B} x {PREFILL_S} over the mesh "
              f"(logits {type(logits).__name__} {tuple(logits.shape)}, "
              f"{logits.placements}): first call {first_s:.3f} s, launches "
              f"{prefill_launches}; logits within {err:.3e} of the "
              f"one-device prefill's (limit {MESH_LOGIT_REL:g} x "
              f"{scale:.4f}), bit for bit: {same}; the one-device prefill "
              f"repeats phase 10's (float64 sum, largest |logit|): {again}; "
              f"peak memory over the call {peak / 2**30:.3f} GiB against "
              f"{plain_peak / 2**30:.3f} GiB over the one-device call (the "
              f"model built before either; phase 10's whole phase "
              f"{phase10['peak'] / 2**30:.3f} GiB)")
        if prefill_launches["flash_attention"] != cfg.n_layers or any(
                v for n, v in prefill_launches.items()
                if n != "flash_attention"):
            raise AssertionError(f"the group prefill launched "
                                 f"{prefill_launches}, expected "
                                 f"{cfg.n_layers} flash launches alone")
        if not again:
            raise AssertionError("the one-device prefill does not repeat "
                                 "phase 10's")
        if not (tuple(logits.shape) == tuple(plain.shape)
                and err <= MESH_LOGIT_REL * scale):
            raise AssertionError(f"the group prefill's logits differ by "
                                 f"{err:.3e} (largest |logit| {scale})")
        del logits, local, plain, row
        torch.cuda.empty_cache()
        # One decode step of the laid-out model, as phase 10 times its
        # own: 4 slots at position 32 of a 64-token cache.
        step_tok = torch.as_tensor(np.arange(4, dtype=np.int32)[:, None],
                                   device=dev)
        with step_layout(plan, mesh):
            cache = model.init_cache(4, 64)
            cache["pos"].fill_(32)
            step_ms = _wall_ms(lambda: engine.serve_step(cache, step_tok),
                               reps=9)
            wall, seen, dev_us = _device_profile(
                lambda: engine.serve_step(cache, step_tok))
        busy_ms = sum(dev_us(e) for e in seen) / 1e3
        n_kernels = sum(e.count for e in seen)
        _line("servemesh", f"decode step over the mesh (4 slots, position "
              f"32): {step_ms:.3f} ms (median of 9) against phase 10's "
              f"{phase10['step_ms']:.3f} ms, {step_ms / phase10['step_ms']:.2f}"
              f"x; under the profiler {n_kernels} kernels, device busy "
              f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}% of the "
              f"profiled wall {wall * 1e3:.3f} ms) against phase 10's "
              f"{phase10['step_kernels']} kernels, "
              f"{phase10['step_busy']:.1f}%")
        for e in sorted(seen, key=dev_us, reverse=True)[:5]:
            _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:100]}")
        del model, engine, cache
        torch.cuda.empty_cache()

        # (c) the recurrent states, with and without the group.
        for arch in (HYMBA_ARCH, RWKV_ARCH):
            cfg = get_config(arch, dtype="float32", param_dtype="float32",
                             n_layers=MESH_STATE_DEPTH)
            want = _greedy_steps(build_model(cfg, device=dev, seed=0))
            model = build_model(cfg, device=dev, seed=0)
            distribute_model(model, plan, mesh)
            with step_layout(plan, mesh):
                got = _greedy_steps(model)
            same = np.array_equal(got, want)
            _line("servemesh", f"{arch} full width, depth "
                  f"{MESH_STATE_DEPTH}, float32: {MESH_DECODE_STEPS} greedy "
                  f"decode steps of 4 slots over the mesh and without: tokens"
                  f" identical: {same}")
            if not same:
                raise AssertionError(f"{arch}: the mesh's greedy tokens "
                                     "differ from the one-device run's")
            del model
            torch.cuda.empty_cache()
    return {n: demo_launches[n] + prefill_launches[n] for n in kernel_mods}


def _moe_train(dev, kernel_mods):
    """Phase 28's training half: qwen2-moe-a2.7b at full width and depth
    ``MOE_TRAIN_DEPTH``.  Returns every kernel's launches in the run."""
    import numpy as np
    import torch

    out, launches, step_ms, clock, peak, _ = _train_run(
        dev, kernel_mods, MOE_ARCH, f"{MOE_ARCH} train",
        steps=MOE_TRAIN_STEPS, batch=MOE_TRAIN_BATCH, seq=TRAIN_SEQ,
        log_every=5, overrides={"n_layers": MOE_TRAIN_DEPTH})
    aux = [float(m["aux"]) for m in clock.metrics]
    del clock   # it holds the run's last state
    med = float(np.median(step_ms[-5:]))
    toks = MOE_TRAIN_BATCH * TRAIN_SEQ
    _line("train", f"{MOE_ARCH} full width, depth {MOE_TRAIN_DEPTH}, "
          f"bfloat16, {MOE_TRAIN_STEPS} steps of {MOE_TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: loss {out['first_loss']!r} (first log) -> "
          f"{out['final_loss']!r} (last); aux {[round(a, 4) for a in aux]}; "
          f"step wall {med:.3f} ms (median of the last 5), "
          f"{toks / med * 1e3:.1f} training tokens/s; steps "
          f"{[round(x, 3) for x in step_ms]}; peak memory "
          f"{peak / 2**30:.3f} GiB")
    if not out["final_loss"] < out["first_loss"]:
        raise AssertionError(f"{MOE_ARCH} train: the loss did not fall")
    if not all(math.isfinite(a) for a in aux):
        raise AssertionError(f"{MOE_ARCH} train: aux not finite: {aux}")
    torch.cuda.empty_cache()
    return launches


def _family_reference(dev) -> None:
    """Phase 29: the vlm and audio families' serving path card against
    CPU (llama-3.2-vision-11b at depth ``VLM_REF_DEPTH``, whisper-large-v3
    at ``AUDIO_REF_DEPTH`` decoder and encoder layers, full width, every
    gate at ``GATE``), then three training steps of each smoke config."""
    import torch

    from repro_torch.models.registry import build_model, get_config
    from repro_torch.models.transformer import Model

    for arch, overrides in (
            (VLM_ARCH, {"n_layers": VLM_REF_DEPTH}),
            (AUDIO_ARCH, {"n_layers": AUDIO_REF_DEPTH,
                          "encoder_layers": AUDIO_REF_DEPTH})):
        cfg = get_config(arch, dtype="float32", param_dtype="float32",
                         attention_impl="kernel", **overrides)
        # Drawn on the card and copied to the CPU, whose draw of the vlm's
        # 2.1 B weights would be slow.
        on_card = build_model(cfg, device=dev, seed=0)
        _open_gates(on_card)
        on_cpu = Model(cfg, "cpu")
        on_cpu.load_state_dict(on_card.state_dict())
        n_params = sum(p.numel() for p in on_cpu.parameters())
        _line("reference", f"{arch}: {n_params} parameters on each side, "
              f"every gate {GATE}")
        _serving_reference(dev, arch, twins=(on_cpu, on_card))
        del on_card, on_cpu
        torch.cuda.empty_cache()
    _train_reference(dev, runs=((VLM_ARCH, True, None, 2, 64),
                                (AUDIO_ARCH, True, None, 2, 64)))


def _smoke_decode_reference(dev, arch: str, fa_kernel) -> None:
    """Phase 32's smoke check of one architecture, card against CPU,
    float32, the same weights (drawn on the card): a prefill of
    ``NEW_REF_PROMPT`` tokens through flash (the kernel's zero-padded
    head dims on the card), then ``NEW_REF_STEPS`` decode steps of 2
    slots, the prompt's and then greedy ones, slot 1 reset after step
    ``NEW_REF_RESET``: logits within 2e-5 of the largest |logit| at every
    step, greedy tokens identical, the reset slot's recurrent states
    zeroed."""
    import numpy as np
    import torch

    from repro_torch.models.registry import build_model, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch, smoke=True, dtype="float32", param_dtype="float32",
                     attention_impl="kernel")
    on_card = build_model(cfg, device=dev, seed=0)
    on_cpu = Model(cfg, "cpu")
    on_cpu.load_state_dict(on_card.state_dict())
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (2, NEW_REF_STEPS)).astype(np.int32)
    prompt = {"tokens": toks[:, :NEW_REF_PROMPT]}
    before = fa_kernel.LAUNCHES
    with torch.no_grad():
        want, _ = on_cpu.forward(prompt)
        got, _ = on_card.forward(prompt)
    launched = fa_kernel.LAUNCHES - before
    scale = float(want.abs().max())
    pre_err = float((got.cpu() - want).abs().max())
    if not pre_err <= 2e-5 * scale:
        raise AssertionError(f"{arch} smoke prefill: card vs CPU {pre_err:.3e}"
                             f" past 2e-5 x {scale:.4f}")
    sides = []
    for model in (on_cpu, on_card):
        engine = ServeEngine(model, 64, 2)
        sides.append([engine, model.init_cache(2, 64), model.device])
    worst, fed = 0.0, ([], [])
    nxt = [None, None]
    for t in range(NEW_REF_STEPS):
        outs = []
        for i, side in enumerate(sides):
            engine, cache, where = side
            tok = (toks[:, t:t + 1] if t < NEW_REF_PROMPT
                   else nxt[i].numpy().astype(np.int32)[:, None])
            fed[i].append(tok[:, 0].tolist())
            logits, side[1] = engine.serve_step(
                side[1], torch.as_tensor(tok, device=where))
            logits = logits[:, -1].cpu()
            nxt[i] = logits.argmax(-1)
            outs.append(logits)
            if t == NEW_REF_RESET:
                side[1] = engine.reset_slots(side[1], np.array([False, True]))
        scale = float(outs[0].abs().max())
        err = float((outs[1] - outs[0]).abs().max())
        worst = max(worst, err / scale)
        if not err <= 2e-5 * scale:
            raise AssertionError(f"{arch} smoke decode step {t}: card vs CPU "
                                 f"{err:.3e} past 2e-5 x {scale:.4f}")
        if not torch.equal(nxt[0], nxt[1]):
            raise AssertionError(f"{arch} smoke decode step {t}: greedy "
                                 f"tokens differ")
    card = sides[1][1]
    zeroed = [k for k in ("ssm", "rwkv") if k in card]
    ring = card["k"].shape[2] if "k" in card else 0
    _line("reference", f"{arch} smoke config ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, head dim {cfg.resolved_head_dim}): prefill 2 x "
          f"{NEW_REF_PROMPT} within {pre_err / scale:.3e} of the largest "
          f"|logit| (flash launches on the card {launched}); "
          f"{NEW_REF_STEPS} decode steps "
          + (f"through a {ring}-slot ring " if ring and cfg.sliding_window
             else "")
          + f"(greedy from step {NEW_REF_PROMPT}, slot 1 reset after step "
          f"{NEW_REF_RESET}{', zeroing its ' + ' and '.join(zeroed) if zeroed else ''}"
          f") within {worst:.3e} (limit 2e-5); greedy tokens identical; "
          f"positions {card['pos'].tolist()}")
    if fed[0] != fed[1] or card["pos"].tolist() != [
            NEW_REF_STEPS, NEW_REF_STEPS - NEW_REF_RESET - 1]:
        raise AssertionError(f"{arch} smoke decode: the sides fed other "
                             "tokens or positions")


def _new_family_reference(dev, fa_kernel) -> None:
    """Phase 32: the last five architectures card against CPU, float32:
    each smoke config through :func:`_smoke_decode_reference`; gemma-7b,
    starcoder2-3b, hymba-1.5b and rwkv6-3b at full width and depth 2
    through phase 9's check (weights drawn on the card, copied to the
    CPU); then phase 25's three training steps for the hybrid and ssm
    smoke configs."""
    import torch

    from repro_torch.models.registry import build_model, get_config
    from repro_torch.models.transformer import Model

    for arch in NEW_ARCHS:
        _smoke_decode_reference(dev, arch, fa_kernel)
    for arch in (GEMMA_ARCH, STARCODER_ARCH, HYMBA_ARCH, RWKV_ARCH):
        cfg = get_config(arch, dtype="float32", param_dtype="float32",
                         attention_impl="kernel", n_layers=2)
        on_card = build_model(cfg, device=dev, seed=0)
        on_cpu = Model(cfg, "cpu")
        on_cpu.load_state_dict(on_card.state_dict())
        n_params = sum(p.numel() for p in on_cpu.parameters())
        _line("reference", f"{arch} full width, depth 2: {n_params} "
              "parameters on each side")
        _serving_reference(dev, arch, twins=(on_cpu, on_card))
        del on_card, on_cpu
        torch.cuda.empty_cache()
    _train_reference(dev, runs=((HYMBA_ARCH, True, None, 2, 64),
                                (RWKV_ARCH, True, None, 2, 64)))


def _roofline_constants(dev) -> None:
    """Phase 38: the dry-run's H100 constants beside this card."""
    import torch
    from repro_torch.launch import roofline as rl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    n = 8192
    g = torch.Generator(device=dev).manual_seed(38)
    a = torch.randn(n, n, dtype=torch.bfloat16, device=dev, generator=g)
    b = torch.randn(n, n, dtype=torch.bfloat16, device=dev, generator=g)
    mm_ms = _gpu_ms(lambda: torch.matmul(a, b), iters=20)
    del a, b
    nbytes = 4 << 30
    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = _gpu_ms(lambda: dst.copy_(src), iters=10)
    del src, dst
    torch.cuda.empty_cache()
    tflops = 2 * n ** 3 / (mm_ms * 1e-3) / 1e12
    gbs = 2 * nbytes / (copy_ms * 1e-3) / 1e9
    total = torch.cuda.get_device_properties(0).total_memory
    _line("roofline", smi)
    _line("roofline", f"bf16 {n}^3 matmul {mm_ms:.4f} ms: {tflops:.1f} TFLOP/s "
          f"against PEAK_FLOPS {rl.PEAK_FLOPS / 1e12:.1f} "
          f"({100 * tflops * 1e12 / rl.PEAK_FLOPS:.1f}%)")
    _line("roofline", f"4 GiB device-to-device copy {copy_ms:.4f} ms: "
          f"{gbs:.1f} GB/s read + written against HBM_BW "
          f"{rl.HBM_BW / 1e9:.1f} ({100 * gbs * 1e9 / rl.HBM_BW:.1f}%)")
    _line("roofline", f"total_memory {total} bytes ({total / 2**30:.2f} GiB) "
          f"against HBM_BYTES {rl.HBM_BYTES:.0f}")


def _dryrun_cells():
    """Phase 39: the dry-run's cells on the host; returns the records."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun

    cells = [c + (True,) for c in DRYRUN_MULTI_POD]   # the longest first
    cells += [c + (False,) for c in dryrun.all_cells(False)
              if c not in dryrun.LOOP_BOUND]
    t0 = time.perf_counter()
    results = dryrun.run_cells(cells, jobs=DRYRUN_JOBS)
    wall = time.perf_counter() - t0
    records, failed, per_dev = [], [], {}
    for arch, shape, status, rec, cell_s in results:
        if status != "ok":
            if status == "fail":
                failed.append(f"{arch} x {shape}: {rec}")
            _line("dryrun", f"{status.upper()} {arch} x {shape}: {rec}")
            continue
        terms = [rec[k] for k in ("compute_s", "memory_s", "collective_s",
                                  "useful_flops_ratio", "bytes_per_device")]
        if not all(math.isfinite(x) and x >= 0 for x in terms):
            failed.append(f"{arch} x {shape}: terms {terms}")
        counts = {k: v for k, v in rec["collective_counts"].items() if v}
        _line("dryrun", f"{arch} x {shape} on {rec['mesh']}: compute "
              f"{rec['compute_s']:.6f} s, memory {rec['memory_s']:.6f} s, "
              f"collective {rec['collective_s']:.6f} s -> {rec['dominant']}; "
              f"useful {rec['useful_flops_ratio']:.4f}, "
              f"{rec['bytes_per_device'] / 2**30:.2f} GiB/dev, fits "
              f"{rec['fits_hbm']}; {counts}; wall {cell_s:.1f} s")
        per_dev[arch, shape, rec["mesh"]] = rec["bytes_per_device"]
        if rec["mesh"] == "16x16":
            records.append(rec)
    for arch, shape in DRYRUN_MULTI_POD:
        one = per_dev.get((arch, shape, "16x16"))
        two = per_dev.get((arch, shape, "2x16x16"))
        if one is not None and two is not None and not two <= one:
            failed.append(f"{arch} x {shape}: {two / 2**30:.2f} GiB/dev on "
                          f"2x16x16 against {one / 2**30:.2f} on 16x16")
    if dist.is_initialized():
        raise AssertionError("dry-run: a process group was left behind")
    if failed:
        raise AssertionError("dry-run cells failed: " + "; ".join(failed))
    _line("dryrun", f"{len(results)} cells in {wall:.1f} s on "
          f"{DRYRUN_JOBS} processes; no process group left")
    return records


def _colocation(dev, model, records, kernel_mods):
    """Phase 40: co-location plans on the card against the CPU."""
    import numpy as np
    from repro_torch.core import colocation

    stand_in = [{"arch": n.split("/")[0], "shape": n.split("/")[1],
                 "compute_s": c, "memory_s": m, "collective_s": i,
                 "useful_flops_ratio": u} for n, c, m, i, u in STAND_IN_JOBS]
    sets = {"dry-run": records[:len(records) // 2 * 2], "stand-in": stand_in}
    cpu = {name: colocation.plan_colocation(rs, model, device="cpu")
           for name, rs in sets.items()}
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    card = {name: colocation.plan_colocation(rs, model, device=dev)
            for name, rs in sets.items()}
    launches = {n: m.LAUNCHES for n, m in kernel_mods.items()}
    if launches["pair_score"] != len(sets):
        raise AssertionError(f"colocation: pair_score launched "
                             f"{launches['pair_score']} times for "
                             f"{len(sets)} plans")
    rng = np.random.default_rng(40)
    for name, rs in sets.items():
        c, h = card[name], cpu[name]
        if c.pairs != h.pairs:
            raise AssertionError(f"colocation {name}: card pairs {c.pairs} "
                                 f"vs CPU {h.pairs}")
        rel = abs(c.predicted_cost - h.predicted_cost) / abs(h.predicted_cost)
        if not rel <= 1e-5:
            raise AssertionError(f"colocation {name}: predicted cost card "
                                 f"{c.predicted_cost!r} CPU "
                                 f"{h.predicted_cost!r}")
        perm = rng.permutation(len(rs))
        rand_pairs = [tuple(sorted(p)) for p in perm.reshape(-1, 2).tolist()]
        synpa = colocation.evaluate_placement(rs, c.pairs)
        rand = colocation.evaluate_placement(rs, rand_pairs)
        _line("coloc", f"{name}: {len(rs)} jobs onto {len(c.pairs)} slices; "
              f"pairs identical on the card and the CPU, predicted cost "
              f"card {c.predicted_cost!r} CPU {h.predicted_cost!r} (rel "
              f"{rel:.2e}); true mean slowdown SYNPA {synpa!r}, seeded "
              f"random pairing {rand!r}")
        for a, b in c.named_pairs():
            _line("coloc", f"  {a} <-> {b}")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import isc, matching, regression
    from repro_torch.core.synpa import fused_pad, make_fused_step
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.pair_score import kernel as ps_kernel
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.smt import scan_engine, training
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine
    from repro_torch.smt.workloads import scaled_workload

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _line("device", f"{kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. Build every kernel at once, one nvcc per source.
    kernel_mods = {"pair_score": ps_kernel, "flash_attention": fa_kernel,
                   "decode_attention": da_kernel, "rmsnorm": rn_kernel}
    build_s = _build.load_all([m.LIB for m in kernel_mods.values()])
    _line("build", f"all {len(kernel_mods)} kernels in {build_s:.2f} s")
    for name, mod in kernel_mods.items():
        _line("build", f"{name}: {mod.LIB.load_s:.2f} s "
              f"({mod.LIB.library_path().relative_to(ROOT)})")
        for ln in _ptxas_summary(mod.LIB.build_log):
            _line("build", f"  {ln}")

    # 3. Kernel against its plain version.
    rng = np.random.default_rng(0)
    max_err = _pair_score_check(dev, rng, ps_kernel)

    # 4. Fit the model.
    t0 = time.perf_counter()
    models, _ = training.build_all_models(
        SMTMachine(MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": isc.SYNPA4_R_FEBE}, device=dev)
    model = models["SYNPA4_R-FEBE"]
    coeffs_txt = [[round(float(x), 4) for x in row]
                  for row in model.coeffs.cpu().numpy()]
    _line("fit", f"SYNPA4_R-FEBE in {time.perf_counter() - t0:.2f} s; "
          f"coeffs {coeffs_txt}")

    params = MachineParams()

    # 5. Reference check: the whole path at N = 16, card against CPU.
    small = scaled_workload(16, seed=16)
    on_card = scan_engine.run_quanta_scan(
        params, small, _policies(model, scan_engine, isc), n_quanta=N_QUANTA,
        seed=5, device=dev, draws=HostDraws(5, dev), repeats=0)
    on_cpu = scan_engine.run_quanta_scan(
        params, small, _policies(model.to("cpu"), scan_engine, isc),
        n_quanta=N_QUANTA, seed=5, device="cpu", draws=HostDraws(5, "cpu"),
        repeats=0)
    for name, r in on_card.items():
        c = on_cpu[name]
        for field in ("total_retired", "mean_true_slowdown"):
            a, b = getattr(r, field), getattr(c, field)
            if not abs(a - b) <= 1e-4 * abs(b):
                raise AssertionError(
                    f"N=16 {name}.{field}: card {a!r} vs CPU {b!r}")
        _line("reference", f"N=16 {name}: mean true slowdown card "
              f"{r.mean_true_slowdown!r} CPU {c.mean_true_slowdown!r}; "
              f"retired card {r.total_retired!r} CPU {c.total_retired!r}")

    # 6. The main path.
    profiles = scaled_workload(N_APPS, seed=N_APPS)
    policies = _policies(model, scan_engine, isc)
    for mod in kernel_mods.values():
        mod.LAUNCHES = 0
    regression.NEED_FB_SYNCS = 0
    regression.FALLBACK_RUNS = 0
    matching.TWO_OPT_SYNCS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = scan_engine.run_quanta_scan(
        params, profiles, policies, n_quanta=N_QUANTA, seed=RACE_SEED,
        device=dev, repeats=0)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"pair_score": ps_kernel.LAUNCHES}
    fb_syncs = regression.NEED_FB_SYNCS
    fb_in_race = regression.FALLBACK_RUNS
    two_opt_syncs = matching.TWO_OPT_SYNCS
    for name, r in res.items():
        if r.ipc.shape != (N_APPS,) or not np.isfinite(r.ipc).all():
            raise AssertionError(f"{name}: ipc not finite or wrong shape")
        if not math.isfinite(r.mean_true_slowdown) or r.mean_true_slowdown < 1:
            raise AssertionError(f"{name}: mean true slowdown "
                                 f"{r.mean_true_slowdown!r}")
        _line("race", f"N={N_APPS} {name}: mean true slowdown "
              f"{r.mean_true_slowdown!r}, IPC geomean {r.ipc_geomean!r}, "
              f"retired {r.total_retired!r}")
    _line("race", f"first run {main_s:.3f} s (builds the race, runs it "
          f"once); pair_score launches {launches['pair_score']}; host syncs: "
          f"fallback flag {fb_syncs}, 2-opt flag {two_opt_syncs}")
    if launches["pair_score"] < N_QUANTA - 1:
        raise AssertionError(f"pair_score launched {launches['pair_score']} "
                             f"times, expected >= {N_QUANTA - 1}")
    for other in ("random", "linux"):
        if not (res["synpa4"].mean_true_slowdown
                < res[other].mean_true_slowdown):
            raise AssertionError(f"synpa4 does not beat {other} on mean true "
                                 "slowdown")

    # Host synchronisations inside one race: every one must be a counted
    # data-dependent exit.
    tables = PhaseTables.build(profiles)
    race = scan_engine.build_race(tables, params, list(policies.values()),
                                  N_QUANTA, dev)
    p_pad = fused_pad(N_APPS)
    dt, init_mpart, init_st, draws = _race_inputs(tables, policies, dev)
    torch.cuda.synchronize()

    # A deliberate sync, read as the race reads its flags, must be seen.
    if not _audited(lambda: bool(torch.ones(1, device=dev))):
        raise AssertionError("sync audit: a deliberate sync raised no warning")
    counted0 = regression.NEED_FB_SYNCS + matching.TWO_OPT_SYNCS
    seen = _audited(lambda: race(dt, init_mpart, init_st, draws))
    torch.cuda.synchronize()
    counted = regression.NEED_FB_SYNCS + matching.TWO_OPT_SYNCS - counted0
    _line("syncs", f"one race: {len(seen)} sync warnings, {counted} syncs "
          "counted (fallback + 2-opt flags)")
    if len(seen) != counted:
        for msg in sorted(set(seen)):
            _line("syncs", msg[:200])
        raise AssertionError("uncounted host syncs in the race")

    # Per-quantum wall time: median of 3 timed runs after one warm run.
    timed = scan_engine.run_quanta_scan(
        params, profiles, policies, n_quanta=N_QUANTA, seed=RACE_SEED,
        device=dev, repeats=3)
    per_q = timed["synpa4"].machine_s_per_quantum
    same = all(timed[k].total_retired == res[k].total_retired for k in res)
    _line("race", f"wall per quantum (3 policies, median of 3 after a warm "
          f"run): {per_q * 1e3:.3f} ms; reruns identical: {same}")

    # Where one race's time goes, by kernel, under the profiler.
    prof_wall, kernels_seen, dev_us = _device_profile(
        lambda: race(dt, init_mpart, init_st, draws))
    busy_ms = sum(dev_us(e) for e in kernels_seen) / 1e3
    n_kernels = sum(e.count for e in kernels_seen)
    _line("profile", f"one race under the profiler: wall {prof_wall * 1e3:.3f}"
          f" ms, {n_kernels} kernels, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (prof_wall * 1e3):.1f}% of the profiled wall, "
          f"{100 * busy_ms / (per_q * N_QUANTA * 1e3):.1f}% of the unprofiled"
          " one)")
    for e in sorted(kernels_seen, key=dev_us, reverse=True)[:12]:
        _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:100]}")

    # Where a synpa quantum's time goes, layer by layer, at N = 1024: host
    # clock around each call, synchronised after it, median of 5.
    def wall_ms(fn, reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    quantum = scan_engine._make_machine_quantum(dt, params)
    state0 = scan_engine._MachineState(
        torch.zeros(N_APPS, dtype=torch.int64, device=dev),
        dt.duration[:, 0].clone(),
        torch.zeros(N_APPS, device=dev), torch.zeros(N_APPS, device=dev))
    partner0 = scan_engine._machine_partner_of(init_mpart[0], N_APPS)
    counters, _, _ = quantum(state0, partner0, draws, 0)
    fstep = make_fused_step(isc.SYNPA4_R_FEBE, model)
    solve = partner0 != torch.arange(N_APPS, device=dev)
    masks = torch.stack([solve, ~solve, torch.ones_like(solve),
                         torch.zeros_like(solve)])
    cost, st_q = fstep(counters, partner0, init_st[0], masks, False)
    valid_p = torch.arange(p_pad, device=dev) < N_APPS
    matched = matching.device_pairs_partner(cost, valid_p, eps=1e-2,
                                            max_rounds=4 * (p_pad // 2))
    frac = isc.build_stack(isc.raw_stack(*counters[:, :4].T),
                           isc.SYNPA4_R_FEBE)
    firsts = solve & (torch.arange(N_APPS, device=dev) < partner0)
    fi, fj = frac[firsts], frac[partner0[firsts]]
    fb0 = regression.FALLBACK_RUNS
    layers = {
        "machine quantum": lambda: quantum(state0, partner0, draws, 1),
        "fused step, all": lambda: fstep(counters, partner0, init_st[0],
                                         masks, False),
        "  GN solve (8 LM steps)": lambda: regression._gn_solve(
            model, fi, fj, regression._log_init(fi),
            regression._log_init(fj), regression.GN_STEPS),
        "  heavy-ball fallback (2 x 80 steps)": lambda:
            regression._hb_best_of(model, fi, fj, 80, 1.5),
        "  pair_score kernel, fused": lambda: regression.pair_cost_matrix(
            model, st_q, n_valid=N_APPS, valid=masks[2], p=p_pad),
        "matcher, first quantum (seed + 2-opt)": lambda:
            matching.device_pairs_partner(cost, valid_p, eps=1e-2,
                                          max_rounds=4 * (p_pad // 2)),
        "matcher, refine (8 rounds)": lambda: matching.device_two_opt_partner(
            cost, matched, valid_p, eps=1e-2, max_rounds=8),
    }
    for name, fn in layers.items():
        _line("layers", f"{name:40s} {wall_ms(fn):9.3f} ms")
    fb_runs = regression.FALLBACK_RUNS - fb0
    _line("layers", f"the fused step above ran the fallback in {fb_runs} of 5 "
          f"calls; in the main race it ran in {fb_in_race} of "
          f"{N_QUANTA - 1} synpa quanta")
    _cost_prep_layers(dev, model, st_q, masks[2], False)

    # 7. Kernel time at the main path's shape, both modes.
    times = _pair_score_times(dev, rng, model, ps_kernel)
    ms, prof_us, plain_ms, bound_ms, bound_by = times["fused"]
    kernels = [{
        "name": "pair_score",
        "route": "cuda",
        "source": "src/repro_torch/kernels/pair_score/csrc/pair_score.cu",
        "replaces": "src/repro/kernels/pair_score/kernel.py:27",
        "launches": launches["pair_score"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "profiled_ms": prof_us * 1e-3,
        "unfused": dict(zip(("ms", "profiled_ms", "plain_ms", "bound_ms"),
                            (times["unfused"][0], times["unfused"][1] * 1e-3,
                             times["unfused"][2], times["unfused"][3]))),
    }]

    def stamp(phase: str) -> None:
        _line("time", f"phase {phase} ends at "
              f"{time.perf_counter() - t_start:.1f} s")

    stamp("7")
    # 8-11. The serving path.
    serve_errs = _serving_kernels_check(dev, rng)
    stamp("8")
    _serving_reference(dev)
    stamp("9")
    serve_readings = {}
    path_launches, _ = _serving_main_path(dev, kernel_mods,
                                          readings=serve_readings)
    stamp("10")
    kernels += _serving_kernel_times(dev, rng, serve_errs, path_launches)
    stamp("11")

    # 12-14. The open system.
    _open_reference(dev, model)
    stamp("12")
    open_launches, open_runs = _open_main_path(dev, model, kernel_mods)
    stamp("13")
    flag_ms, int_ms = _pair_score_flag_times(dev, rng, model, ps_kernel)

    # 15-18. The lane-batched grid and the seed-batched race.
    lanes_entry = _pair_score_lanes(dev, rng, model, ps_kernel)
    _open_grid_reference(dev, model)
    stamp("16")
    grid_launches, grid_runs = _open_grid_main_path(dev, model, kernel_mods)
    stamp("17")
    batched_launches = _batched_race(dev, model, kernel_mods, res, per_q)
    t_rings = time.perf_counter()

    # 19-21. The telemetry rings and the checkpointed run.
    ring_launches = _closed_rings(dev, model, kernel_mods, res, counted)
    t_20 = time.perf_counter()
    open_ring_launches, grid_ring_launches = _open_rings(
        dev, kernel_mods, open_runs, grid_runs)
    t_21 = time.perf_counter()
    ckpt_launches = _checkpointed_run(dev, kernel_mods, open_runs)
    rings_s = time.perf_counter() - t_rings
    phase_s = (t_20 - t_rings, t_21 - t_20, t_rings + rings_s - t_21)

    # 22-24. The host tier: the §6.2 race, the host race, the host loop.
    t_host = time.perf_counter()
    workload_launches = _workload_race(dev, model, kernel_mods)
    t_23 = time.perf_counter()
    host_race_launches = _host_race(dev, model, kernel_mods, res)
    t_24 = time.perf_counter()
    host_open_launches = _host_open(dev, model, kernel_mods, open_runs)
    host_s = time.perf_counter() - t_host
    host_phase_s = (t_23 - t_host, t_24 - t_23, t_host + host_s - t_24)

    # 25-28. The training path and the moe family.
    t_train = time.perf_counter()
    _train_reference(dev)
    t_26 = time.perf_counter()
    train_launches, train_readings = _train_main_path(dev, kernel_mods)
    t_27 = time.perf_counter()
    _serving_reference(dev, MOE_ARCH)
    t_28 = time.perf_counter()
    moe_serve_launches, _ = _serving_main_path(dev, kernel_mods, MOE_ARCH,
                                               "bfloat16")
    moe_train_launches = _moe_train(dev, kernel_mods)
    train_s = time.perf_counter() - t_train
    train_phase_s = (t_26 - t_train, t_27 - t_26, t_28 - t_27,
                     t_train + train_s - t_28)
    train_launches = {n: train_launches[n] + moe_train_launches[n]
                      for n in kernel_mods}

    # 29-31. The vlm and audio families: one flash launch a self block,
    # the whisper encoder's non-causal.
    from repro_torch.models.registry import get_config

    t_fam = time.perf_counter()
    _family_reference(dev)
    t_30 = time.perf_counter()
    vlm = get_config(VLM_ARCH)
    vlm_self = vlm.n_layers - vlm.n_layers // vlm.cross_attn_every
    vlm_launches, _ = _serving_main_path(dev, kernel_mods, VLM_ARCH,
                                         "bfloat16", expect=(vlm_self, 0))
    t_31 = time.perf_counter()
    audio = get_config(AUDIO_ARCH)
    audio_launches, audio_noncausal = _serving_main_path(
        dev, kernel_mods, AUDIO_ARCH, "bfloat16", seq=AUDIO_S,
        expect=(audio.n_layers + audio.encoder_layers, audio.encoder_layers))
    fam_s = time.perf_counter() - t_fam
    fam_phase_s = (t_30 - t_fam, t_31 - t_30, t_fam + fam_s - t_31)

    # 32-37. The last five architectures: gemma-7b (flash at D 256),
    # starcoder2-3b (a window in the prefill, a ring in decode), hymba-1.5b
    # and rwkv6-3b (the time loops), kimi-k2-1t-a32b at depth 1 (D 112).
    t_new = time.perf_counter()
    _new_family_reference(dev, fa_kernel)
    new_phase_s = [time.perf_counter() - t_new]
    new_launches = {}
    for arch in (GEMMA_ARCH, STARCODER_ARCH, HYMBA_ARCH, RWKV_ARCH,
                 KIMI_ARCH):
        t0 = time.perf_counter()
        spec = dict(NEW_PATHS[arch])
        cfg = get_config(arch, **spec.get("overrides", {}))
        flash = 0 if cfg.family == "ssm" else cfg.n_layers
        new_launches[arch], _ = _serving_main_path(
            dev, kernel_mods, arch, "bfloat16", seq=spec.pop("seq"),
            prefill_b=spec.pop("batch"), expect=(flash, 0), **spec)
        new_phase_s.append(time.perf_counter() - t0)
    new_s = time.perf_counter() - t_new

    # 38-40. The roofline's constants, the dry-run, co-location.
    t_dry = time.perf_counter()
    _roofline_constants(dev)
    t_39 = time.perf_counter()
    dry_records = _dryrun_cells()
    t_40 = time.perf_counter()
    coloc_launches = _colocation(dev, model, dry_records, kernel_mods)
    dry_s = time.perf_counter() - t_dry
    dry_phase_s = (t_39 - t_dry, t_40 - t_39, t_dry + dry_s - t_40)

    # 41. Training over a one-rank NCCL process group.
    t_mesh = time.perf_counter()
    mesh_launches = _train_mesh(dev, kernel_mods, train_readings)
    mesh_s = time.perf_counter() - t_mesh

    # 42. Serving over a one-rank NCCL process group.
    t_serve_mesh = time.perf_counter()
    serve_mesh_launches = _serve_mesh(dev, kernel_mods, serve_readings)
    serve_mesh_s = time.perf_counter() - t_serve_mesh

    new_paths = {"race_rings": ring_launches, "open_rings": open_ring_launches,
                 "grid_rings": grid_ring_launches,
                 "checkpointed": ckpt_launches,
                 "workload_race": workload_launches,
                 "host_race": host_race_launches,
                 "host_open": host_open_launches,
                 "train": train_launches, "moe_serve": moe_serve_launches,
                 "vlm_serve": vlm_launches, "audio_serve": audio_launches,
                 **{f"{arch.split('-')[0]}_serve": v
                    for arch, v in new_launches.items()},
                 "colocation": coloc_launches, "train_mesh": mesh_launches,
                 "serve_mesh": serve_mesh_launches}
    kernels[0]["path_launches"] = {
        "race": launches["pair_score"], "open": open_launches["pair_score"],
        "grid": grid_launches["pair_score"],
        "batched_race": batched_launches["pair_score"],
        **{k: v["pair_score"] for k, v in new_paths.items()}}
    kernels[0]["launches"] = sum(kernels[0]["path_launches"].values())
    kernels[0]["idle_flag_ms"] = flag_ms
    kernels[0]["idle_int_ms"] = int_ms
    kernels[0].update(lanes_entry)
    for entry in kernels[1:]:
        entry["path_launches"] = {"serve": entry["launches"],
                                  "open": open_launches[entry["name"]],
                                  "grid": grid_launches[entry["name"]],
                                  "batched_race":
                                      batched_launches[entry["name"]],
                                  **{k: v[entry["name"]]
                                     for k, v in new_paths.items()}}
    flash = next(e for e in kernels if e["name"] == "flash_attention")
    flash["noncausal_launches"] = {"audio_serve": audio_noncausal}
    all_s = time.perf_counter() - t_start
    total_s = t_fam - t_start
    before_new = t_new - t_start
    before_dry = t_dry - t_start
    before_mesh = t_mesh - t_start
    before_s = total_s - rings_s - host_s - train_s
    _line("done", f"{all_s:.1f} s in all; phases 19-21 {rings_s:.1f} s, "
          f"{100 * rings_s / before_s:.1f}% added to phases "
          f"1-18's {before_s:.1f} s (19: {phase_s[0]:.1f} s, 20: "
          f"{phase_s[1]:.1f} s, 21: {phase_s[2]:.1f} s); phases 22-24 "
          f"{host_s:.1f} s, {100 * host_s / (total_s - host_s - train_s):.1f}"
          "% added "
          f"to phases 1-21's {total_s - host_s - train_s:.1f} s (22: "
          f"{host_phase_s[0]:.1f} s, 23: {host_phase_s[1]:.1f} s, 24: "
          f"{host_phase_s[2]:.1f} s); phases 25-28 {train_s:.1f} s, "
          f"{100 * train_s / (total_s - train_s):.1f}% added to phases "
          f"1-24's {total_s - train_s:.1f} s (25: {train_phase_s[0]:.1f} s, "
          f"26: {train_phase_s[1]:.1f} s, 27: {train_phase_s[2]:.1f} s, 28: "
          f"{train_phase_s[3]:.1f} s); phases 29-31 {fam_s:.1f} s, "
          f"{100 * fam_s / total_s:.1f}% added to phases 1-28's "
          f"{total_s:.1f} s (29: {fam_phase_s[0]:.1f} s, 30: "
          f"{fam_phase_s[1]:.1f} s, 31: {fam_phase_s[2]:.1f} s); phases "
          f"32-37 {new_s:.1f} s, {100 * new_s / before_new:.1f}% added to "
          f"phases 1-31's {before_new:.1f} s ("
          + ", ".join(f"{32 + i}: {x:.1f} s" for i, x in
                      enumerate(new_phase_s)) + f"); phases 38-40 "
          f"{dry_s:.1f} s, {100 * dry_s / before_dry:.1f}% added to phases "
          f"1-37's {before_dry:.1f} s (38: {dry_phase_s[0]:.1f} s, 39: "
          f"{dry_phase_s[1]:.1f} s, 40: {dry_phase_s[2]:.1f} s); phase 41 "
          f"{mesh_s:.1f} s, {100 * mesh_s / before_mesh:.1f}% added to "
          f"phases 1-40's {before_mesh:.1f} s; phase 42 {serve_mesh_s:.1f} s,"
          f" {100 * serve_mesh_s / (t_serve_mesh - t_start):.1f}% added to "
          f"phases 1-41's {t_serve_mesh - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
