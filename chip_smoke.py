#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Needs one CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/ragged_gather/csrc/slab.cu``, ``slab_reduce.cu``,
``pack.cu``, ``src/repro_torch/kernels/flash_attention/csrc/flash.cu`` and
``src/repro_torch/kernels/rg_lru/csrc/rglru.cu`` on first use, one
``nvcc`` each, all at once).
Phases, in order; any failure raises and the exit code is nonzero:

1. device: the card's name and power limit (``nvidia-smi``), and the
   kernels' build time; ``ptxas``'s registers and spills of every kernel;
   K8's Hopper kernel (hd 64, 128, 256) and its mma.sync kernel at hd 80,
   K1's and K6's bulk-copy kernels and K9's single pass must not spill;
2. kernels vs plain: K1–K3 against their plain PyTorch versions on the
   card at the gatherv path's shapes (P=16, ``buf_rows`` of the
   ``spikes`` plan, F=1024 fp32, and F=2048 bf16), and K4–K5 at the
   ``spikes`` reduce_scatterv plan's shapes (fp32 F=1024, bf16 F=2048,
   int32 F=1024, send windows overlapping the merge window fully, partly
   and from below), bitwise (tolerance 0: K1–K3 move bytes, K4–K5 add
   once per element in the working dtype exactly as the plain versions
   do), each timed beside its bound and, where one PyTorch call computes
   the same function, that call (kernel, plain and library in turns over
   ``TURN_ROUNDS`` rounds; K1 and K2 with their % of the bound, the
   rounds' range and K1 / ``index_select``, K2 / ``index_copy_``; K4
   against ``index_add_``);
3. the gatherv path: TUW gatherv and scatterv on ``LocalMesh(16)``, all
   six distributions of the paper at b=2048 rows of 4 KiB per rank,
   roots {0, 7, 15}, segments {1, 4}, bitwise against ``np.concatenate``
   and the input blocks; ``gatherv_shard`` / ``scatterv_shard`` timed on
   device tensors; K1–K3 must have been launched;
4. where the time goes: ``torch.profiler`` over gatherv+scatterv pairs
   (K1's share of the busy time) and over reduce_scatterv;
5. the reduction and composed path on ``LocalMesh(16)``, the six
   distributions at b=2048, F=1024 fp32, segments {1, 4}:
   ``run_reduce_scatterv`` / ``run_allreducev`` bitwise against the same
   entry point on the plain versions (``use_kernel_dataplane(False)``),
   the same plans at F=16 bitwise against the port's NumPy executors,
   S=4 bitwise equal to S=1, and ``run_allgatherv`` / ``run_alltoallv``
   bitwise against ``np.concatenate``; every ``*_shard`` timed on device
   tensors; K1–K5 must have been launched;
6. the MoE path, Mixtral-8x7B's MoE layer at its published widths
   (d_model 4096, 8 experts, top-2, d_ff 14336, capacity factor 1.25,
   bf16 experts, fp32 router; random weights from the seed) on a batch
   of 4 × 1024 tokens: (a) K6/K7 bitwise against their plain versions at
   the layer's dispatch, combine and unpack shapes (bf16 D=4096) and at
   fp32 F=1024 and F=7, timed beside their bound and the library call in
   turns (each case's % of its bound, the rounds' range and kernel /
   library);
   (b) ``moe_apply`` through the kernels bitwise against the same call on
   the plain versions, and within 2e-2 (relative Frobenius) of an fp32
   recomputation of 64 tokens from the layer's routing tables; (c) the
   expert exchange of ``examples/moe_irregular.py`` on ``LocalMesh(8)``
   (device j owns expert j): ``pack_blocks`` → ``alltoallv_shard`` →
   ``unpack_blocks`` equal to the dispatch buffers, and ``pack_blocks`` →
   ``gatherv_shard`` → ``unpack_blocks`` equal to the expert outputs in
   their kept rows, bitwise; K1–K3, K6 and K7 must have been launched;
7. the serving path, yi-6b at its published widths and full depth (32
   layers, d_model 4096, 32 heads with GQA kv=4, hd 128, d_ff 11008,
   vocab 64000; bf16, random weights from the seed): (a) K8 against its
   plain version (2e-2 absolute and relative in bf16, 2e-5 in fp32) at
   yi-6b's prefill (B=4, T=2048), Mixtral-8x7B's window (T=8192, window
   4096), an odd length (T=1000), non-causal (T=384), fp32 (hd 64, window
   128) and hd 256 (window 2048), each timed beside its bound and
   ``scaled_dot_product_attention`` (achieved TFLOP/s and the kernel's
   time over SDPA's on each line); (b) ``serve_requests`` on 8 requests
   of 1024–2048 prompt tokens in batches of 4, 32 greedy tokens each, K8
   required; one prefill launches K8 once a layer and a decode step never;
   finite logits; the prefill's last logits within 2e-2 (relative
   Frobenius) of the plain versions' (``use_kernel_dataplane(False)``);
   prefill of 256 tokens then 4 decode steps within 2e-2 of ``forward``
   over the 260 tokens; both checks again with fp32 activations on the
   same weights, within 1e-3 (32 bf16 layers of rounding alone come near
   2e-2); prefill and decode times, tokens/s, peak memory and a
   ``torch.profiler`` breakdown of a prefill and a decode step;
8. the recurrent serving path, recurrentgemma-2b at its published widths
   and full depth (26 layers: 8 periods of two RG-LRU blocks and a local
   attention block, then two RG-LRU blocks; d_model 2560, 10 heads with
   MQA kv=1, hd 256, d_ff 7680, vocab 256000, window 2048; bf16, random
   weights from the seed): (a) K9 against its plain version (1e-5) at the
   prefill's shape with h0 = 0 and with a random h0, an odd shape (B 3, T
   1000, D 2558, the two-pass path) and T = 1, each with the path it takes
   and timed beside its bound; (b)
   ``serve_requests`` on 8 requests of 2049–3072 prompt tokens (past the
   window, so the ring wraps in prefill and in decode) in batches of 4, 32
   greedy tokens each, K8 and K9 required, with times, tokens/s, peak
   memory and a profile of a prefill and a decode step; (c) checks: one
   prefill launches K9 once an RG-LRU block and K8 once a local block, a
   decode step neither, finite logits; with fp32 activations on the same
   weights, the prefill against the plain versions and prefill + 4 decode
   steps against ``forward`` over 2104 tokens within 1e-3; in bf16, every
   block fed the plain path's hidden state through the kernels within
   2e-2 of the plain versions; the bf16 full-depth readings (as in phase
   7) within a gate of ``max(2e-2, 2 x floor)``, the floor being the move
   of the prefill's last logits when 1, 10 and 1000 embedded input
   elements move by one bf16 ulp, measured in the same run; and a planted
   fault (one local block at half its window, set through the config) must
   fail the per-block check and pass the gate;
9. the paper's trees on the card: on ``LocalMesh(16)``, the six
   distributions at b=2048 rows of 4 KiB a rank, roots 0, 7 and the free
   root of ``build_gather_tree``, the TUW, linear, DP-optimal
   (``optimal_gather_tree`` at the paper's ``CostParams.infiniband_qdr()``,
   beta scaled to a 4 KiB row), two-level (4 ranks a host) and 2-ported
   trees go through ``plan_gatherv(tree=...)``: ``run_gatherv`` and
   ``run_scatterv`` bitwise against ``np.concatenate`` and the input
   blocks, ``gatherv_shard`` / ``scatterv_shard`` timed as in phase 3, each
   line with its steps, exact and padded bytes and the port's
   ``simulate_gather`` of the tree at the paper's cluster parameters (not
   the card's); binomial, 3-nomial and graceful-degradation trees must be
   refused by ``plan_gatherv`` exactly when an edge with data has
   ``lo = -1`` (then priced by the model only) and run otherwise; G2
   measured at root 0 (the TUW gatherv over an allreducev of one row plus
   the gatherv of the max-padded problem, no gate); all with the port's
   ``obs.trace`` on: one span per ``run_*`` call, ``span_times_by("op")``
   covering them, the Chrome trace saved under ``build/`` and read back,
   and each plan's bytes split over a 4 × 4 ``HostTopology`` summing to
   the flat count; K1–K3 must have been launched;
10. the tuner on the card, on ``LocalMesh(16, hosts=4)`` at phase 9's
   sizes: (a) ``HostTopology.from_mesh`` reads 4 x 4 and
   ``mesh_fingerprint`` carries ``hosts=4x4`` (unlike the flat mesh's);
   ``tree_metadata_exchange`` on the card agrees on every rank with the
   root, total and ``total - sizes[root]`` of ``build_gather_tree`` and
   ``build_gather_tree_distributed`` for each distribution; (b)
   ``calibrate(MeshTimingBackend(LocalMesh(2)))`` over 4 KiB to 64 MiB
   (``CAL_SIZES``; the reference's ``DEFAULT_SIZES`` stop where a device
   copy is far below one launch): alpha, beta and r2 of the emulated
   dataplane (a device-local copy, not a link), and ``calibrate_axes``
   over ``device`` and ``host`` finite and positive (on one card both
   time the same copy); (c) for each distribution, gatherv and scatterv
   at root 0, allgatherv, alltoallv (phase 5's size matrix),
   reduce_scatterv and allreducev: every candidate of
   ``enumerate_candidates(view="dataplane", topology=HostTopology(4,
   4))`` at the card's fitted alpha and beta (beta per 4 KiB row) raced
   by ``select`` through its ``*_shard`` entry point (CUDA events, median of ``RACE_REPS``), each
   result bitwise (byte moves against the concatenated blocks, reductions
   at F=4 against the NumPy executors and the full width's first four
   columns against that);
   the races feed ``OnlineCalibrator``s seeded with (b)'s fit; one line a
   problem with the model's and the measured argmin, Kendall's tau, each
   candidate's model and measured time and the refit (the agreement is a
   finding, not a gate); K1–K5 must have been launched;
11. the planner service and the serving planner on the card: (a)
   ``PlannerService(mesh=LocalMesh(16), calibration=<10b's fit>,
   quantum=1)`` runs the six ops on the six distributions at b=2048 rows
   of 1 KiB (``SERVICE_F``), root 0, each called ``SERVICE_CALLS`` times
   with fresh data: the first call builds the executor and captures its
   CUDA graph (a miss), the others replay it (hits); every result bitwise
   (byte moves against ``np.concatenate``, reductions' first ``ORACLE_F``
   columns against the NumPy executors on the same plan, and all against
   ``run_*`` lowering the same plan); every replay must add the launches
   its capture recorded, and the captures and the replays must each have
   launched K1–K5; each executor's replay bitwise its eager body (the
   ``*_shard`` call on the same tables and static input) and both timed
   on the card; per problem the capture, call, replay and ``run_*``
   times, the executor's bytes and the launches a replay adds; after
   each problem the device memory held must match what the kept
   executors account for and stay within their bound; the residual
   ledgers and the guideline monitor; one replay under
   ``torch.profiler``; (b) yi-6b
   (phase 7's weights and requests) served without and with a plan-only
   ``ServingPlanner`` on ``--experts 4``'s routing, the tokens those of
   phase 7b; a ``ServingPlanner`` on a mesh service over
   ``LocalMesh(8)`` driven through ``serve_trace(8, 64)`` by ``dispatch``
   (bf16 rows of 4096, carried as int16 bits) and ``combine`` (fp32 rows
   of 4096), each step bitwise (the dispatch against ``np.concatenate``,
   the combine against a plan-only twin's NumPy path, the classes the
   twin's), with the captures after the first 16 steps; (c) a capture that
   synchronises the device raises, and the launch counts come back; K1–K5
   and K8 must have been launched;
12. the training path on the card, TF32 off (torch's default), so the
   card computes the reference's fp32 function: (a) ``launch/train``'s
   run of granite-3-2b at full width and depth in fp32 (40 layers,
   d_model 2048, 2.53 B parameters; random weights from the seed):
   ``SyntheticLM`` batches of 2 × 512, lr 3e-3, 6 steps through
   ``TrainLoop``, one checkpoint at the end into a temporary directory
   removed afterwards; the loss finite and falling, step times, tokens/s,
   peak memory against the prediction, the checkpoint's snapshot and
   write times; (b) at full width, depth cut to 2 layers: one train step
   on the card against the same step on the CPU from the same state
   (loss and the gradient's global norm within 1e-5 relative, every
   updated parameter and every leaf of mu, which is 0.1 x the clipped
   gradient, within 1e-4 relative Frobenius), and the same step of
   reduced mixtral-8x7b (the MoE layer) and reduced recurrentgemma-2b at
   T 768 (the chunked RG-LRU scan), which a dense model cannot show;
   then the reference's restart equivalence (12
   steps, a checkpoint every 5, against a run killed at step 7 and
   resumed at step 5) within 1e-6 on params, mu and nu, and whether it is
   bitwise under ``torch.use_deterministic_algorithms``
   (``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts); K6, K8 and K9
   must not launch in (a) or (b), as the model trains on the reference's
   plain computation; (c) the fault runtime on ``LocalMesh(16)`` at phase
   3's sizes (``random``): gatherv, allgatherv and reduce_scatterv
   bitwise under an injected transient ``TimeoutFault`` with the retries
   counted, a persistent one escalated to ``CollectiveTimeout``, a
   ``TrainLoop`` whose straggler ladder climbs on those timeouts to evict,
   checkpoints and hands off to a handler that shrinks the gatherv onto
   ``LocalMesh(15)`` (bitwise) and plans the checkpoint's consolidation
   over the survivors, and a ``warn`` from ``ChaoticMachine``'s span
   times that reaches a mesh ``PlannerService`` (one epoch bump, the next
   plan bitwise); K1–K5 must have been launched;
13. the rest of the model zoo, TF32 off: (a) ``launch/train``'s run of
   xlstm-125m at full width and depth in fp32 (12 layers, d_model 768, 4
   heads of 192; 75.9 M parameters) on ``SyntheticLM`` batches of 8 x 1024
   (the chunkwise mLSTM), lr 3e-3, 6 steps: the loss finite and falling,
   step times, tokens/s, peak memory; (b) 12b's step parity for
   xlstm-125m at full width cut to its three mLSTM blocks (2 x 768, the
   chunkwise form under autograd), xlstm-125m at full width and depth (2
   x 64, the sLSTM loop under autograd, the parameters reported, not
   gated), each limit raised to twice the move of the card's own step
   between two summation orders, and reduced llama-3.2-vision-11b (2 x
   128 with 8 image tokens); K6, K8 and K9 must not launch in (a) or
   (b); (c) xlstm-125m served in bf16 at full width and depth as phase 7
   serves yi-6b: no kernel launched, the fp32 view's prefill + decode
   against ``forward`` within 1e-3 and the bf16 one within phase 8's gate,
   what the sLSTM loop costs (kernels and time of one block's prefill, its
   share of a prefill) and a profile; (d) K8 at the cross-attention's
   shapes (T 2048 and T 1 against 1600 image tokens, non-causal), then
   llama-3.2-vision-11b served in bf16 at full width and depth (40 layers,
   8 of them cross; fp32 image embeddings (4, 1600, 4096) from the seed)
   through ``make_prefill_step`` / ``make_decode_step``: one prefill
   launches K8 48 times, a decode step 8, and phase 7's checks (the bf16
   readings under phase 8's gate: at 40 layers they sit at the floor);
   (e) K8 at stablelm-3b's head dim 80 and at llama3-405b's 128/8 heads,
   then one prefill of 4 x 1024 and 4 decode steps of stablelm-3b,
   musicgen-large (frame embeddings in, gelu) and llama3-405b cut to 4
   layers, each against the plain versions and ``forward`` under phase
   8's gate.  In (a)-(c)
   every sLSTM ``rh`` is scaled to its fan-in (``slstm_fan_in``): at the
   reference's init the sLSTM recurrence is chaotic;
14. the sharding layer, TF32 off: (a) granite-3-2b at full width and
   depth in fp32, a batch of 2 x 512 from the seed, ``REMAT_STEPS`` train
   steps from the seed's weights under each ``remat`` (``none``, ``full``,
   ``dots``): the first step's loss and gradient norm of ``full`` and
   ``dots`` within 1e-6 relative of ``none`` (and whether bitwise), each
   mode's peak memory and ms per step; then ``full`` at 24 x 512, a
   batch whose activations ``none`` cannot hold (its need reckoned from
   its own growth at 2 x 512); (b) a one-rank NCCL process
   group made and destroyed in the phase and a ``(1, 1)`` CUDA
   ``DeviceMesh`` ``("data", "model")``: the same model's steps on a
   DTensor state under ``grad_shard,fsdp_gather`` (``launch.specs``)
   against the same steps unsharded, within 12b's limits (loss and
   gradient norm 1e-5 relative at every step, every parameter and mu
   leaf 1e-4 relative Frobenius after the last), and its ms per step
   against the unsharded ``full``: on size-1 mesh dims no placement moves
   a byte, so the difference is what DTensor's dispatch costs.  K6, K8
   and K9 must not launch.

Every phase runs under a watchdog (``faulthandler.dump_traceback_later``
with the phase's limit in ``PHASE_LIMIT_S``): a phase that hangs ends
the script with every thread's stack and exit code 1.  The line before
the last is a JSON object with one entry per kernel (K1–K9), launches
counted over phases 3 and 5–14; the last is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# phase 12b holds a resumed run to an uninterrupted one under
# torch.use_deterministic_algorithms, which needs cuBLAS's workspace fixed
# before CUDA is initialised
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
# float32 outside the tensor cores (NVIDIA data sheet); K4/K5 add every
# dtype on those units (bf16 widened to float32)
ADD_OPS_PER_S = 67e12
P, B, F, SEED = 16, 2048, 1024, 0
ROOTS, SEGMENTS = (0, 7, 15), (1, 4)
KERNEL_REPS, PATH_REPS = 20, 5
TURN_ROUNDS = 5        # phases 2 and 6a: rounds of kernel, plain, library
L2_FLUSH_BYTES = 256 << 20   # five times the H100's 50 MB L2 (cold_ms)
HOST_WINDOW_CYCLES = 1_000_000   # cold_ms: ~0.5 ms of SM clock for the host
ORACLE_F = 16          # width of the NumPy-oracle check of phase 5
A2A_B = 128            # alltoallv: S[i][j] = block_sizes(name, P, A2A_B, i)[j]
MOE_ARCH, MOE_B, MOE_S = "mixtral-8x7b", 4, 1024
MOE_DTYPE = torch.bfloat16   # expert weights and activations; router fp32
MOE_P = 8              # LocalMesh of the expert exchange: device j owns expert j
MOE_REF_TOKENS = 64    # tokens of the fp32 recomputation
MOE_REF_TOL = 2e-2     # relative Frobenius error of the bf16 layer vs fp32
ODD_F = 7              # the odd width of phase 6a: 28-byte fp32 rows
# bf16 tensor cores and fp32 outside them, dense (NVIDIA data sheet)
FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
SERVE_ARCH, SERVE_DTYPE = "yi-6b", "bfloat16"
SERVE_REQUESTS, SERVE_BATCH, SERVE_GEN = 8, 4, 32
SERVE_PROMPT = (1024, 2048)   # prompt lengths, drawn from the seed
SERVE_TOL = 2e-2       # relative Frobenius, bf16 logits of two orders
MECH_TOL = 1e-3        # the same with fp32 activations (products reordered)
CONSIST_T, CONSIST_STEPS = 256, 4
RG_ARCH = "recurrentgemma-2b"
RG_PROMPT = (2049, 3072)      # past the 2048-token local window
RG_CONSIST_T = 2100           # prefill past the window, then decode steps
RG_FLOOR_ELEMENTS = (1, 10, 1000)   # embedded inputs moved by one bf16 ulp
RG_FAULT_WINDOW = 1024        # the planted fault: one local block's window
RGLRU_TOL = 1e-5              # K9 vs plain (the reference's Pallas tolerance)
ZOO_ROOTS = (0, 7)            # phase 9, and the free root of build_gather_tree
ZOO_QDR_ROW = 1024            # MPI_INT units in a 4 KiB row (the paper's beta)
ZOO_HOSTS = (4, 4)            # hosts x ranks of the link-class split
TUNER_HOSTS = (4, 4)          # phase 10: LocalMesh(16, hosts=4)
# phase 10's calibration sweep: 4 KiB to 64 MiB, the slabs the plans move
# (the reference's DEFAULT_SIZES stop at 1 MiB, where a device copy is far
# below one launch and beta is not identified)
CAL_SIZES = tuple(4096 << (2 * i) for i in range(8))
CAL_REPEATS = 5
RACE_REPS = 3          # phase 10: CUDA-event median per raced candidate
# phase 10's NumPy check of each raced reduction: 16-byte rows (at F=16 the
# checks of the 60 reduction candidates kept the phase near two minutes)
RACE_ORACLE_F = 4
# phase 11a: the planner service at 1 KiB fp32 rows (at 4 KiB rows the
# reductions' host copies, p x total x F in and out, reach 3.2 GiB a call)
SERVICE_F, SERVICE_CALLS, SERVICE_ROOT = 256, 3, 0
SERVICE_KERNELS = ("slab_extract", "slab_merge", "slab_step",
                   "slab_merge_add", "slab_step_reduce")
# the device memory held after a problem may differ from what the kept
# executors account for by this much (allocator segments round up)
HELD_SLACK = 1 << 30
REPLAY_ROUNDS, REPLAY_REPS = 3, 3   # replay against eager body, in turns
# phase 11b: --experts 4's routing of the served tokens, and the serving
# planner on LocalMesh(MOE_P) over the diurnal trace at Mixtral's d_model
SERVE_EXPERTS, SERVE_TOP_K, SERVE_CLASS_BOUND = 4, 2, 0.25
MOE_TRACE_STEPS, MOE_D_MODEL, MOE_WARMUP_STEPS = 64, 4096, 16
# phase 12a: launch/train's run of granite-3-2b at full width and depth in
# fp32; the memory predicted from 16 bytes a parameter (params, grads, mu,
# nu) plus the activations of batch 2 x 512
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_LR, TRAIN_STEPS = (
    "granite-3-2b", 2, 512, 3e-3, 6)
TRAIN_PRED_GB = 52
# phase 12b: full width, depth cut to 2 layers; the card's step against
# the CPU's on batch 2 x 128 (CPU-sized), then the reference's restart
# equivalence (12 steps, a checkpoint every 5, killed at 7)
PARITY_LAYERS, PARITY_B, PARITY_T = 2, 2, 128
PARITY_LOSS_RTOL, PARITY_PARAM_RTOL = 1e-5, 1e-4
# ... and a step of the MoE layer (reduced mixtral-8x7b) and of the RG-LRU
# scan (reduced recurrentgemma-2b, T 768 takes the chunked scan), which a
# dense granite cannot show: under autograd they must run the plain MoE
# gathers and the associative scan, launching neither K6 nor K9
PARITY_REDUCED = (("mixtral-8x7b", PARITY_T), ("recurrentgemma-2b", 768))
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL, RESTART_TOL = 12, 5, 7, 1e-6
# phase 12c: the fault runtime on LocalMesh(16) at phase 3's sizes
FAULT_DIST, FAULT_VICTIM, FAULT_FACTOR, FAULT_RETRIES = "random", 2, 16.0, 2
# phase 13: the rest of the model zoo.  13a: launch/train's run of
# xlstm-125m at full width and depth in fp32 on batches of 8 x 1024 (T >
# 512 and a multiple of 256: the chunkwise mLSTM); the memory predicted
# from 16 bytes a parameter plus the activations
XLSTM_ARCH, XLSTM_B, XLSTM_T, XLSTM_PRED_GB = "xlstm-125m", 8, 1024, 12
# 13b: xlstm-125m at full width on the card against the CPU: its three
# mLSTM blocks at T 768 (three chunks of the chunkwise mLSTM), and the
# whole depth at T 64 (the sLSTM loop); reduced llama-3.2-vision-11b at
# PARITY_T
PARITY_XLSTM_T, PARITY_SLSTM_T = 768, 64
VLM_ARCH = "llama-3.2-vision-11b"
# 13e: a prefill of 4 x 1024 and CONSIST_STEPS decode steps of each arch,
# at full width; llama3-405b's depth cut to 4 layers to fit one card
ARCH_B, ARCH_T = 4, 1024
ARCHS_13E = (("stablelm-3b", None), ("musicgen-large", None),
             ("llama3-405b", 4))
# phase 14: the sharding layer.  14a: granite-3-2b in fp32 at full width
# and depth, REMAT_STEPS steps at REMAT_B x REMAT_T under each remat (the
# first step compared, the rest timed), then "full" at REMAT_BIG_B, a
# batch whose activations "none" cannot hold on the card (checked in the
# run against none's own growth a sequence at REMAT_B); 14b:
# its steps on a (1, 1) CUDA mesh under SHARDED_VARIANT against the same
# steps unsharded, within 12b's limits
REMAT_MODES, REMAT_RTOL = ("none", "full", "dots"), 1e-6
REMAT_B, REMAT_T, REMAT_BIG_B, REMAT_STEPS = 2, 512, 24, 4
SHARDED_VARIANT, SHARDED_STEPS = "grad_shard,fsdp_gather", 3
# phase 15: the serving cells executed sharded.  15a: phase 7's and 8's
# models and first batches, a prefill and SHARDED_SERVE_STEPS decode steps
# through the step builders on a (1, 1) CUDA DeviceMesh against the same
# steps unsharded (the sharded run fed the unsharded run's greedy tokens);
# 15b: analysis.flow on meta for yi-6b's prefill of that batch and one
# decode step, against FlopCounterMode on the card
SHARDED_SERVE_STEPS = 32
# the hang watchdog: each phase's limit in seconds, about three times its
# longest measured time on the H100 (at least two minutes; phase 1 builds
# the kernels, in seconds here, but nvcc's time varies between machines)
PHASE_LIMIT_S = {1: 300, 2: 120, 3: 120, 4: 120, 5: 450, 6: 120, 7: 120,
                 8: 120, 9: 150, 10: 120, 11: 500, 12: 300, 13: 450,
                 14: 240, 15: 180}
CSRC = "src/repro_torch/kernels/ragged_gather/csrc/"
SOURCES = {"slab_extract": CSRC + "slab.cu", "slab_merge": CSRC + "slab.cu",
           "slab_step": CSRC + "slab.cu",
           "slab_merge_add": CSRC + "slab_reduce.cu",
           "slab_step_reduce": CSRC + "slab_reduce.cu",
           "ragged_gather": CSRC + "pack.cu",
           "ragged_scatter": CSRC + "pack.cu",
           "flash_attention":
               "src/repro_torch/kernels/flash_attention/csrc/flash.cu",
           "rglru_scan": "src/repro_torch/kernels/rg_lru/csrc/rglru.cu"}
REPLACES = {"slab_extract": "src/repro/kernels/ragged_gather/kernel.py:123",
            "slab_merge": "src/repro/kernels/ragged_gather/kernel.py:277",
            "slab_step": "src/repro/kernels/ragged_gather/kernel.py:168",
            "slab_merge_add": "src/repro/kernels/ragged_gather/kernel.py:208",
            "slab_step_reduce":
                "src/repro/kernels/ragged_gather/kernel.py:247",
            "ragged_gather": "src/repro/kernels/ragged_gather/kernel.py:53",
            "ragged_scatter": "src/repro/kernels/ragged_gather/kernel.py:92",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:78",
            "rglru_scan": "src/repro/kernels/rg_lru/kernel.py:43"}


def log(*a) -> None:
    print(*a, flush=True)


def release() -> None:
    """Frees what a phase left behind: garbage cycles first (their
    tensors stay allocated until a collection), then the allocator's
    cache."""
    gc.collect()
    torch.cuda.empty_cache()


class Watchdog:
    """Runs each phase under ``faulthandler.dump_traceback_later`` with its
    limit (``PHASE_LIMIT_S``), cancelled at the phase's end: a wait that
    never ends (a CUDA event that never completes) ends the script with
    every thread's stack on stderr and exit code 1, not a silent stall.
    Each phase starts from the memory the one before released."""

    def __init__(self):
        self.phase, self.t0 = None, 0.0

    def start(self, phase: int, title: str) -> None:
        self.stop()
        release()
        log(f"== phase {phase}: {title}")
        log(f"  device memory at the start: "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
        self.phase, self.t0 = phase, time.perf_counter()
        faulthandler.dump_traceback_later(PHASE_LIMIT_S[phase], exit=True)

    def stop(self) -> None:
        if self.phase is None:
            return
        faulthandler.cancel_dump_traceback_later()
        log(f"  phase {self.phase} watched s: "
            f"{time.perf_counter() - self.t0:.1f} (limit "
            f"{PHASE_LIMIT_S[self.phase]})")
        self.phase = None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cold_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run, with the L2 cache flushed before each run: a
    buffer five times the L2 is zeroed just before the first event, so
    the inputs come from HBM.  The card then sleeps ``HOST_WINDOW_CYCLES``
    (about 0.5 ms) before the first event, and the host enqueues ``fn``
    meanwhile, so a kernel is timed without its wrapper's host cost (the
    flush alone, about 0.08 ms, hid less than K8's wrapper took late in a
    long run)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(HOST_WINDOW_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def in_turns(fns: dict, timer, reps: int) -> dict:
    """Each thunk of ``fns`` timed by ``timer(fn, reps)`` once a round, in
    turns, for ``TURN_ROUNDS`` rounds: ``{name: (median, lowest,
    highest)}`` over the rounds' readings."""
    times = {k: [] for k in fns}
    for _ in range(TURN_ROUNDS):
        for k, fn in fns.items():
            times[k].append(timer(fn, reps))
    return {k: (float(np.median(t)), min(t), max(t)) for k, t in times.items()}


def ptxas_report(build_log: str) -> dict:
    """Registers and spills of each kernel in ``nvcc -Xptxas -v``'s
    output, by (mangled) entry function."""
    out: dict = {}
    name = None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "bytes spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name].update(stack=nums[0], spill_stores=nums[1],
                             spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def placed(start: np.ndarray, buf_rows: int, rows: int) -> np.ndarray:
    """Row where each rank's window starts, as the kernels place it."""
    s = np.where(start < 0, start + buf_rows, start).astype(np.int64)
    return np.clip(s, 0, buf_rows - rows)


def bitwise_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if torch.equal(a, b):
        return 0.0
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 2

def kernel_phase(dev, plan, dtype, width, record: dict | None) -> None:
    """K1–K3 vs plain on the card at ``plan``'s shapes; fills ``record``
    with this case's numbers when it is given."""
    from repro_torch.kernels.ragged_gather import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    buf_rows = plan.buf_rows
    payloads = [s[1] for s in plan.steps]
    rows = max(payloads)
    k = max(range(len(payloads) - 1),
            key=lambda i: payloads[i] + payloads[i + 1])
    rows_in, rows_out = payloads[k], payloads[k + 1]
    row_bytes = width * torch.tensor([], dtype=dtype).element_size()
    buf = torch.randn((P, buf_rows, width), generator=g, device=dev).to(dtype)
    slab = torch.randn((P, rows, width), generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(SEED)
    # starts: in range, negative (counted from the end), far past the end
    start = rng.integers(-buf_rows, buf_rows + rows, size=P).astype(np.int32)
    start[:3] = (-3, buf_rows + 7, -2 * buf_rows)
    valid = np.where(rng.random(P) < 0.5, 0, rows).astype(np.int32)
    valid[3] = rows
    send = start.copy()          # send window overlaps the merge window
    send[1::2] += rng.integers(-rows_out, rows_out, size=P // 2).astype(np.int32)
    st, va, se = (torch.from_numpy(x).to(dev) for x in (start, valid, send))
    step_valid = np.minimum(valid, rows_in)

    # correctness, on fresh copies
    errs = {}
    errs["slab_extract"] = bitwise_err(ops.slab_extract(buf, st, rows),
                                       ref.slab_extract_ref(buf, st, rows))
    errs["slab_merge"] = bitwise_err(
        ops.slab_merge(buf.clone(), slab, st, va),
        ref.slab_merge_ref(buf.clone(), slab, st, va))
    got = slab[:, :rows_in].contiguous()
    kb, ko = ops.slab_step(buf.clone(), got, st, va, se, rows_out)
    pb, po = ref.slab_step_ref(buf.clone(), got, st, va, se, rows_out)
    errs["slab_step"] = max(bitwise_err(kb, pb), bitwise_err(ko, po))
    del kb, ko, pb, po
    for name, e in errs.items():
        if e != 0.0:
            raise AssertionError(f"{name} ({dtype}, F={width}) differs from "
                                 f"its plain version: max abs err {e}")

    # bytes each function must move (each input read once, each output
    # written once), from this run's tables
    nv = np.clip(valid, 0, rows).astype(np.int64)
    nv_in = np.clip(step_valid, 0, rows_in).astype(np.int64)
    rs = placed(start, buf_rows, rows_in)
    ss = placed(send, buf_rows, rows_out)
    overlap = np.clip(np.minimum(ss + rows_out, rs + nv_in)
                      - np.maximum(ss, rs), 0, None)
    nbytes = {
        "slab_extract": 2 * P * rows * row_bytes,
        "slab_merge": 2 * int(nv.sum()) * row_bytes,
        "slab_step": int((2 * nv_in + 2 * rows_out - overlap).sum())
        * row_bytes,
    }

    # timing: merge and step are idempotent on a working copy; the library
    # call for K2 is one index_copy_ of the valid slab rows into the
    # flattened working copy, index and rows prepared outside
    work = buf.clone()
    flat = buf.view(-1, width)
    first = torch.from_numpy(placed(start, buf_rows, rows)).to(dev)
    rowidx = (torch.arange(P, device=dev)[:, None] * buf_rows
              + first[:, None] + torch.arange(rows, device=dev)).reshape(-1)
    merge_idx = torch.cat([rowidx[r * rows: r * rows + int(nv[r])]
                           for r in range(P)])
    merge_src = torch.cat([slab[r, : int(nv[r])] for r in range(P)])
    work_flat = work.view(-1, width)
    lib_merge = buf.clone()
    lib_merge.view(-1, width).index_copy_(0, merge_idx, merge_src)
    if not torch.equal(lib_merge, ops.slab_merge(buf.clone(), slab, st, va)):
        raise AssertionError("index_copy_ of the valid slab rows does not "
                             "compute K2's function")
    del lib_merge
    fns = {
        "slab_extract": (lambda: ops.slab_extract(buf, st, rows),
                         lambda: ref.slab_extract_ref(buf, st, rows),
                         lambda: flat.index_select(0, rowidx)),
        "slab_merge": (lambda: ops.slab_merge(work, slab, st, va),
                       lambda: ref.slab_merge_ref(work, slab, st, va),
                       lambda: work_flat.index_copy_(0, merge_idx,
                                                     merge_src)),
        "slab_step": (lambda: ops.slab_step(work, got, st, va, se, rows_out),
                      lambda: ref.slab_step_ref(work, got, st, va, se,
                                                rows_out), None),
    }
    for name, (kfn, pfn, lfn) in fns.items():
        t = in_turns({"kernel": kfn, "plain": pfn,
                      **({"library": lfn} if lfn else {})}, median_ms,
                     KERNEL_REPS)
        ms, plain_ms = t["kernel"][0], t["plain"][0]
        lib_ms = t["library"][0] if lfn else None
        bound_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        log(f"  {name:13s} {str(dtype):15s} F={width} rows={rows} "
            f"rows_in={rows_in} rows_out={rows_out} buf_rows={buf_rows} "
            f"bytes={nbytes[name]} kernel_ms={ms:.4f} bound_ms={bound_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"max_abs_err={errs[name]}")
        if lfn:
            kn, call = {"slab_extract": ("K1", "index_select"),
                        "slab_merge": ("K2", "index_copy_")}[name]
            log(f"  {kn} {dtype} F={width}: {ms:.4f} ms "
                f"[{t['kernel'][1]:.4f}, {t['kernel'][2]:.4f}], "
                f"{100 * bound_ms / ms:.1f} % of the bound; {call} "
                f"{lib_ms:.4f} ms [{t['library'][1]:.4f}, "
                f"{t['library'][2]:.4f}]; {kn} / {call} {ms / lib_ms:.3f}")
        if record is not None:
            record[name] = {"name": name, "route": "cuda",
                            "source": SOURCES[name],
                            "replaces": REPLACES[name], "launches": 0,
                            "max_abs_err": errs[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": "bytes", "library_ms": lib_ms}
    del buf, slab, work, got, merge_src
    torch.cuda.empty_cache()


def _rand(g, shape, dtype, dev) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             device=dev, dtype=torch.int32)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def reduce_kernel_phase(dev, plan, dtype, width, record: dict | None) -> None:
    """K4–K5 vs plain on the card at the reduce_scatterv ``plan``'s shapes
    (slab rows = its largest payload); fills ``record`` when given."""
    from repro_torch.kernels.ragged_gather import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    buf_rows = plan.buf_rows
    payloads = [s[1] for s in plan.steps]
    rows = max(payloads)
    k = max(range(len(payloads) - 1),
            key=lambda i: payloads[i] + payloads[i + 1])
    rows_in, rows_out = payloads[k], payloads[k + 1]
    row_bytes = width * torch.tensor([], dtype=dtype).element_size()
    buf = _rand(g, (P, buf_rows, width), dtype, dev)
    slab = _rand(g, (P, rows, width), dtype, dev)
    rng = np.random.default_rng(SEED + 1)
    start = rng.integers(-buf_rows, buf_rows + rows, size=P).astype(np.int32)
    start[:3] = (-3, buf_rows + 7, -2 * buf_rows)
    valid = np.where(rng.random(P) < 0.25, 0, rows).astype(np.int32)
    valid[3:6] = (rows, rows // 2, rows + 5)
    # send windows: over the merge window (ss == rs), partly above it,
    # partly below it (ss < rs), and elsewhere, in turn over the ranks
    shift = np.array([0, rows_in // 2, -(rows_out // 2), 3 * rows_in],
                     np.int64)
    send = np.clip(start + np.resize(shift, P), -2**31, 2**31 - 1
                   ).astype(np.int32)
    st, va, se = (torch.from_numpy(x).to(dev) for x in (start, valid, send))
    got = slab[:, :rows_in].contiguous()

    errs = {"slab_merge_add": bitwise_err(
        ops.slab_merge_add(buf.clone(), slab, st, va),
        ref.slab_merge_add_ref(buf.clone(), slab, st, va))}
    kb, ko = ops.slab_step_reduce(buf.clone(), got, st, va, se, rows_out)
    pb, po = ref.slab_step_reduce_ref(buf.clone(), got, st, va, se, rows_out)
    errs["slab_step_reduce"] = max(bitwise_err(kb, pb), bitwise_err(ko, po))
    del kb, ko, pb, po
    for name, e in errs.items():
        if e != 0.0:
            raise AssertionError(f"{name} ({dtype}, F={width}) differs from "
                                 f"its plain version: max abs err {e}")

    # each input read once, each output written once, from this run's
    # tables: K4 reads nv buf rows and nv slab rows and writes nv rows;
    # K5 adds rows_out written and rows_out - overlap read from buf
    nv = np.clip(valid, 0, rows).astype(np.int64)
    nv_in = np.clip(valid, 0, rows_in).astype(np.int64)
    rs = placed(start, buf_rows, rows_in)
    ss = placed(send, buf_rows, rows_out)
    overlap = np.clip(np.minimum(ss + rows_out, rs + nv_in)
                      - np.maximum(ss, rs), 0, None)
    nbytes = {
        "slab_merge_add": 3 * int(nv.sum()) * row_bytes,
        "slab_step_reduce": int((3 * nv_in + 2 * rows_out - overlap).sum())
        * row_bytes,
    }
    nadds = {"slab_merge_add": int(nv.sum()) * width,
             "slab_step_reduce": int(nv_in.sum()) * width}

    # timing on a working copy (repeated folds only change the values);
    # the library call for K4 is one index_add_ of the valid slab rows
    # into the flattened buffer, index and rows prepared outside
    work = buf.clone()
    flat = work.view(-1, width)
    rowidx = torch.cat([
        r * buf_rows + int(placed(start[r: r + 1], buf_rows, rows)[0])
        + torch.arange(int(nv[r]), device=dev) for r in range(P)])
    src = torch.cat([slab[r, : int(nv[r])] for r in range(P)])
    fns = {
        "slab_merge_add": (lambda: ops.slab_merge_add(work, slab, st, va),
                           lambda: ref.slab_merge_add_ref(work, slab, st, va),
                           lambda: flat.index_add_(0, rowidx, src)),
        "slab_step_reduce": (
            lambda: ops.slab_step_reduce(work, got, st, va, se, rows_out),
            lambda: ref.slab_step_reduce_ref(work, got, st, va, se, rows_out),
            None),
    }
    for name, (kfn, pfn, lfn) in fns.items():
        t = in_turns({"kernel": kfn, "plain": pfn,
                      **({"library": lfn} if lfn else {})}, median_ms,
                     KERNEL_REPS)
        ms, plain_ms = t["kernel"][0], t["plain"][0]
        lib_ms = t["library"][0] if lfn else None
        bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = nadds[name] / ADD_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  {name:16s} {str(dtype):15s} F={width} rows={rows} "
            f"rows_in={rows_in} rows_out={rows_out} buf_rows={buf_rows} "
            f"bytes={nbytes[name]} adds={nadds[name]} kernel_ms={ms:.4f} "
            f"bound_ms={bound_ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"max_abs_err={errs[name]} kernel_range=[{t['kernel'][1]:.4f}, "
            f"{t['kernel'][2]:.4f}]")
        if record is not None:
            record[name] = {"name": name, "route": "cuda",
                            "source": SOURCES[name],
                            "replaces": REPLACES[name], "launches": 0,
                            "max_abs_err": errs[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": ("bytes" if bytes_ms >= ops_ms
                                         else "operations"),
                            "library_ms": lib_ms}
    del buf, slab, work, got, flat, src
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 3

def main_path(dev) -> list[dict]:
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import NAMES, block_sizes

    mesh = rt.LocalMesh(P, device=dev)
    rows = []
    for name in NAMES:
        sizes = block_sizes(name, P, B, seed=SEED)
        rng = np.random.default_rng(SEED)
        blocks = [rng.standard_normal((s, F), dtype=np.float32) for s in sizes]
        want = np.concatenate(blocks)
        for root in ROOTS:
            for segments in SEGMENTS:
                got, plan = rt.run_gatherv(mesh, blocks, root,
                                           segments=segments)
                if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
                    raise AssertionError(f"gatherv {name} root={root} "
                                         f"S={segments} differs from the oracle")
                outs, _ = rt.run_scatterv(mesh, want, sizes, root,
                                          segments=segments)
                for r, (o, b) in enumerate(zip(outs, blocks)):
                    if not np.array_equal(o.view(np.uint32), b.view(np.uint32)):
                        raise AssertionError(f"scatterv {name} root={root} "
                                             f"S={segments} rank {r} differs")
                tables = plan_tensors(plan, dev)
                x = torch.zeros((P, plan.cap, F), device=dev)
                for r, b in enumerate(blocks):
                    x[r, : len(b)] = torch.from_numpy(b).to(dev)
                g_ms = median_ms(lambda: rt.gatherv_shard(x, plan, mesh, tables),
                                 PATH_REPS)
                del x
                buf_root = torch.zeros((P, plan.buf_rows, F), device=dev)
                buf_root[root, : plan.total] = torch.from_numpy(want).to(dev)
                s_ms = median_ms(
                    lambda: rt.scatterv_shard(buf_root, plan, mesh, tables),
                    PATH_REPS)
                del buf_root
                moved = plan.tree_bytes_exact * F * 4
                row = {"dist": name, "root": root, "segments": segments,
                       "steps": len(plan.steps), "buf_rows": plan.buf_rows,
                       "total_rows": plan.total,
                       "tree_bytes_exact": moved, "gatherv_ms": g_ms,
                       "scatterv_ms": s_ms,
                       "gatherv_GBps": moved / g_ms / 1e6,
                       "scatterv_GBps": moved / s_ms / 1e6}
                rows.append(row)
                log(f"  {name:11s} root={root:2d} S={segments} "
                    f"steps={row['steps']:2d} buf_rows={plan.buf_rows:6d} "
                    f"gatherv_ms={g_ms:.3f} scatterv_ms={s_ms:.3f} "
                    f"GB/s={row['gatherv_GBps']:.1f}/{row['scatterv_GBps']:.1f}")
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 4

def _profiled(label: str, fns: dict, reps: int = 3) -> dict:
    """Launches per call of each thunk in ``fns``, then device time by
    kernel from ``torch.profiler`` over ``reps`` rounds of all of them,
    beside the window's wall time (idle share)."""
    from repro_torch.kernels.ragged_gather import ops
    from torch.profiler import ProfilerActivity, profile

    per_call = {}
    for op, fn in fns.items():
        ops.reset_launches()
        fn()
        per_call[op] = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            # names cut to 90 characters can collide (two instantiations
            # of one template): add them up, never overwrite
            ms, n = by_kernel.get(e.key[:90], (0.0, 0))
            by_kernel[e.key[:90]] = (ms + us / 1e3 / reps,
                                     n + e.count // reps)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    log(f"  {label} launches per call {per_call}")
    if not by_kernel:
        log("  profiler recorded no device time: breakdown not measured")
    for key, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:8.3f} ms  x{n:3d}  {key}")
    log(f"  busy {busy_ms:.3f} ms of {wall_ms / reps:.3f} ms wall per round "
        f"of {'+'.join(fns)} under the profiler")
    return {"case": label, "launches_per_call": per_call,
            "device_ms_per_round": {k: v[0] for k, v in by_kernel.items()},
            "busy_ms_per_round": busy_ms,
            "wall_ms_per_round_under_profiler": wall_ms / reps,
            "idle_share_under_profiler":
                (1 - busy_ms / (wall_ms / reps)) if by_kernel else None}


def profile_phase(dev, name: str, root: int, segments: int) -> dict:
    """Where the time goes in one gatherv + scatterv of the gatherv path."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import block_sizes

    mesh = rt.LocalMesh(P, device=dev)
    plan = rt.plan_gatherv(block_sizes(name, P, B, seed=SEED), root,
                           segments=segments)
    tables = plan_tensors(plan, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((P, plan.cap, F), generator=g, device=dev)
    buf_root = torch.randn((P, plan.buf_rows, F), generator=g, device=dev)
    out = _profiled(
        f"gatherv+scatterv {name}/root={root}/S={segments} "
        f"steps={len(plan.steps)}",
        {"gatherv": lambda: rt.gatherv_shard(x, plan, mesh, tables),
         "scatterv": lambda: rt.scatterv_shard(buf_root, plan, mesh, tables)})
    k1 = sum(ms for k, ms in out["device_ms_per_round"].items()
             if "slab_extract_kernel" in k)
    out["k1_share_of_busy"] = k1 / out["busy_ms_per_round"] if k1 else None
    log(f"  K1 {k1:.3f} ms of {out['busy_ms_per_round']:.3f} ms busy")
    del x, buf_root
    torch.cuda.empty_cache()
    return out


def profile_reduce_phase(dev, name: str, segments: int) -> dict:
    """Where the time goes in one reduce_scatterv."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import block_sizes

    mesh = rt.LocalMesh(P, device=dev)
    plan = rt.plan_reduce_scatterv(block_sizes(name, P, B, seed=SEED),
                                   segments=segments)
    tables = plan_tensors(plan, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((P, plan.in_rows, F), generator=g, device=dev)
    out = _profiled(
        f"reduce_scatterv {name}/S={segments} steps={len(plan.steps)}",
        {"reduce_scatterv":
            lambda: rt.reduce_scatterv_shard(x, plan, mesh, tables)})
    # LocalMesh's exchange: PyTorch's index_select and index_copy_ kernels
    ex = sum(ms for k, ms in out["device_ms_per_round"].items()
             if "index" in k.lower())
    out["exchange_share_of_busy"] = (ex / out["busy_ms_per_round"]
                                     if out["busy_ms_per_round"] else None)
    log(f"  the exchange (index kernels) {ex:.3f} ms of "
        f"{out['busy_ms_per_round']:.3f} ms busy")
    del x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 5

def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _check_blocks(what: str, got, want) -> None:
    for r, (a, b) in enumerate(zip(got, want)):
        if not _same_bits(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"{what}: rank {r} differs")


def reduce_composed_path(dev) -> list[dict]:
    """reduce_scatterv, allreducev, allgatherv and alltoallv on
    ``LocalMesh(16)`` over the six distributions and segments {1, 4}."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.core.pipeline import (execute_allreducev_plan_numpy,
                                           execute_reduce_scatterv_plan_numpy)

    mesh = rt.LocalMesh(P, device=dev)
    rows = []
    for k, name in enumerate(NAMES):
        sizes = block_sizes(name, P, B, seed=SEED)
        total = sum(sizes)
        g = torch.Generator(device=dev).manual_seed(SEED + 10 + k)
        x_rs = torch.randn((P, total, F), generator=g, device=dev)
        host = x_rs.cpu().numpy()
        contribs = list(host)                           # (total, F) each
        narrow = [np.ascontiguousarray(c[:, :ORACLE_F]) for c in contribs]
        blocks = [contribs[r][: sizes[r]] for r in range(P)]
        S = [block_sizes(name, P, A2A_B, seed=i) for i in range(P)]
        matrix = [np.split(contribs[i][: sum(S[i])], np.cumsum(S[i])[:-1])
                  for i in range(P)]
        first = {}
        for segments in SEGMENTS:
            case = f"{name} S={segments}"
            # 1. through the kernels, bitwise against the plain versions
            rs, rs_plan = rt.run_reduce_scatterv(mesh, contribs, sizes,
                                                 segments=segments)
            ar, ar_plan = rt.run_allreducev(mesh, contribs, sizes,
                                            segments=segments)
            rt.use_kernel_dataplane(False)
            try:
                rs_plain, _ = rt.run_reduce_scatterv(mesh, contribs, sizes,
                                                     segments=segments)
                _check_blocks(f"reduce_scatterv {case} vs plain", rs,
                              rs_plain)
                del rs_plain
                ar_plain, _ = rt.run_allreducev(mesh, contribs, sizes,
                                                segments=segments)
                _check_blocks(f"allreducev {case} vs plain", ar, ar_plain)
                del ar_plain
            finally:
                rt.use_kernel_dataplane(None)
            # 3. pipelining keeps the fold order: S=4 equals S=1 bitwise
            if first:
                _check_blocks(f"reduce_scatterv {case} vs S=1", rs,
                              first["rs"])
                _check_blocks(f"allreducev {case} vs S=1", ar, first["ar"])
            else:
                first = {"rs": rs, "ar": ar}
            # 2. the same plans at F=16, bitwise against the NumPy oracles
            got, plan = rt.run_reduce_scatterv(mesh, narrow, sizes,
                                               segments=segments)
            _check_blocks(f"reduce_scatterv {case} F={ORACLE_F} vs NumPy",
                          got, execute_reduce_scatterv_plan_numpy(plan,
                                                                  narrow))
            got, plan = rt.run_allreducev(mesh, narrow, sizes,
                                          segments=segments)
            _check_blocks(f"allreducev {case} F={ORACLE_F} vs NumPy", got,
                          execute_allreducev_plan_numpy(plan, narrow))
            # 4. allgatherv (root chosen by the algorithm) and alltoallv
            ag, ag_plan = rt.run_allgatherv(mesh, blocks, segments=segments)
            want = np.concatenate(blocks)
            _check_blocks(f"allgatherv {case}", ag, [want] * P)
            del ag
            a2a, a2a_plan = rt.run_alltoallv(mesh, matrix, segments=segments)
            _check_blocks(f"alltoallv {case}", a2a,
                          [np.concatenate([matrix[i][j] for i in range(P)])
                           for j in range(P)])

            # device time of each *_shard on device tensors
            x_ag = torch.zeros((P, ag_plan.cap, F), device=dev)
            x_a2a = torch.zeros((P, a2a_plan.cap, F), device=dev)
            for r in range(P):
                x_ag[r, : sizes[r]] = x_rs[r, : sizes[r]]
                x_a2a[r, : sum(S[r])] = x_rs[r, : sum(S[r])]
            shards = (
                ("reduce_scatterv", rs_plan, rt.reduce_scatterv_shard, x_rs),
                ("allreducev", ar_plan, rt.allreducev_shard, x_rs),
                ("allgatherv", ag_plan, rt.allgatherv_shard, x_ag),
                ("alltoallv", a2a_plan, rt.alltoallv_shard, x_a2a))
            for op, plan, shard, x in shards:
                tables = plan_tensors(plan, dev)
                ms = median_ms(lambda: shard(x, plan, mesh, tables),
                               PATH_REPS)
                moved = plan.tree_bytes_exact * F * 4
                row = {"op": op, "dist": name, "segments": segments,
                       "steps": len(plan.steps), "buf_rows": plan.buf_rows,
                       "tree_bytes_exact": moved, "ms": ms,
                       "GBps": moved / ms / 1e6}
                rows.append(row)
                log(f"  {op:15s} {name:11s} S={segments} "
                    f"steps={row['steps']:3d} buf_rows={plan.buf_rows:6d} "
                    f"bytes={moved} ms={ms:.3f} GB/s={row['GBps']:.1f}")
            del x_ag, x_a2a, rs, ar, a2a
            torch.cuda.empty_cache()
        del x_rs, host, contribs, narrow, blocks, matrix, first
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 6

def moe_setup(dev):
    """The MoE layer of ``MOE_ARCH`` at its published widths with random
    weights from the seed, a random batch, and the layer's routing tables
    for it (the same ``route`` call on the same logits as inside)."""
    import repro_torch as rt
    from repro_torch.models import capacity_for, route

    cfg = rt.get_config(MOE_ARCH)
    layer = rt.MoE(cfg.d_model, cfg.moe, dtype=MOE_DTYPE, device=dev,
                   seed=SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    x = torch.randn((MOE_B, MOE_S, cfg.d_model), generator=g,
                    device=dev).to(MOE_DTYPE)
    T = MOE_B * MOE_S
    C = capacity_for(cfg.moe, T)
    logits = torch.matmul(x.reshape(1, T, -1).float(), layer.router)
    return cfg, layer, x, route(logits, cfg.moe.top_k, C)


def _pack_case(label: str, kfn, pfn, lfn, nbytes: int) -> dict:
    """One K6/K7 case: bitwise against the plain version, then timed
    (``cold_ms``, kernel, plain and library in turns) beside its bound
    (bytes over the HBM rate) and the library call."""
    err = bitwise_err(kfn(), pfn())
    if err != 0.0:
        raise AssertionError(f"{label} differs from its plain version: "
                             f"max abs err {err}")
    t = in_turns({"kernel": kfn, "plain": pfn, "library": lfn}, cold_ms,
                 KERNEL_REPS)
    (ms, lo, hi), plain_ms, (lib_ms, lib_lo, lib_hi) = (
        t["kernel"], t["plain"][0], t["library"])
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {label:38s} bytes={nbytes} kernel_ms={ms:.4f} "
        f"[{lo:.4f}, {hi:.4f}] bound_ms={bound_ms:.4f} "
        f"({100 * bound_ms / ms:.1f} % of it) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} [{lib_lo:.4f}, {lib_hi:.4f}] "
        f"kernel/library={ms / lib_ms:.3f} max_abs_err={err}")
    return {"case": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "bytes": nbytes, "ms_range": [lo, hi],
            "library_ms_range": [lib_lo, lib_hi]}


def gather_case(label: str, x: torch.Tensor, idx: torch.Tensor) -> dict:
    """K6 on ``x`` by ``idx``; the library call is ``index_select`` with
    the clipped index prepared outside the timing.  Bytes: each distinct
    source row that this ``idx`` reads, read once; each output row
    written once; the index."""
    from repro_torch.kernels.ragged_gather import ops, ref

    safe = idx.long().clamp(0, x.shape[0] - 1)
    row = x.shape[1] * x.element_size()
    distinct = int(torch.unique(safe).numel())
    return _pack_case(label, lambda: ops.ragged_gather(x, idx),
                      lambda: ref.ragged_gather_ref(x, idx),
                      lambda: torch.index_select(x, 0, safe),
                      (distinct + idx.numel()) * row + 4 * idx.numel())


def scatter_case(label: str, x: torch.Tensor, idx: torch.Tensor,
                 n_out: int) -> dict:
    """K7 of ``x`` to ``idx`` over ``n_out`` zero rows; the library call
    is ``index_copy_`` into a zeroed buffer with a trash row (out-of-range
    destinations mapped there outside the timing).  Bytes: the output
    written once, the in-range rows read once, the index."""
    from repro_torch.kernels.ragged_gather import ops, ref

    keep = (idx >= 0) & (idx < n_out)
    safe = torch.where(keep, idx.long(), n_out)
    row = x.shape[1] * x.element_size()
    nbytes = (n_out + int(keep.sum())) * row + 4 * idx.numel()
    return _pack_case(
        label, lambda: ops.ragged_scatter(x, idx, n_out),
        lambda: ref.ragged_scatter_ref(x, idx, n_out),
        lambda: torch.zeros((n_out + 1, x.shape[1]), dtype=x.dtype,
                            device=x.device).index_copy_(0, safe, x),
        nbytes)


def pack_kernel_phase(dev, x: torch.Tensor, r, record: dict) -> list[dict]:
    """Phase 6a: K6 at the layer's dispatch gather (``xz`` by ``disp``) and
    combine gather (``ye`` by the pairs' slots), K7 at ``unpack_blocks``'
    shape, in the layer's bf16 at D and in fp32 at F=1024 and F=7."""
    from repro_torch.kernels.ragged_gather import ref

    T, D = x.shape[0] * x.shape[1], x.shape[2]
    E, C = r.disp.shape[1:]
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    disp = r.disp.reshape(-1).to(torch.int32)
    comb = (r.eid * C + r.pos.clamp(max=C - 1)).reshape(-1).to(torch.int32)
    kept = r.counts[0].clamp(max=C).to(torch.int32)
    total = int(kept.sum())
    unpack = ref.build_pack_index(kept, C, total)
    xz = torch.cat([x.reshape(T, D), x.new_zeros((1, D))])
    ye = torch.randn((E * C, D), generator=g, device=dev).to(x.dtype)
    packed = torch.randn((total, D), generator=g, device=dev).to(x.dtype)
    cases = [gather_case(f"ragged_gather dispatch {x.dtype} D={D}", xz, disp),
             gather_case(f"ragged_gather combine {x.dtype} D={D}", ye, comb),
             scatter_case(f"ragged_scatter unpack {x.dtype} D={D}", packed,
                          unpack, E * C)]
    for name, case in (("ragged_gather", cases[0]),
                       ("ragged_scatter", cases[2])):
        record[name] = {"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": 0,
                        **{k: case[k] for k in ("max_abs_err", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}}
    del ye, packed
    for f in (F, ODD_F):
        src = torch.randn((T + 1, f), generator=g, device=dev)
        cases.append(gather_case(f"ragged_gather dispatch fp32 F={f}", src,
                                 disp))
        rows = torch.randn((total, f), generator=g, device=dev)
        cases.append(scatter_case(f"ragged_scatter unpack fp32 F={f}", rows,
                                  unpack, E * C))
    torch.cuda.empty_cache()
    return cases


def moe_reference_error(layer, x: torch.Tensor, r, n_tokens: int) -> float:
    """Relative Frobenius error of the layer's first ``n_tokens`` outputs
    against an fp32 recomputation from the routing tables ``r``: each kept
    (token, expert) pair adds ``prob × SwiGLU_e(x_t)`` with fp32 weights."""
    import torch.nn.functional as Fn

    out, _ = layer(x)
    D = x.shape[-1]
    got = out.reshape(-1, D)[:n_tokens].float()
    xt = x.reshape(-1, D)[:n_tokens].float()
    sel = r.keep[0] & (r.tid[0] < n_tokens)
    eid, tid, prob = r.eid[0][sel], r.tid[0][sel], r.prob[0][sel]
    want = torch.zeros_like(got)
    for e in range(layer.wi.shape[0]):
        m = eid == e
        t = tid[m]
        xe = xt[t]
        h = Fn.silu(xe @ layer.wi[e].float()) * (xe @ layer.wg[e].float())
        want.index_add_(0, t, (h @ layer.wo[e].float()) * prob[m][:, None])
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def moe_path(dev, layer, x: torch.Tensor, r) -> tuple[dict, dict]:
    """Phase 6b and 6c, the main path: the layer through the kernels, then
    the expert exchange of its dispatch buffers and expert outputs.
    Returns the numbers and the thunks of the layer and the two exchanges
    (for the profile that follows)."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.kernels.ragged_gather import ops
    from repro_torch.models import dispatch, experts

    # (b) the layer, kernels against plain versions, and against fp32;
    # one call launches K6 twice (the dispatch and the combine gather)
    before = dict(ops.LAUNCHES)
    out, aux = layer(x)
    once = {k: n - before[k] for k, n in ops.LAUNCHES.items()}
    if once != {**dict.fromkeys(once, 0), "ragged_gather": 2}:
        raise AssertionError(f"one moe_apply launched {once}, not K6 twice")
    rt.use_kernel_dataplane(False)
    try:
        want, waux = layer(x)
        plain_ms = median_ms(lambda: layer(x), PATH_REPS)
    finally:
        rt.use_kernel_dataplane(None)
    for what, a, b in (("out", out, want), ("load", aux["load"], waux["load"]),
                       ("dropped", aux["dropped"], waux["dropped"])):
        if not torch.equal(a, b):
            raise AssertionError(f"moe_apply {what} through the kernels "
                                 f"differs from the plain versions")
    if not torch.isfinite(out).all() or out.shape != x.shape:
        raise AssertionError("moe_apply gave non-finite values or a shape "
                             f"{tuple(out.shape)} for {tuple(x.shape)}")
    rel = moe_reference_error(layer, x, r, MOE_REF_TOKENS)
    if not rel <= MOE_REF_TOL:
        raise AssertionError(f"moe_apply vs fp32 recomputation of "
                             f"{MOE_REF_TOKENS} tokens: relative error {rel} "
                             f"> {MOE_REF_TOL}")
    moe_ms = median_ms(lambda: layer(x), PATH_REPS)
    del want, out
    load = aux["load"].cpu().numpy()
    E, C = r.disp.shape[1:]
    D = x.shape[-1]
    cfg = layer.cfg
    T = x.shape[0] * x.shape[1]
    flops = 3 * 2 * E * C * D * cfg.d_ff
    log(f"  moe_apply {MOE_ARCH} T={T} E={E} C={C} D={D} d_ff={cfg.d_ff} "
        f"load={load.tolist()} dropped={int(aux['dropped'])} "
        f"ms={moe_ms:.4f} plain_ms={plain_ms:.4f} expert_TFLOP={flops / 1e12:.3f} "
        f"fp32_rel_err={rel:.3e} (limit {MOE_REF_TOL})")

    # (c) the expert exchange: device j owns expert j; expert j's kept rows
    # are split over MOE_P data shards as in examples/moe_irregular.py
    if E != MOE_P:
        raise ValueError(f"the exchange puts one expert on each of "
                         f"{MOE_P} devices, the layer has {E}")
    xe = dispatch(x.reshape(1, T, D), r)[0]                   # (E, C, D)
    ye = experts(layer.params, xe[None])[0]
    kept_h = np.minimum(load, C).astype(np.int64)
    kept = torch.from_numpy(kept_h.astype(np.int32)).to(dev)
    total = int(kept_h.sum())
    S = np.zeros((MOE_P, E), np.int64)
    for j, k in enumerate(kept_h):
        base, rem = divmod(int(k), MOE_P)
        S[:, j] = base
        S[:rem, j] += 1
    mesh = rt.LocalMesh(MOE_P, device=dev)
    a2a = rt.plan_alltoallv(S.tolist())
    a2a_tables = plan_tensors(a2a, dev)
    # rank i sends, for each expert j, its share of j's packed rows; the
    # send rows are one K6 gather from the packed rows and a zero row
    first = np.concatenate([[0], np.cumsum(kept_h)[:-1]])
    share = np.cumsum(S, axis=0) - S                 # start of shard i in j
    send = np.full((MOE_P, a2a.cap), total, np.int64)
    for i in range(MOE_P):
        rows = np.concatenate([first[j] + share[i, j] + np.arange(S[i, j])
                               for j in range(E)])
        send[i, : len(rows)] = rows
    send_idx = torch.from_numpy(send.reshape(-1).astype(np.int32)).to(dev)
    gplan = rt.plan_gatherv(kept_h.tolist(), 0)
    g_tables = plan_tensors(gplan, dev)

    def dispatch_exchange():
        packed = rt.pack_blocks(xe, kept, total)
        src = torch.cat([packed, packed.new_zeros((1, D))])
        x_a2a = ops.ragged_gather(src, send_idx).view(MOE_P, a2a.cap, D)
        recv = rt.alltoallv_shard(x_a2a, a2a, mesh, a2a_tables)
        got = rt.pack_blocks(recv, kept, total)
        return packed, got, rt.unpack_blocks(got, kept, C)

    def combine_exchange():
        packed = rt.pack_blocks(ye, kept, total)
        blocks = rt.unpack_blocks(packed, kept, gplan.cap)
        buf = rt.gatherv_shard(blocks, gplan, mesh, g_tables)
        return rt.unpack_blocks(buf[0, :total].contiguous(), kept, C)

    packed, got, back = dispatch_exchange()
    if not torch.equal(got, packed):
        raise AssertionError("alltoallv did not deliver each expert's rows "
                             "to its device in order")
    if not torch.equal(back, xe):
        raise AssertionError("pack -> alltoallv -> unpack differs from the "
                             "dispatch buffers")
    back = combine_exchange()
    live = torch.arange(C, device=dev)[None, :] < kept[:, None]
    if not torch.equal(back[live], ye[live]):
        raise AssertionError("pack -> gatherv -> unpack differs from the "
                             "expert outputs in their kept rows")
    del packed, got, back
    times = {
        "pack_blocks": median_ms(lambda: rt.pack_blocks(xe, kept, total),
                                 PATH_REPS),
        "dispatch_exchange": median_ms(dispatch_exchange, PATH_REPS),
        "combine_exchange": median_ms(combine_exchange, PATH_REPS)}
    packed = rt.pack_blocks(xe, kept, total)
    src = torch.cat([packed, packed.new_zeros((1, D))])
    x_a2a = ops.ragged_gather(src, send_idx).view(MOE_P, a2a.cap, D)
    times["alltoallv_shard"] = median_ms(
        lambda: rt.alltoallv_shard(x_a2a, a2a, mesh, a2a_tables), PATH_REPS)
    blocks = rt.unpack_blocks(packed, kept, gplan.cap)
    times["gatherv_shard"] = median_ms(
        lambda: rt.gatherv_shard(blocks, gplan, mesh, g_tables), PATH_REPS)
    times["unpack_blocks"] = median_ms(
        lambda: rt.unpack_blocks(packed, kept, C), PATH_REPS)
    row_bytes = D * x.element_size()
    log(f"  exchange kept={kept_h.tolist()} rows={total} "
        f"alltoallv steps={len(a2a.steps)} exact_rows={a2a.tree_bytes_exact} "
        f"gatherv steps={len(gplan.steps)} exact_rows={gplan.tree_bytes_exact} "
        + " ".join(f"{k}_ms={v:.4f}" for k, v in times.items()))
    del packed, src, x_a2a, blocks
    torch.cuda.empty_cache()
    fns = {"moe_apply": lambda: layer(x),
           "dispatch_exchange": dispatch_exchange,
           "combine_exchange": combine_exchange}
    return fns, {
        "arch": MOE_ARCH, "tokens": T, "experts": E, "capacity": C,
        "d_model": D, "d_ff": cfg.d_ff, "load": load.tolist(),
        "dropped": int(aux["dropped"]), "moe_ms": moe_ms,
        "moe_plain_ms": plain_ms, "expert_flop": flops, "fp32_rel_err": rel,
        "kept": kept_h.tolist(), "alltoallv_steps": len(a2a.steps),
        "alltoallv_exact_bytes": a2a.tree_bytes_exact * row_bytes,
        "gatherv_steps": len(gplan.steps),
        "gatherv_exact_bytes": gplan.tree_bytes_exact * row_bytes,
        "exchange_ms": times}


# ---------------------------------------------------------------- phase 7

def visible_pairs(t: int, s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that the masks leave visible, per head."""
    i = np.arange(t, dtype=np.int64)
    hi = np.minimum(s, i + 1) if causal else np.full(t, s, np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(t, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _grouped_plain(q, k, v, causal, window):
    """K8's plain version one kv head (and its group of q heads) at a
    time, so that its fp32 T x T scores fit."""
    from repro_torch.kernels.flash_attention import ref

    g = q.shape[1] // k.shape[1]
    return torch.cat([ref.attention_ref(q[:, j * g:(j + 1) * g],
                                        k[:, j:j + 1], v[:, j:j + 1],
                                        causal=causal, window=window)
                      for j in range(k.shape[1])], dim=1)


def flash_case(dev, label, dtype, B, H, Hkv, T, S, hd, causal, window,
               plain_reps: int = 3) -> dict:
    """One K8 case: against its plain version at its dtype's tolerance,
    then timed (``cold_ms``) beside its bound and SDPA."""
    import torch.nn.functional as Fn
    from repro_torch.kernels.flash_attention import ops as fops

    g = torch.Generator(device=dev).manual_seed(SEED + T + hd)
    q = torch.randn((B, H, T, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, hd), generator=g, device=dev).to(dtype)
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    want = _grouped_plain(q, k, v, causal, window)
    tol = FLASH_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not (bool(torch.isfinite(got).all())
            and bool((diff <= tol + tol * want.float().abs()).all())):
        raise AssertionError(f"K8 {label} differs from its plain version: "
                             f"max abs err {err} (tolerance {tol})")
    del got, want, diff
    if window is None:
        mask = None
    else:
        from repro_torch.kernels.flash_attention.ref import visible_mask
        mask = visible_mask(T, S, causal=causal, window=window, device=dev)

    def library():
        return Fn.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    ms = cold_ms(lambda: fops.flash_attention(q, k, v, causal=causal,
                                              window=window), KERNEL_REPS)
    plain_ms = cold_ms(lambda: _grouped_plain(q, k, v, causal, window),
                       plain_reps)
    lib_ms = cold_ms(library, KERNEL_REPS)
    pairs = visible_pairs(T, S, causal, window)
    flops = 4 * hd * pairs * B * H
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    compute_ms = flops / FLOPS_PER_S[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(compute_ms, bytes_ms)
    tflops = flops / ms / 1e9
    log(f"  {label:44s} flop={flops} bytes={nbytes} kernel_ms={ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({100 * bound_ms / ms:.1f} %) "
        f"tflop_s={tflops:.1f} plain_ms={plain_ms:.3f} sdpa_ms={lib_ms:.4f} "
        f"kernel/sdpa={ms / lib_ms:.3f} max_abs_err={err}")
    return {"case": label, "max_abs_err": err, "tolerance": tol, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if compute_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms, "tflop_s": tflops,
            "kernel_over_library": ms / lib_ms, "flop": flops,
            "bytes": nbytes, "visible_pairs_per_head": pairs}


def flash_kernel_phase(dev, record: dict) -> list[dict]:
    """Phase 7a: K8 against its plain version at the serving path's and
    the next slices' shapes; the yi-6b prefill case fills the kernels
    line."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        flash_case(dev, "yi-6b prefill bf16 B4 H32/4 T2048 hd128", bf,
                   4, 32, 4, 2048, 2048, 128, True, None),
        flash_case(dev, "mixtral window bf16 B1 H32/8 T8192 w4096", bf,
                   1, 32, 8, 8192, 8192, 128, True, 4096, plain_reps=2),
        flash_case(dev, "odd bf16 B1 H32/4 T1000 hd128", bf,
                   1, 32, 4, 1000, 1000, 128, True, None),
        flash_case(dev, "non-causal bf16 B1 H32/4 T384 hd128", bf,
                   1, 32, 4, 384, 384, 128, False, None),
        flash_case(dev, "fp32 B2 H4/2 T256 hd64 w128", f32,
                   2, 4, 2, 256, 256, 64, True, 128),
        flash_case(dev, "hd256 bf16 B4 H10/1 T2048 w2048", bf,
                   4, 10, 1, 2048, 2048, 256, True, 2048),
    ]
    main = cases[0]
    record["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": 0,
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}}
    torch.cuda.empty_cache()
    return cases


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def serve_setup(dev, arch: str = SERVE_ARCH,
                prompt: tuple = SERVE_PROMPT) -> dict:
    """``arch``'s config, its random weights on the card (from the seed)
    and the request queue (prompt lengths in ``prompt`` and tokens, from
    the seed)."""
    import repro_torch as rt
    from repro_torch.models.transformer import init_params

    cfg = rt.get_config(arch).with_(dtype=SERVE_DTYPE)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    leaves = [t for _, t in _tensors(params)]
    rng = np.random.default_rng(SEED)
    lens = rng.integers(prompt[0], prompt[1] + 1, SERVE_REQUESTS)
    queue = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    ctx = {"cfg": cfg, "params": params, "queue": queue, "lens": lens,
           "rng": rng, "init_s": init_s,
           "parameters": sum(t.numel() for t in leaves),
           "weight_bytes": sum(t.numel() * t.element_size() for t in leaves)}
    log(f"  {arch}: {ctx['parameters']} parameters, "
        f"{ctx['weight_bytes']} bytes, made in {init_s:.2f} s; prompt "
        f"lengths {lens.tolist()}")
    return ctx


def serve_main(dev, ctx: dict) -> dict:
    """Phase 7b's and 8b's main path: the requests served through
    ``serve_requests`` as a user calls it."""
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve_requests

    cfg = ctx["cfg"]
    torch.cuda.reset_peak_memory_stats(dev)
    res = serve_requests(ctx["params"], cfg, ctx["queue"], SERVE_BATCH,
                         SERVE_GEN, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    for toks in res["tokens"]:
        if toks.shape != (SERVE_GEN + 1,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"served tokens out of range: {toks}")
    ctx["tokens"] = res["tokens"]
    n_batches = len(res["prefill_s"])
    prefill_ms = [1e3 * x for x in res["prefill_s"]]
    decode_ms = 1e3 * sum(res["decode_s"]) / (n_batches * SERVE_GEN)
    out = {"arch": cfg.name, "dtype": SERVE_DTYPE, "layers": cfg.n_layers,
           "parameters": ctx["parameters"],
           "weight_bytes": ctx["weight_bytes"], "init_s": ctx["init_s"],
           "prompt_lens": ctx["lens"].tolist(), "batch": SERVE_BATCH,
           "gen": SERVE_GEN, "prefill_ms": prefill_ms,
           "decode_ms_per_step": decode_ms,
           "tokens_per_s": res["tokens_out"] / res["wall_s"],
           "decode_tokens_per_s": res["tokens_out"] / sum(res["decode_s"]),
           "wall_s": res["wall_s"], "peak_bytes": peak,
           "k8_launches": backend.LAUNCHES["flash_attention"],
           "k9_launches": backend.LAUNCHES["rglru_scan"]}
    log(f"  served {len(res['tokens'])} requests in {n_batches} batches: "
        f"prefill ms {prefill_ms}, decode ms/step {decode_ms:.3f}, "
        f"{out['tokens_per_s']:.1f} tokens/s over {res['wall_s']:.2f} s "
        f"({out['decode_tokens_per_s']:.1f} in decode), peak {peak} bytes")
    return out


def first_batch(queue: list, dev) -> torch.Tensor:
    """The first ``SERVE_BATCH`` prompts, left-padded as
    ``serve_requests`` pads them, on the card."""
    plen = max(len(p) for p in queue[:SERVE_BATCH])
    toks = np.zeros((SERVE_BATCH, plen), np.int32)
    for i, p in enumerate(queue[:SERVE_BATCH]):
        toks[i, plen - len(p):] = p
    return torch.from_numpy(toks).to(dev)


def _token_kw(c, params, toks, name: str, embeds=None) -> dict:
    """A model's input for ``toks``: the tokens as ``name``, or (a config
    fed embeddings) the embedding rows in the config's dtype, or
    ``embeds`` when given."""
    if embeds is not None:
        return {"embeds": embeds}
    if c.embed_inputs:
        return {name: toks}
    return {"embeds": params["embed"]["e"][toks].to(getattr(torch, c.dtype))}


def _floor(fwd, emb: torch.Tensor, rng) -> dict:
    """The bf16 noise floor of phase 8: the relative move of the last
    logits of ``fwd(embeds)`` when 1, 10 and 1000 elements of ``emb`` move
    by one bf16 ulp."""
    base = fwd(emb)[:, -1]
    floor = {}
    for n in RG_FLOOR_ELEMENTS:
        moved = emb.clone()
        idx = torch.from_numpy(rng.choice(moved.numel(), n, replace=False))
        moved.view(torch.int16).view(-1)[idx.to(emb.device)] += 1
        floor[n] = _rel(fwd(moved)[:, -1], base)
        del moved
    return floor


def serve_checks(dev, ctx: dict) -> tuple[dict, dict]:
    """Phase 7b's checks: one prefill of the first batch launches K8 once
    a layer and a decode step never, with finite logits; the prefill's
    last logits against the plain versions; prefill + decode against
    ``forward``.  Returns the thunks of a prefill and a decode step (for
    the profile) and the numbers."""
    import repro_torch as rt
    from repro_torch.kernels import backend
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_cache)

    cfg, params, queue, rng = (ctx["cfg"], ctx["params"], ctx["queue"],
                               ctx["rng"])
    # the same weights with fp32 activations and cache: the residual stream
    # starts from the embedding rows in fp32, so every product and K8 run
    # in fp32, and the checks of the mechanism sit far above rounding noise
    cfg32 = cfg.with_(dtype="float32", embed_inputs=False)

    def fwd(c, toks, cache=None):
        return forward(params, c, cache=cache,
                       logits_last_only=cache is not None,
                       **_token_kw(c, params, toks, "tokens"))

    def dec(c, cache, tok):
        return decode_step(params, c, cache,
                           **_token_kw(c, params, tok, "token"))

    toks = first_batch(queue, dev)
    plen = toks.shape[1]

    def prefill(c=cfg):
        logits, _, cache = fwd(c, toks, init_cache(c, SERVE_BATCH,
                                                   plen + SERVE_GEN, dev))
        return logits, cache

    # one prefill launches K8 once a layer, a decode step never; finite
    backend.reset_launches()
    logits, cache = prefill()
    once = backend.LAUNCHES["flash_attention"]
    cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    backend.reset_launches()
    dlogits, cache = dec(cfg, cache, cur)
    torch.cuda.synchronize(dev)
    in_decode = backend.LAUNCHES["flash_attention"]
    if once != cfg.n_layers or in_decode != 0:
        raise AssertionError(f"a prefill launched K8 {once} times (want "
                             f"{cfg.n_layers}), a decode step {in_decode} "
                             f"(want 0)")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(dlogits).all())):
        raise AssertionError("non-finite logits in prefill or decode")

    # the prefill through K8 against the plain versions, and prefill +
    # decode against forward over the same tokens, in both views
    seq = torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, CONSIST_T + CONSIST_STEPS)).astype(
            np.int32)).to(dev)
    errs = {}
    for label, c in (("bf16", cfg), ("fp32", cfg32)):
        k8 = logits if c is cfg else prefill(c)[0]
        rt.use_kernel_dataplane(False)
        try:
            plain = prefill(c)[0]
        finally:
            rt.use_kernel_dataplane(None)
        errs[f"prefill_vs_plain_{label}"] = _rel(k8[:, -1], plain[:, -1])
        del k8, plain
        full, _ = fwd(c, seq)
        first, _, c1 = fwd(c, seq[:, :CONSIST_T], init_cache(
            c, 1, CONSIST_T + CONSIST_STEPS, dev))
        outs = [first]
        for i in range(CONSIST_STEPS):
            out, c1 = dec(c, c1, seq[:, CONSIST_T + i:CONSIST_T + i + 1])
            outs.append(out)
        errs[f"prefill_decode_vs_forward_{label}"] = _rel(
            torch.cat(outs, 1),
            full[:, CONSIST_T - 1:CONSIST_T + CONSIST_STEPS])
        del full, c1, outs
    log(f"  checks: one prefill launches K8 {once} times, a decode step "
        f"{in_decode}; relative errors {errs} (limits: fp32 view "
        f"{MECH_TOL}, bf16 {SERVE_TOL})")
    for name, err in errs.items():
        limit = MECH_TOL if name.endswith("fp32") else SERVE_TOL
        if not err <= limit:
            raise AssertionError(f"{name}: relative error {err} > {limit}")

    fns = {"prefill": prefill, "decode_step": lambda: dec(cfg, cache, cur)}
    return fns, {"k8_per_prefill": once, "k8_per_decode_step": in_decode,
                 **errs}


# ---------------------------------------------------------------- phase 8

def rglru_case(dev, label, B, T, D, random_h0, plain_reps: int = 3) -> dict:
    """One K9 case: against its plain version at 1e-5, then timed
    (``cold_ms``) beside its bound, with the path its shape takes (the
    single pass or the two-pass scan).  No single PyTorch call computes
    this recurrence, so there is no library time."""
    from repro_torch.kernels.rg_lru import kernel as rkernel
    from repro_torch.kernels.rg_lru import ops as rops
    from repro_torch.kernels.rg_lru import ref as rref

    g = torch.Generator(device=dev).manual_seed(SEED + B * T + D)
    a = torch.rand((B, T, D), generator=g, device=dev)
    b = torch.randn((B, T, D), generator=g, device=dev)
    h0 = (torch.randn((B, D), generator=g, device=dev) if random_h0
          else torch.zeros((B, D), device=dev))
    path = "single pass" if rkernel.single_pass(a, b, h0) else "two pass"
    got = rops.rglru_scan(a, b, h0)
    want = rref.rglru_scan_ref(a, b, h0)
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    if not all(torch.allclose(x, y, rtol=RGLRU_TOL, atol=RGLRU_TOL)
               for x, y in zip(got, want)):
        raise AssertionError(f"K9 {label} differs from its plain version: "
                             f"max abs err {err} (tolerance {RGLRU_TOL})")
    del got, want
    ms = cold_ms(lambda: rops.rglru_scan(a, b, h0), KERNEL_REPS)
    plain_ms = cold_ms(lambda: rref.rglru_scan_ref(a, b, h0), plain_reps)
    # read a, b and h0 once, write h and h_last once; one multiply-add an
    # element in fp32
    nbytes = 4 * (3 * B * T * D + 2 * B * D)
    flops = 2 * B * T * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    compute_ms = flops / FLOPS_PER_S[torch.float32] * 1e3
    bound_ms = max(bytes_ms, compute_ms)
    log(f"  {label:44s} path={path} bytes={nbytes} kernel_ms={ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({100 * bound_ms / ms:.1f} % of the "
        f"bound) plain_ms={plain_ms:.3f} max_abs_err={err}")
    return {"case": label, "path": path, "max_abs_err": err,
            "tolerance": RGLRU_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= compute_ms else "operations",
            "library_ms": None, "bytes": nbytes, "flop": flops}


def rglru_kernel_phase(dev, ctx: dict, record: dict) -> list[dict]:
    """Phase 8a: K9 against its plain version at the prefill's shape (the
    first batch's padded length) with h0 = 0 and a random h0, at an odd
    shape and at T = 1; the first case fills the kernels line."""
    T = int(max(ctx["lens"][:SERVE_BATCH]))
    D = ctx["cfg"].d_model
    cases = [
        rglru_case(dev, f"prefill B{SERVE_BATCH} T{T} D{D} h0=0",
                   SERVE_BATCH, T, D, False),
        rglru_case(dev, f"prefill B{SERVE_BATCH} T{T} D{D} random h0",
                   SERVE_BATCH, T, D, True),
        rglru_case(dev, "odd B3 T1000 D2558 random h0", 3, 1000, 2558, True),
        rglru_case(dev, f"T=1 B{SERVE_BATCH} D{D} random h0", SERVE_BATCH, 1,
                   D, True),
    ]
    main = cases[0]
    record["rglru_scan"] = {
        "name": "rglru_scan", "route": "cuda",
        "source": SOURCES["rglru_scan"],
        "replaces": REPLACES["rglru_scan"], "launches": 0,
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}}
    torch.cuda.empty_cache()
    return cases


def rg_checks(dev, ctx: dict) -> tuple[dict, dict]:
    """Phase 8c: launches and finite logits; the fp32 view at full depth;
    bf16 block by block; bf16 at full depth against a noise floor measured
    here; a planted fault that both must catch.  Returns the thunks of a
    prefill and a decode step (for the profile) and the numbers; raises,
    after logging them, if any check failed."""
    import repro_torch as rt
    from repro_torch.kernels import backend
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import embed, rmsnorm, unembed

    cfg, params, queue, rng = (ctx["cfg"], ctx["params"], ctx["queue"],
                               ctx["rng"])
    # fp32 activations and caches on the same weights (as phase 7), and
    # bf16 fed from embeddings (for the floor's moved inputs)
    cfg32 = cfg.with_(dtype="float32", embed_inputs=False)
    cfg_e = cfg.with_(embed_inputs=False)

    def plain(fn):
        rt.use_kernel_dataplane(False)
        try:
            return fn()
        finally:
            rt.use_kernel_dataplane(None)

    toks = first_batch(queue, dev)
    plen = toks.shape[1]
    cache_len = plen + SERVE_GEN

    def prefill(c=cfg, embeds=None):
        logits, _, cache = tf.forward(
            params, c, cache=tf.init_cache(c, SERVE_BATCH, cache_len, dev),
            logits_last_only=True,
            **_token_kw(c, params, toks, "tokens", embeds))
        return logits, cache

    def dec(c, cache, tok):
        return tf.decode_step(params, c, cache,
                              **_token_kw(c, params, tok, "token"))

    def consist(c, seq):
        """Prefill of RG_CONSIST_T tokens then decode steps against
        ``forward`` over the same tokens (batch 1; the ring wraps)."""
        T = RG_CONSIST_T
        full = tf.forward(params, c,
                          **_token_kw(c, params, seq, "tokens"))[0]
        want = full[:, T - 1:T + CONSIST_STEPS].clone()
        del full
        first, _, c1 = tf.forward(
            params, c, cache=tf.init_cache(c, 1, T + CONSIST_STEPS, dev),
            logits_last_only=True,
            **_token_kw(c, params, seq[:, :T], "tokens"))
        outs = [first]
        for i in range(CONSIST_STEPS):
            out, c1 = dec(c, c1, seq[:, T + i:T + i + 1])
            outs.append(out)
        return _rel(torch.cat(outs, 1), want)

    # 1. launches a prefill and a decode step; finite logits
    n_rec = sum(k == "rglru" for _, _, k, _ in tf._blocks(cfg))
    n_local = sum(k == "local" for _, _, k, _ in tf._blocks(cfg))
    backend.reset_launches()
    logits, cache = prefill()
    once = {k: backend.LAUNCHES[k] for k in ("rglru_scan", "flash_attention")}
    cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    backend.reset_launches()
    dlogits, cache = dec(cfg, cache, cur)
    torch.cuda.synchronize(dev)
    in_decode = {k: backend.LAUNCHES[k]
                 for k in ("rglru_scan", "flash_attention")}
    if once != {"rglru_scan": n_rec, "flash_attention": n_local} or any(
            in_decode.values()):
        raise AssertionError(f"a prefill launched {once} (want K9 {n_rec}, "
                             f"K8 {n_local} times), a decode step "
                             f"{in_decode} (want none)")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(dlogits).all())):
        raise AssertionError("non-finite logits in prefill or decode")

    # 2. the fp32 view at full depth
    seq = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, RG_CONSIST_T + CONSIST_STEPS)).astype(
            np.int32)).to(dev)
    errs = {}
    k32 = prefill(cfg32)[0]
    p32 = plain(lambda: prefill(cfg32)[0])
    errs["prefill_vs_plain_fp32"] = _rel(k32[:, -1], p32[:, -1])
    del k32, p32
    errs["prefill_decode_vs_forward_fp32"] = consist(cfg32, seq)

    # 3. bf16 block by block, each fed the plain path's hidden state
    blocks = list(tf._blocks(cfg))

    def run_block(i, x, bcfg=None):
        group, index, kind, bc = blocks[i]
        bc = bcfg or bc
        c = tf._block_cache(kind, bc, SERVE_BATCH, cache_len, dev)
        return tf._apply_block(tf._get(params, group, index), kind, bc, x,
                               cache=c, mode="prefill")[0]

    def last_logits(x):
        return unembed(params["embed"], rmsnorm(params["final_norm"],
                                                x[:, -1:]))

    def plain_pass():
        for i in range(len(blocks)):
            hidden.append(run_block(i, hidden[i]))

    hidden = [embed(params["embed"], toks)]
    plain(plain_pass)
    plain_last = last_logits(hidden[-1])
    backend.reset_launches()
    per_block = [_rel(run_block(i, hidden[i]), hidden[i + 1])
                 for i in range(len(blocks))]
    block_launches = {k: backend.LAUNCHES[k]
                      for k in ("rglru_scan", "flash_attention")}
    if block_launches != once:
        raise AssertionError(f"the per-block pass launched {block_launches}, "
                             f"a prefill {once}")
    fault = next(i for i, b in enumerate(blocks) if b[2] == "local")
    fault_cfg = blocks[fault][3].with_(local_window=RG_FAULT_WINDOW)
    fault_block = _rel(run_block(fault, hidden[fault], fault_cfg),
                       hidden[fault + 1])

    # 4. bf16 at full depth, against the floor of one-ulp input moves
    errs["prefill_vs_plain_bf16"] = _rel(logits[:, -1], plain_last[:, -1])
    errs["prefill_decode_vs_forward_bf16"] = consist(cfg, seq)
    floor = _floor(lambda e: prefill(cfg_e, e)[0], hidden[0], rng)
    gate = max(SERVE_TOL, 2 * max(floor.values()))

    # 5. the planted fault at full depth
    x = hidden[0]
    for i in range(len(blocks)):
        x = run_block(i, x, fault_cfg if i == fault else None)
    fault_full = _rel(last_logits(x)[:, -1], plain_last[:, -1])
    del x, hidden

    log(f"  checks: one prefill launches {once}, a decode step {in_decode}; "
        f"relative errors {errs} (limits: fp32 view {MECH_TOL}, bf16 gate "
        f"{gate})")
    log(f"  bf16 per block (limit {SERVE_TOL}): max {max(per_block)} at "
        f"block {int(np.argmax(per_block))}; {per_block}")
    log(f"  bf16 floor (input elements moved by one ulp: relative error of "
        f"the last logits) {floor}; gate max({SERVE_TOL}, 2 x floor) = {gate}")
    log(f"  planted fault (block {fault}, local window {RG_FAULT_WINDOW}): "
        f"per block {fault_block} (must exceed {SERVE_TOL}), full depth "
        f"{fault_full} (must exceed {gate})")
    failed = []
    for name, err in errs.items():
        limit = MECH_TOL if name.endswith("fp32") else gate
        if not err <= limit:
            failed.append(f"{name}: relative error {err} > {limit}")
    for i, err in enumerate(per_block):
        if not err <= SERVE_TOL:
            failed.append(f"block {i} ({blocks[i][2]}): relative error "
                          f"{err} > {SERVE_TOL}")
    if not fault_block > SERVE_TOL:
        failed.append(f"the planted fault passed the per-block check: "
                      f"{fault_block} <= {SERVE_TOL}")
    if not fault_full > gate:
        failed.append(f"the planted fault passed the full-depth gate: "
                      f"{fault_full} <= {gate}")
    if failed:
        raise AssertionError(f"{RG_ARCH} checks failed: " + "; ".join(failed))

    fns = {"prefill": prefill, "decode_step": lambda: dec(cfg, cache, cur)}
    return fns, {"per_prefill": once, "per_decode_step": in_decode, **errs,
                 "per_block_bf16": per_block, "floor_bf16": floor,
                 "gate_bf16": gate, "fault_block": fault,
                 "fault_per_block": fault_block, "fault_full_depth": fault_full}


# ---------------------------------------------------------------- phase 9

def zoo_trees(m: list, root: int, free: bool, row_params) -> dict:
    """The trees of the paper's comparison for ``(m, root)``, by name: the
    five that lower to the step plane, then the three whose edges may
    carry non-contiguous ranges.  ``free``: TUW picks its own root (then
    ``root`` is that root)."""
    from repro_torch.core import baselines, extensions, opttrees
    from repro_torch.core.treegather import build_gather_tree

    return {"tuw": build_gather_tree(m, root=None if free else root),
            "linear": baselines.linear_tree(m, root),
            "dp_optimal": opttrees.optimal_gather_tree(
                m, root, row_params.alpha, row_params.beta),
            "two_level": baselines.two_level_tree(m, root, node_size=4),
            "kported": extensions.build_kported_tree(m, 2, root=root),
            "binomial": baselines.binomial_tree(m, root),
            "3-nomial": baselines.knomial_tree(m, root, 3),
            "graceful": extensions.graceful_degradation(
                m, root, extensions.auto_threshold(m, row_params))}


def zoo_path(dev) -> dict:
    """Phase 9: the paper's tree comparison on ``LocalMesh(16)``, traced."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.costmodel import (CostParams, HostTopology,
                                            simulate_gather)
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.core.treegather import build_gather_tree
    from repro_torch.obs import trace as obs_trace

    qdr = CostParams.infiniband_qdr()
    # the paper's cluster, beta scaled to one 4 KiB row: the model's price
    # of a tree, not the card's (the card's alpha and beta are not fitted)
    row_params = CostParams(qdr.alpha, qdr.beta * ZOO_QDR_ROW, qdr.time_unit,
                            "row(4 KiB)")
    topo = HostTopology(*ZOO_HOSTS)
    row_bytes = F * 4
    mesh = rt.LocalMesh(P, device=dev)
    rows, refused, g2 = [], [], []
    rec = obs_trace.enable(obs_trace.TraceRecorder())
    calls = 0
    try:
        for name in NAMES:
            sizes = block_sizes(name, P, B, seed=SEED)
            rng = np.random.default_rng(SEED)
            blocks = [rng.standard_normal((s, F), dtype=np.float32)
                      for s in sizes]
            want = np.concatenate(blocks)
            free = build_gather_tree(sizes).root
            for label, root in [(str(r), r) for r in ZOO_ROOTS] + [
                    (f"free={free}", free)]:
                trees = zoo_trees(sizes, root, label.startswith("free"),
                                  row_params)
                for tname, tree in trees.items():
                    gaps = sum(1 for e in tree.edges if e.size > 0 and e.lo < 0)
                    model_us = simulate_gather(tree, row_params)
                    try:
                        plan = rt.plan_gatherv(sizes, root, tree=tree)
                    except ValueError:
                        if not gaps:
                            raise
                        refused.append({"dist": name, "root": label,
                                        "tree": tname, "lo_minus_1_edges": gaps,
                                        "model_us": model_us})
                        log(f"  {name:11s} root={label:7s} {tname:10s} refused "
                            f"by plan_gatherv ({gaps} edges with lo=-1); model "
                            f"only, at the paper's cluster parameters: "
                            f"{model_us:.1f} us")
                        continue
                    if gaps:
                        raise AssertionError(f"{tname} {name} root={label} has "
                                             f"{gaps} edges with lo=-1 but "
                                             f"plan_gatherv took it")
                    got, _ = rt.run_gatherv(mesh, blocks, root, tree=tree)
                    if not _same_bits(got, want):
                        raise AssertionError(f"gatherv {tname} {name} "
                                             f"root={label} differs")
                    outs, _ = rt.run_scatterv(mesh, want, sizes, root,
                                              tree=tree)
                    _check_blocks(f"scatterv {tname} {name} root={label}",
                                  outs, blocks)
                    calls += 2
                    flat = obs_trace.plan_link_bytes(plan.steps,
                                                     row_bytes=row_bytes)
                    split = obs_trace.plan_link_bytes(plan.steps, topo,
                                                      row_bytes)
                    if sum(split.values()) != flat["flat"]:
                        raise AssertionError(f"link classes {split} do not sum "
                                             f"to {flat}")
                    tables = plan_tensors(plan, dev)
                    x = torch.zeros((P, plan.cap, F), device=dev)
                    for r, b in enumerate(blocks):
                        x[r, : len(b)] = torch.from_numpy(b).to(dev)
                    g_ms = median_ms(
                        lambda: rt.gatherv_shard(x, plan, mesh, tables),
                        PATH_REPS)
                    del x
                    buf_root = torch.zeros((P, plan.buf_rows, F), device=dev)
                    buf_root[root, : plan.total] = torch.from_numpy(want).to(dev)
                    s_ms = median_ms(
                        lambda: rt.scatterv_shard(buf_root, plan, mesh, tables),
                        PATH_REPS)
                    del buf_root
                    moved = plan.tree_bytes_exact * row_bytes
                    row = {"dist": name, "root": label, "tree": tname,
                           "steps": len(plan.steps), "buf_rows": plan.buf_rows,
                           "tree_bytes_exact": moved,
                           "tree_bytes_padded": plan.tree_bytes_padded
                           * row_bytes, "bytes_by_link_class": split,
                           "gatherv_ms": g_ms, "scatterv_ms": s_ms,
                           "gatherv_GBps": moved / g_ms / 1e6,
                           "scatterv_GBps": moved / s_ms / 1e6,
                           "model_us_paper_cluster": model_us}
                    rows.append(row)
                    log(f"  {name:11s} root={label:7s} {tname:10s} "
                        f"steps={row['steps']:2d} bytes={moved} "
                        f"padded={row['tree_bytes_padded']} "
                        f"gatherv_ms={g_ms:.3f} scatterv_ms={s_ms:.3f} "
                        f"GB/s={row['gatherv_GBps']:.1f}/"
                        f"{row['scatterv_GBps']:.1f} model at the paper's "
                        f"cluster parameters: {model_us:.1f} us")
                torch.cuda.empty_cache()
            g2.append(measured_g2(dev, mesh, name, sizes, rows))
            torch.cuda.empty_cache()
    finally:
        obs_trace.disable()
    spans = rec.spans(cat="collective")
    if (len(spans) != calls or rec.dropped
            or {s.name for s in spans} != {"run/gatherv", "run/scatterv"}):
        raise AssertionError(f"{len(spans)} spans ({rec.dropped} dropped) for "
                             f"{calls} run_gatherv/run_scatterv calls")
    by_op = rec.span_times_by("op", cat="collective")
    if set(by_op) != {"gatherv", "scatterv"} or not np.isclose(
            sum(by_op.values()), sum(s.dur for s in spans), rtol=1e-9):
        raise AssertionError(f"span_times_by('op') {by_op} does not cover "
                             f"the spans")
    path = rec.save(os.path.join(REPO, "build", "phase9_trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    if len(events) != calls:
        raise AssertionError(f"the Chrome trace holds {len(events)} events, "
                             f"not {calls}")
    log(f"  telemetry: {calls} spans, seconds by op {by_op}, Chrome trace "
        f"{path} ({len(events)} events)")
    return {"trees": rows, "refused": refused, "g2": g2,
            "spans": calls, "span_seconds_by_op": by_op}


def measured_g2(dev, mesh, name: str, sizes: list, rows: list) -> dict:
    """G2 on the card, as ``benchmarks/jax_runtime.py`` measures it: the TUW
    gatherv at root 0 against an allreducev of one row plus the gatherv of
    the max-padded regular problem, all three timed alike."""
    import repro_torch as rt
    from repro_torch.core.carry import plan_tensors

    tuw_ms = next(r["gatherv_ms"] for r in rows if r["dist"] == name
                  and r["root"] == "0" and r["tree"] == "tuw")
    ar_plan = rt.plan_allreducev([1] + [0] * (P - 1))
    x = torch.randn((P, ar_plan.total, F), device=dev)
    tables = plan_tensors(ar_plan, dev)
    ar_ms = median_ms(lambda: rt.allreducev_shard(x, ar_plan, mesh, tables),
                      PATH_REPS)
    del x, tables
    pad = rt.plan_gatherv([max(sizes)] * P, 0)
    x = torch.randn((P, pad.cap, F), device=dev)
    tables = plan_tensors(pad, dev)
    pad_ms = median_ms(lambda: rt.gatherv_shard(x, pad, mesh, tables),
                       PATH_REPS)
    del x, tables
    out = {"dist": name, "tuw_gatherv_ms": tuw_ms, "allreducev_1row_ms": ar_ms,
           "padded_gatherv_ms": pad_ms, "padded_buf_rows": pad.buf_rows,
           "ratio": tuw_ms / (ar_ms + pad_ms)}
    log(f"  G2 {name:11s} root=0: TUW gatherv {tuw_ms:.3f} ms / (allreducev "
        f"of one row {ar_ms:.3f} + padded gatherv {pad_ms:.3f} ms) = "
        f"{out['ratio']:.3f} (no gate; this measures LocalMesh's emulated "
        f"dataplane, not a network)")
    return out


# ---------------------------------------------------------------- phase 10

def kendall_tau(x, y) -> float:
    """Kendall's tau-b of two equally long sequences (ties in either count
    against neither order); NaN when one of them is constant."""
    conc = disc = tie_x = tie_y = 0
    for i in range(len(x)):
        for j in range(i + 1, len(x)):
            dx, dy = np.sign(x[i] - x[j]), np.sign(y[i] - y[j])
            if dx == 0 and dy == 0:
                continue
            if dx == 0:
                tie_x += 1
            elif dy == 0:
                tie_y += 1
            elif dx == dy:
                conc += 1
            else:
                disc += 1
    denom = ((conc + disc + tie_x) * (conc + disc + tie_y)) ** 0.5
    return (conc - disc) / denom if denom else float("nan")


class RowCalibrators:
    """Hands each race to every ``OnlineCalibrator`` of ``cals`` with the
    candidate's row weights scaled to bytes (the dataplane view prices
    rows of ``F`` fp32 values)."""

    def __init__(self, *cals):
        self.cals = cals

    def observe_candidate(self, cand, seconds: float) -> None:
        for c in self.cals:
            c.observe_candidate(cand, seconds, row_bytes=F * 4)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def race_problems(dev, name: str, x: torch.Tensor, sizes: list, S: list):
    """The six problems of one distribution for phase 10: ``(op, arg,
    root, setup, check)``.  ``setup(plan, tables)`` makes the thunk that
    runs the candidate's plan through its ``*_shard`` entry point on
    device tensors at F = 1024 fp32 (inputs made outside it);
    ``check(plan, out)`` holds that output bitwise: byte moves
    against the concatenated blocks, reductions at F = ``RACE_ORACLE_F``
    against the port's NumPy executors and the full width's first
    ``RACE_ORACLE_F`` columns against that narrow run."""
    import repro_torch as rt
    from repro_torch.core.pipeline import (execute_allreducev_plan_numpy,
                                           execute_reduce_scatterv_plan_numpy)

    total = sum(sizes)
    cap = max(sizes)
    x_g = torch.zeros((P, cap, F), device=dev)
    for r in range(P):
        x_g[r, : sizes[r]] = x[r, : sizes[r]]
    want = torch.cat([x[r, : sizes[r]] for r in range(P)])
    a2a_cap = max(sum(row) for row in S)
    x_a = torch.zeros((P, a2a_cap, F), device=dev)
    for r in range(P):
        x_a[r, : sum(S[r])] = x[r, : sum(S[r])]
    offs = [np.concatenate([[0], np.cumsum(row)[:-1]]) for row in S]
    want_a = [torch.cat([x_a[i, offs[i][j]: offs[i][j] + S[i][j]]
                         for i in range(P)]) for j in range(P)]
    narrow = x[:, :, :RACE_ORACLE_F].contiguous()
    narrow_host = list(narrow.cpu().numpy())
    mesh = rt.LocalMesh(P, device=dev, hosts=TUNER_HOSTS[0])

    def check_gatherv(plan, buf):
        if not torch.equal(_bits(buf[0, :total]), _bits(want)):
            raise AssertionError(f"gatherv {name} differs")

    def setup_scatterv(plan, tables):
        buf = torch.zeros((P, plan.buf_rows, F), device=dev)
        buf[0, :total] = want      # only the root's rows are read
        return lambda: rt.scatterv_shard(buf, plan, mesh, tables)

    def check_scatterv(plan, out):
        for r in range(P):
            if not torch.equal(_bits(out[r, : sizes[r]]),
                               _bits(x[r, : sizes[r]])):
                raise AssertionError(f"scatterv {name} rank {r} differs")

    def check_allgatherv(plan, buf):
        for r in range(P):
            if not torch.equal(_bits(buf[r, :total]), _bits(want)):
                raise AssertionError(f"allgatherv {name} rank {r} differs")

    def check_alltoallv(plan, out):
        for j in range(P):
            if not torch.equal(_bits(out[j, : plan.out_valid[j]]),
                               _bits(want_a[j])):
                raise AssertionError(f"alltoallv {name} rank {j} differs")

    def check_reduce(shard, oracle, rows_of):
        def check(plan, out):
            got = shard(narrow, plan, mesh).cpu().numpy()
            ref = oracle(plan, narrow_host)
            head = out[:, :, :RACE_ORACLE_F].cpu().numpy()
            for r in range(P):
                n = rows_of(plan, r)
                if not (_same_bits(got[r, :n], ref[r])
                        and _same_bits(head[r, :n], got[r, :n])):
                    raise AssertionError(f"{shard.__name__} {name} rank {r} "
                                         f"differs")
        return check

    def on(shard, xin):
        return lambda plan, t: lambda: shard(xin, plan, mesh, t)

    return [
        ("gatherv", sizes, 0, on(rt.gatherv_shard, x_g), check_gatherv),
        ("scatterv", sizes, 0, setup_scatterv, check_scatterv),
        ("allgatherv", sizes, None, on(rt.allgatherv_shard, x_g),
         check_allgatherv),
        ("alltoallv", S, None, on(rt.alltoallv_shard, x_a), check_alltoallv),
        ("reduce_scatterv", sizes, None, on(rt.reduce_scatterv_shard, x),
         check_reduce(rt.reduce_scatterv_shard,
                      execute_reduce_scatterv_plan_numpy,
                      lambda plan, r: plan.sizes[r])),
        ("allreducev", sizes, None, on(rt.allreducev_shard, x),
         check_reduce(rt.allreducev_shard, execute_allreducev_plan_numpy,
                      lambda plan, r: plan.total)),
    ]


def tuner_path(dev) -> dict:
    """Phase 10: the host split, the metadata exchange, the card's (alpha,
    beta) and the tuner's candidates raced on ``LocalMesh(16, hosts=4)``.
    Every candidate of every problem is raced (all buckets of the default
    enumeration), so the model's ranking can be read in full."""
    import repro_torch as rt
    from repro_torch import tuner as tt
    from repro_torch.core.carry import plan_tensors
    from repro_torch.core.costmodel import CostParams, HostTopology
    from repro_torch.core.distributed import build_gather_tree_distributed
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.core.treegather import build_gather_tree

    hosts, per_host = TUNER_HOSTS
    mesh = rt.LocalMesh(P, device=dev, hosts=hosts)
    topo = HostTopology.from_mesh(mesh)
    fp, flat_fp = (tt.mesh_fingerprint(mesh),
                   tt.mesh_fingerprint(rt.LocalMesh(P, device=dev)))
    if topo != HostTopology(hosts, per_host) or \
            f"hosts={hosts}x{per_host}" not in fp or fp == flat_fp:
        raise AssertionError(f"host split {topo}, fingerprint {fp} (flat "
                             f"{flat_fp})")
    log(f"  (a) HostTopology.from_mesh: {topo.hosts} x "
        f"{topo.devices_per_host}; fingerprint {fp} (flat: {flat_fp})")
    meta = []
    for name in NAMES:
        sizes = block_sizes(name, P, B, seed=SEED)
        root = build_gather_tree(sizes).root
        if build_gather_tree_distributed(sizes)[0].root != root:
            raise AssertionError(f"host protocols disagree on {name}")
        est, groot, total = (v.tolist() for v in
                             rt.tree_metadata_exchange(sizes, mesh))
        if (groot, total, est) != ([root] * P, [sum(sizes)] * P,
                                   [sum(sizes) - sizes[root]] * P):
            raise AssertionError(f"metadata exchange {name}: root {groot}, "
                                 f"total {total}, est {est}; want {root}")
        meta.append({"dist": name, "root": root, "total": total[0],
                     "est": est[0]})
    log(f"  (a) tree_metadata_exchange agreed on all {P} ranks: "
        + ", ".join(f"{m['dist']} root {m['root']} total {m['total']} "
                    f"est {m['est']}" for m in meta))

    cal = tt.calibrate(tt.MeshTimingBackend(rt.LocalMesh(2, device=dev)),
                       sizes=CAL_SIZES, repeats=CAL_REPEATS)
    log(f"  (b) the emulated dataplane's fit (a device-local copy on "
        f"LocalMesh(2), not a link): alpha {cal.alpha_s * 1e6:.3f} us, "
        f"beta {cal.beta_s_per_byte * 1e12:.4f} ps/B "
        f"({1e-9 / cal.beta_s_per_byte:.1f} GB/s), r2 {cal.r2:.6f}")
    axes = tt.calibrate_axes({a: tt.MeshTimingBackend(mesh, a)
                              for a in ("device", "host")},
                             sizes=CAL_SIZES, repeats=CAL_REPEATS)
    for a, f in axes.items():
        if not (np.isfinite([f.alpha_s, f.beta_s_per_byte]).all()
                and f.alpha_s >= 0 and f.beta_s_per_byte > 0):
            raise AssertionError(f"axis {a} fit {f}")
        log(f"  (b) axis {a:6s} ({f.backend}): alpha {f.alpha_s * 1e6:.3f} "
            f"us, beta {f.beta_s_per_byte * 1e12:.4f} ps/B, r2 {f.r2:.6f}")
    row_params = CostParams(cal.alpha_s, cal.beta_s_per_byte * F * 4, "s",
                            "row(4 KiB)")
    overall = tt.OnlineCalibrator(cal)
    problems = []
    for k, name in enumerate(NAMES):
        sizes = block_sizes(name, P, B, seed=SEED)
        S = [block_sizes(name, P, A2A_B, seed=i) for i in range(P)]
        g = torch.Generator(device=dev).manual_seed(SEED + 20 + k)
        x = torch.randn((P, sum(sizes), F), generator=g, device=dev)
        for op, arg, root, setup, check in race_problems(dev, name, x, sizes,
                                                         S):
            cands = tt.enumerate_candidates(op, arg, root, row_params,
                                            view="dataplane", topology=topo)

            def measure(cand, setup=setup, check=check):
                plan = cand.build()
                run = setup(plan, plan_tensors(plan, dev))
                check(plan, run())
                return median_ms(run, RACE_REPS) / 1e3

            local = tt.OnlineCalibrator(cal)
            sel = tt.select(cands, row_params, measure=measure,
                            top_k=len(cands),
                            calibrator=RowCalibrators(local, overall))
            model = dict(sel.costs)
            meas = dict(sel.measured)
            names = [n for n, _ in sel.costs]
            tau = kendall_tau([model[n] for n in names],
                              [meas[n] for n in names])
            fit = local.fitted()
            row = {"op": op, "dist": name, "root": root,
                   "model_argmin": names[0],
                   "measured_argmin": sel.chosen, "kendall_tau": tau,
                   "model_ms": {n: model[n] * 1e3 for n in names},
                   "measured_ms": {n: meas[n] * 1e3 for n in names},
                   "refit_alpha_s": fit.alpha_s,
                   "refit_beta_s_per_byte": fit.beta_s_per_byte}
            problems.append(row)
            log(f"  (c) {op:15s} {name:11s} model argmin {names[0]:22s} "
                f"measured argmin {sel.chosen:22s} tau {tau:+.3f} refit "
                f"alpha {fit.alpha_s * 1e6:.3f} us beta "
                f"{fit.beta_s_per_byte * 1e12:.4f} ps/B | "
                + "  ".join(f"{n} {model[n] * 1e3:.3f}/{meas[n] * 1e3:.3f}"
                            for n in names))
        del x
        torch.cuda.empty_cache()
    fit = overall.fitted()
    agree = sum(r["model_argmin"] == r["measured_argmin"] for r in problems)
    log(f"  (c) {len(problems)} problems, {sum(len(r['model_ms']) for r in problems)} "
        f"races; model and measured argmin agree on {agree}; median tau "
        f"{np.nanmedian([r['kendall_tau'] for r in problems]):+.3f}; refit "
        f"over all races: alpha {fit.alpha_s * 1e6:.3f} us, beta "
        f"{fit.beta_s_per_byte * 1e12:.4f} ps/B (ms above: model/measured)")
    return {"fingerprint": fp, "metadata": meta,
            "calibration": dataclasses.asdict(cal),
            "axes": {a: dataclasses.asdict(f) for a, f in axes.items()},
            "problems": problems,
            "refit_all": dataclasses.asdict(fit)}


# ---------------------------------------------------------------- phase 11

SERVICE_OPS = ("gatherv", "scatterv", "allgatherv", "alltoallv",
               "reduce_scatterv", "allreducev")


def _on_host(g, shape, dev, dtype=torch.float32) -> np.ndarray:
    """Fresh normal numbers made on the card from ``g``, on the host (the
    service takes numpy); bf16 comes back as its bits in int16."""
    t = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    return (t.view(torch.int16) if dtype == torch.bfloat16 else t).cpu().numpy()


def _split(rows: np.ndarray, sizes) -> list:
    return np.split(rows, np.cumsum(sizes)[:-1])


def service_inputs(op: str, sizes: list, S: list, g, dev):
    """One call's fresh arguments of ``op`` and the result it must give
    (byte moves: ``np.concatenate`` and the blocks; reductions: the
    contributions, held to the NumPy executors by the caller)."""
    if op in ("gatherv", "scatterv", "allgatherv"):
        data = _on_host(g, (sum(sizes), SERVICE_F), dev)
        blocks = _split(data, sizes)
        if op == "gatherv":
            return (blocks, SERVICE_ROOT), data
        if op == "scatterv":
            return (data, sizes, SERVICE_ROOT), blocks
        return (blocks,), data
    if op == "alltoallv":
        flat = _split(_on_host(g, (sum(map(sum, S)), SERVICE_F), dev),
                      [s for row in S for s in row])
        blocks = [flat[i * P:(i + 1) * P] for i in range(P)]
        return (blocks,), [np.concatenate([blocks[i][j] for i in range(P)])
                           for j in range(P)]
    contribs = list(_on_host(g, (P, sum(sizes), SERVICE_F), dev))
    return (contribs, sizes), contribs


def check_service(op: str, got, want, plan) -> None:
    """Bitwise: byte moves against ``want``; reductions' first
    ``ORACLE_F`` columns against the NumPy executors on the same plan
    (``want`` holds the contributions; quantum 1, so the plan's offsets
    are the true ones)."""
    from repro_torch.core import pipeline

    if op == "reduce_scatterv":
        want = pipeline.execute_reduce_scatterv_plan_numpy(
            plan, [c[:, :ORACLE_F] for c in want])
        got = [b[:, :ORACLE_F] for b in got]
    elif op == "allreducev":
        want = np.stack(pipeline.execute_allreducev_plan_numpy(
            plan, [c[:, :ORACLE_F] for c in want]))
        got = got[:, :, :ORACLE_F]
    elif op == "allgatherv":
        want = np.stack([want] * P)
    if isinstance(want, list):
        _check_blocks(f"service {op}", got, want)
    elif not _same_bits(np.asarray(got), want):
        raise AssertionError(f"service {op} differs from its oracle")


def run_kwargs(op: str, algo: str) -> dict:
    """``run_*``'s arguments that lower the service's plan again: the
    reductions' schedule family and its bucket rounds, segments and wave
    bins, parsed from the candidate's name (``halving_reduce(S=2)``,
    ``tuw_reduce(b=1,g2)``, ...).  The byte moves' results do not depend
    on the plan, so they take none."""
    from repro_torch.core import composed

    if op not in ("reduce_scatterv", "allreducev"):
        return {}
    family, _, opts = algo.partition("(")
    kw = {}
    for opt in filter(None, opts.rstrip(")").split(",")):
        if opt.startswith("b="):
            kw["bucket_rounds"] = int(opt[2:])
        elif opt.startswith("S="):
            kw["segments"] = int(opt[2:])
        elif opt.startswith("g"):
            kw["wave_bin_ratio"] = float(opt[1:])
        else:
            raise ValueError(f"candidate {algo}: option {opt}")
    schedule = {"tuw_reduce": None,
                "halving_reduce": composed.reduce_scatterv_halving_schedule,
                "direct_reduce": composed.reduce_scatterv_direct_schedule}
    if family not in schedule:
        raise ValueError(f"candidate {algo}: no run_{op} lowers it")
    return {**kw, "schedule_fn": schedule[family]}


def run_same_plan(mesh, op: str, algo: str, args):
    """``run_*`` on ``args``, lowering the service's plan again."""
    import repro_torch as rt

    kw = run_kwargs(op, algo)
    fn = kw.pop("schedule_fn", None)
    if fn is not None:
        kw["schedule" if op == "reduce_scatterv" else "rs_schedule"] = fn(
            list(args[1]))
    return getattr(rt, "run_" + op)(mesh, *args, **kw)


def service_path(dev, cal) -> dict:
    """Phase 11a: the planner service on ``LocalMesh(16)`` with the card's
    calibration, the six ops on the six distributions, each called
    ``SERVICE_CALLS`` times with fresh data: the first builds and
    captures the executor (a miss), the others replay it (hits).  Each
    result is held bitwise to its oracle and to ``run_*`` on the same
    plan; each replay must add the launches its capture recorded; each
    executor's replay is held bitwise to, and timed against, its eager
    body on the same tables and static input; after each problem the
    device memory held must be what the executors account for, within
    the bound."""
    import repro_torch as rt
    from repro_torch import tuner as tt
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.kernels import backend
    from repro_torch.obs import trace as obs_trace
    from repro_torch.tuner import service

    mesh = rt.LocalMesh(P, device=dev)
    # drift refits off: a refit bumps the epoch and replans, so a call of
    # the same problem would capture again (the ledgers are printed)
    svc = tt.PlannerService(mesh=mesh, quantum=1, calibration=cal,
                            auto_refit=False)
    cap = svc.max_executor_bytes
    prev = obs_trace.current()
    rec = obs_trace.enable(obs_trace.TraceRecorder())
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rows, most_bytes, most_held = [], 0, 0
    captured, replayed = Counter(), Counter()
    try:
        for name in NAMES:
            sizes = block_sizes(name, P, B, seed=SEED)
            S = [block_sizes(name, P, A2A_B, seed=i) for i in range(P)]
            for op in SERVICE_OPS:
                walls, replays = [], []
                for call in range(SERVICE_CALLS):
                    args, want = service_inputs(op, sizes, S, g, dev)
                    before = dict(backend.LAUNCHES)
                    t0 = time.perf_counter()
                    got, plan = getattr(svc, op)(*args)
                    walls.append(time.perf_counter() - t0)
                    added = {k: n - before[k]
                             for k, n in backend.LAUNCHES.items()
                             if n != before[k]}
                    ex = next(reversed(svc._compiled.values()))
                    span = rec.spans(cat="collective",
                                     name_prefix="exec/" + op)[-1]
                    if span.args["fresh_compile"] != (call == 0):
                        raise AssertionError(f"{op} {name} call {call}: "
                                             f"fresh {span.args}")
                    if call == 0:
                        captured.update(ex.launches)
                    else:
                        replays.append(span.args["measured_s"])
                        if not ex.launches or added != ex.launches:
                            raise AssertionError(
                                f"{op} {name}: a replay added {added}, its "
                                f"capture recorded {ex.launches}")
                        replayed.update(added)
                    check_service(op, got, want, plan)
                algo = svc.plan_record(op, plan_arg(op, args), root=(
                    SERVICE_ROOT if op in ("gatherv", "scatterv") else None),
                    row_bytes=SERVICE_F * 4).algo
                t0 = time.perf_counter()
                ran, ran_plan = run_same_plan(mesh, op, algo, args)
                run_s = time.perf_counter() - t0
                if run_kwargs(op, algo) and len(ran_plan.steps) != len(
                        plan.steps):
                    raise AssertionError(f"run_{op} {name} lowered "
                                         f"another plan than {algo}")
                if isinstance(got, list):
                    _check_blocks(f"run_{op} {name}", ran, got)
                elif not _same_bits(np.asarray(ran), np.asarray(got)):
                    raise AssertionError(f"run_{op} {name} differs")
                eager = replay_against_eager(ex, g, dev)
                row = {"op": op, "dist": name, "algo": algo,
                       "steps": len(plan.steps),
                       "capture_ms": ex.build_s * 1e3,
                       "replay_ms": float(np.median(replays)) * 1e3,
                       "call_ms": float(np.median(walls[1:])) * 1e3,
                       "first_call_ms": walls[0] * 1e3,
                       "run_ms": run_s * 1e3, **eager,
                       "executor_bytes": ex.nbytes,
                       "replay_launches": dict(ex.launches)}
                rows.append(row)
                del ex, ran, got
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                held = torch.cuda.memory_reserved(dev) - base
                most_bytes = max(most_bytes, svc.executor_bytes)
                most_held = max(most_held, held)
                if (abs(held - svc.executor_bytes) > HELD_SLACK
                        or held > cap + HELD_SLACK):
                    raise AssertionError(
                        f"after {op} {name}: {held} B of device memory held "
                        f"over the phase's start, the executors account "
                        f"for {svc.executor_bytes} B, bound {cap} B")
                log(f"  (a) {op:15s} {name:11s} {algo:22s} capture "
                    f"{row['capture_ms']:9.3f} ms, call "
                    f"{row['call_ms']:8.3f} ms (its replay "
                    f"{row['replay_ms']:8.3f}), run_{op} "
                    f"{row['run_ms']:8.3f} ms; on the card replay "
                    f"{row['replay_device_ms']:7.3f} ms, eager body "
                    f"{row['eager_device_ms']:7.3f} ms; executor "
                    f"{row['executor_bytes']} B, held {held} B; a replay launches "
                    f"{row['replay_launches']}")
    finally:
        obs_trace.enable(prev) if prev is not None else obs_trace.disable()
    for what, counts in (("captures", captured), ("replays", replayed)):
        missing = [k for k in SERVICE_KERNELS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"the service's {what} never launched "
                                 f"{missing}: {dict(counts)}")
    st = svc.stats
    peak = torch.cuda.max_memory_reserved(dev) - base
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"  (a) executors: {st['compiled_misses']} captures recorded "
        f"{dict(captured)}, {st['compiled_hits']} replays launched "
        f"{dict(replayed)}; {svc.cache_size} kept, at most {most_bytes} B "
        f"accounted and {most_held} B held after a problem (bound {cap} B, "
        f"{service.EXECUTOR_MEMORY_SHARE} of {total} B; slack "
        f"{HELD_SLACK} B); evictions "
        f"{st['metrics']['counters'].get('compiled_lru_evictions', 0)}; "
        f"peak reserved {peak} B over the phase's start; plans "
        f"{st['misses']} misses, {st['hits']} hits")
    log(f"  (a) calibration {cal.alpha_s * 1e6:.3f} us, "
        f"{cal.beta_s_per_byte * 1e12:.4f} ps/B ({cal.backend}); residual "
        f"ledgers: " + json.dumps(st["residuals"]))
    log("  (a) guideline monitor: " + json.dumps(
        {k: v for k, v in st["guidelines"].items()
         if k != "recent_violations"}))
    out = {"rows": rows, "captures": st["compiled_misses"],
           "replays": st["compiled_hits"],
           "captured_launches": dict(captured),
           "replayed_launches": dict(replayed),
           "most_executor_bytes": most_bytes, "most_held_bytes": most_held,
           "executor_bound": cap, "peak_reserved": peak,
           "residuals": st["residuals"], "guidelines": st["guidelines"]}
    # one replay under the profiler: its graph's kernel nodes by name
    # (the profile's own launches are no part of the path's counts)
    ex = next(reversed(svc._compiled.values()))
    counted = dict(backend.LAUNCHES)
    out["profile"] = _profiled(
        f"replay of the last executor ({rows[-1]['op']} {rows[-1]['dist']}, "
        f"a replay launches {ex.launches})", {"replay": ex.graph.replay})
    backend.LAUNCHES.update(counted)
    del svc, ex
    torch.cuda.empty_cache()
    return out


def replay_against_eager(ex, g, dev) -> dict:
    """The executor's replay against its eager body (the ``*_shard`` call
    on the same tables and static input): bitwise, then both timed on the
    card in turns (CUDA-event medians; the eager body's host launches are
    in its window).  Neither is a launch of the main path, so the counts
    are restored."""
    from repro_torch.kernels import backend

    counted = dict(backend.LAUNCHES)
    ex.x.copy_(torch.randn(tuple(ex.x.shape), generator=g, device=dev))
    ex.graph.replay()
    replayed = ex.out.clone()
    eager = ex._body()
    if not torch.equal(replayed.view(torch.int32), eager.view(torch.int32)):
        raise AssertionError("a replay differs from the eager *_shard call "
                             "on the same tables and input")
    del replayed, eager
    times = {"replay": [], "eager": []}
    for _ in range(REPLAY_ROUNDS):
        times["replay"].append(median_ms(ex.graph.replay, REPLAY_REPS))
        times["eager"].append(median_ms(ex._body, REPLAY_REPS))
    backend.LAUNCHES.update(counted)
    return {"replay_device_ms": float(np.median(times["replay"])),
            "eager_device_ms": float(np.median(times["eager"]))}


def plan_arg(op: str, args) -> list:
    if op == "alltoallv":
        return [[len(b) for b in row] for row in args[0]]
    if op in ("scatterv", "reduce_scatterv", "allreducev"):
        return list(args[1])
    return [len(b) for b in args[0]]


def serving_planner_path(dev, cal, yi: dict) -> dict:
    """Phase 11b: (1) yi-6b served with and without a plan-only serving
    planner on ``--experts 4``'s routing, on phase 7's weights and
    queue (``yi``), the tokens those of phase 7b;
    (2) a serving planner on a mesh service over ``LocalMesh(MOE_P)``
    driven through ``dispatch`` / ``combine`` by the diurnal trace, each
    step bitwise (the dispatch against ``np.concatenate``, the combine
    against a plan-only twin's NumPy path, the classes the twin's), the
    captures counted after ``MOE_WARMUP_STEPS``."""
    import repro_torch as rt
    from repro_torch import tuner as tt
    from repro_torch.launch.serve import serve_requests
    from repro_torch.launch.serve_trace import serve_trace

    t0 = time.perf_counter()
    cfg = yi["cfg"]
    runs = {}
    for label in ("without planner", "with planner"):
        sp = (None if label == "without planner" else tt.ServingPlanner(
            tt.PlannerService(mesh=None, quantum=1),
            max_overhead=SERVE_CLASS_BOUND, row_bytes=cfg.d_model * 4))
        res = serve_requests(yi["params"], cfg, yi["queue"], SERVE_BATCH,
                             SERVE_GEN, dev, serving=sp,
                             experts=SERVE_EXPERTS, top_k=SERVE_TOP_K)
        for a, b in zip(res["tokens"], yi["tokens"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"yi-6b {label}: tokens differ from "
                                     f"phase 7b's")
        runs[label] = {"decode_ms_per_step": 1e3 * sum(res["decode_s"]) / (
            len(res["decode_s"]) * SERVE_GEN),
            "prefill_ms": [1e3 * s for s in res["prefill_s"]],
            "planner": sp.stats() if sp is not None else None}
        log(f"  (b) yi-6b {label}: decode "
            f"{runs[label]['decode_ms_per_step']:.3f} ms/step, prefill ms "
            f"{runs[label]['prefill_ms']}; tokens equal phase 7b's"
            + (f"; planner {sp.stats()}" if sp is not None else ""))
    log(f"  (b) yi-6b served twice in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = rt.LocalMesh(MOE_P, device=dev)
    kw = dict(quantum=1, calibration=cal, max_compiled=1024)
    on_mesh = tt.ServingPlanner(tt.PlannerService(
        mesh=mesh, auto_refit=False, **kw), row_bytes=MOE_D_MODEL * 2)
    twin = tt.ServingPlanner(tt.PlannerService(mesh=None, **kw),
                             row_bytes=MOE_D_MODEL * 2)
    trace = serve_trace(MOE_P, MOE_TRACE_STEPS, seed=SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    builds, hot, ms, checks_s = [], [], [], 0.0
    for st_ in trace:
        S, n = st_["S"], [int(v) for v in st_["n"]]
        flat = _split(_on_host(g, (int(S.sum()), MOE_D_MODEL), dev,
                               torch.bfloat16), S.reshape(-1))
        blocks = [flat[i * MOE_P:(i + 1) * MOE_P] for i in range(MOE_P)]
        contribs = list(_on_host(g, (MOE_P, sum(n), MOE_D_MODEL), dev))
        b0 = on_mesh.compiles
        ts = time.perf_counter()
        recv, _ = on_mesh.dispatch(blocks)
        summed, _ = on_mesh.combine(contribs, n)
        ms.append((time.perf_counter() - ts) * 1e3)
        hot.append(on_mesh.compiles - b0)
        ts = time.perf_counter()
        # the NumPy path: the twin plans the dispatch (its executor, a
        # byte move, is held to np.concatenate: at these classes it
        # copies the padded buffer once a step, seconds a step) and runs
        # the combine's fold
        twin.plan_step("alltoallv", S, dtype="int16",
                       row_bytes=MOE_D_MODEL * 2)
        want_sum, _ = twin.combine(contribs, n)
        _check_blocks("dispatch", recv, [
            np.concatenate([blocks[i][j] for i in range(MOE_P)])
            for j in range(MOE_P)])
        _check_blocks("combine", summed, want_sum)
        if on_mesh._current != twin._current:
            raise AssertionError("mesh and plan-only classes differ")
        checks_s += time.perf_counter() - ts
        on_mesh.prefetch(compile_width=MOE_D_MODEL)
        twin.prefetch()
        builds.append(on_mesh.compiles - b0)
    w = MOE_WARMUP_STEPS
    passes = {"warmup_captures": sum(builds[:w]),
              "captures_after_warmup": sum(builds[w:]),
              "hot_path_captures_after_warmup": sum(hot[w:]),
              "step_ms_median": float(np.median(ms[w:])),
              "step_ms_max": max(ms[w:])}
    log(f"  (b) LocalMesh({MOE_P}) serving over {len(trace)} trace steps "
        f"(bf16 dispatch and fp32 combine rows of {MOE_D_MODEL}): "
        f"{passes['warmup_captures']} captures in the first {w} steps, "
        f"{passes['captures_after_warmup']} after them "
        f"({passes['hot_path_captures_after_warmup']} on the hot path); "
        f"dispatch + combine after warm-up {passes['step_ms_median']:.3f} "
        f"ms median, {passes['step_ms_max']:.3f} max; every step bitwise")
    st = on_mesh.stats()
    log(f"  (b) mesh planner: {st}; executors held "
        f"{on_mesh.svc.executor_bytes} B; {len(trace)} steps in "
        f"{time.perf_counter() - t0:.1f} s, {checks_s:.1f} s of them in "
        f"the NumPy path and the checks")
    out = {"serve": runs, "mesh": passes, "mesh_planner": st,
           "executor_bytes": on_mesh.svc.executor_bytes}
    del on_mesh, twin
    torch.cuda.empty_cache()
    return out


def capture_failure_raises(dev) -> None:
    """A body that synchronises the device cannot be captured: building
    its executor on a CUDA ``LocalMesh`` must raise (there is no eager
    fallback), and the launch counts must come back unchanged."""
    import repro_torch as rt
    from repro_torch.kernels import backend
    from repro_torch.tuner import service

    from repro_torch.core.carry import plan_tensors

    plan = rt.plan_gatherv([3, 1, 4, 1], 0)
    mesh = rt.LocalMesh(4, device=dev)
    body = service._SHARD["gatherv"]
    service._SHARD["gatherv"] = (
        lambda *a: (torch.cuda.synchronize(), body(*a))[1])
    backend.reset_launches()
    try:
        service._Executor("gatherv", plan, mesh, 4, torch.float32)
    except RuntimeError as e:
        log(f"  (c) a failing capture raises: {str(e).splitlines()[0]}")
    else:
        raise AssertionError("a capture that synchronises did not raise")
    finally:
        service._SHARD["gatherv"] = body
    torch.cuda.synchronize(dev)
    # what stays counted is the eager warm-up's launches alone
    after = dict(backend.LAUNCHES)
    backend.reset_launches()
    body(torch.zeros((4, plan.cap, 4), device=dev), plan, mesh,
         plan_tensors(plan, dev))
    if after != backend.LAUNCHES:
        raise AssertionError(f"launch counts {after} after a failed capture, "
                             f"an eager call counts {backend.LAUNCHES}")
    if float(torch.ones(4, device=dev).sum()) != 4.0:
        raise AssertionError("the card does not compute after the failed "
                             "capture")


# ---------------------------------------------------------------- phase 12

def train_path(dev, arch: str = TRAIN_ARCH, reduced: bool = False,
               batch_size: int = TRAIN_B, seq: int = TRAIN_T,
               pred_gb: float = TRAIN_PRED_GB, label: str = "12a",
               prepare=None, profile: bool = True) -> dict:
    """Phase 12a (and 13a): ``launch/train``'s run of ``arch`` in fp32
    (full width and depth unless ``reduced``): ``SyntheticLM`` batches of
    ``batch_size`` x ``seq``, ``TRAIN_STEPS`` steps through
    ``TrainLoop``, one checkpoint at the end into a temporary directory
    removed afterwards.  ``prepare(params, cfg)``, where given, adjusts
    the fresh weights before the run.  Loss per step (finite and
    falling), step times, tokens/s, peak memory against the prediction
    ``pred_gb``, the checkpoint's snapshot and write times, and (with
    ``profile``) a profile of one more step."""
    import tempfile

    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train as train_cli

    tmp = tempfile.mkdtemp(prefix=f"phase{label}_")
    try:
        argv = ["--arch", arch, "--steps", str(TRAIN_STEPS),
                "--batch", str(batch_size), "--seq", str(seq),
                "--lr", str(TRAIN_LR), "--ckpt-dir", tmp, "--log-every", "1",
                "--device", str(dev)] + (["--reduced"] if reduced else [])
        args = train_cli.parser().parse_args(argv)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, pipeline, step_fn, state, loop = train_cli.build(args)
        if prepare is not None:
            prepare(state.params, cfg)
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{n_params} parameters, fp32; made in {init_s:.2f} s")
        t0 = time.perf_counter()
        state, hist = loop.run(state, TRAIN_STEPS, log_every=1)
        run_s = time.perf_counter() - t0
        losses = [r["loss"] for r in hist]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: the loss is not finite and "
                                 f"falling: {losses}")
        dts = [r["dt"] for r in hist]
        step_ms = float(np.median(dts[1:])) * 1e3
        # where a step's device time goes (its launches must be 0 too; the
        # profiler's count resets the launch counts, so they are kept)
        from repro_torch.kernels.ragged_gather import ops
        prof = None
        if profile:
            kept = dict(ops.LAUNCHES)
            batch = pipeline.batch(TRAIN_STEPS)
            prof = _profiled(f"{cfg.name} train step",
                             {"train step": lambda: step_fn(state, batch)},
                             reps=1)
            prof.update(breakdown(prof))
            ops.LAUNCHES.update(kept)
            if any(prof["launches_per_call"]["train step"].values()):
                raise AssertionError(f"{label}: a train step launched "
                                     f"{prof['launches_per_call']}")
        flops = 6.0 * n_params * batch_size * seq
        out = {"arch": cfg.name, "layers": cfg.n_layers,
               "params": n_params, "batch": batch_size, "seq": seq,
               "lr": TRAIN_LR, "losses": losses,
               "step_ms": [dt * 1e3 for dt in dts],
               "median_step_ms_after_first": step_ms,
               "tokens_per_s": batch_size * seq / (step_ms / 1e3),
               "model_tflop_per_step": flops / 1e12,
               "model_tflops_per_s": flops / (step_ms / 1e3) / 1e12,
               "state_bytes": 16 * n_params,
               "snapshot_ms": loop.checkpointer.snapshot_s * 1e3,
               "write_s": loop.checkpointer.write_s,
               "run_s": run_s, "init_s": init_s, "profile": prof,
               "tf32": torch.backends.cuda.matmul.allow_tf32}
        if dev.type == "cuda":
            out.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                       peak_reserved_bytes=torch.cuda.max_memory_reserved())
            log(f"  peak memory: {out['peak_allocated_bytes'] / 1e9:.2f} GB "
                f"allocated, {out['peak_reserved_bytes'] / 1e9:.2f} GB "
                f"reserved (predicted ~{pred_gb} GB: params, grads, "
                f"mu, nu {out['state_bytes'] / 1e9:.1f} GB + activations)")
        log(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
            f"{step_ms:.1f} ms (median after step 0), "
            f"{out['tokens_per_s']:.0f} tokens/s, "
            f"{out['model_tflops_per_s']:.1f} model TFLOP/s (6 N tokens); "
            f"checkpoint snapshot {out['snapshot_ms']:.0f} ms, write "
            f"{out['write_s']:.1f} s; TF32 "
            f"{'on' if out['tf32'] else 'off (fp32 products)'}")
        del state, loop
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _rel_frob(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _worst_leaf(got, want) -> tuple[float, str]:
    """The largest relative Frobenius error over the leaves of two trees,
    and its leaf's path."""
    from repro_torch.core.tree import leaves_with_path, tree_leaves

    worst, at = -1.0, None
    for (path, a), b in zip(leaves_with_path(got), tree_leaves(want)):
        e = _rel_frob(a, b)
        if e > worst:
            worst, at = e, "/".join(map(str, path))
    return worst, at


def _step_parity(dev, cfg, opt, batch: dict, label: str = "12b",
                 prepare=None, floor: bool = False,
                 gate_params: bool = True) -> dict:
    """One train step of ``cfg`` on the card against the same step on the
    CPU from the same state: the loss and the gradient's global norm
    within ``PARITY_LOSS_RTOL``; every updated parameter and every leaf of
    mu (0.1 x the clipped gradient, so the gradient itself, which the
    parameters' update barely shows at step 0: Adam's first step is about
    lr x sign(g)) within ``PARITY_PARAM_RTOL`` relative Frobenius.
    ``prepare(params, cfg)``, where given, adjusts the fresh weights
    first.  With ``floor`` each limit is ``max(limit, 2 x floor)``, the
    floor measured here: how far the card's own step moves when it sums
    the same batch in another order, as two microbatches (the same
    function: equal halves, the mean of their means).  Without
    ``gate_params`` the updated parameters are reported, not gated."""
    from repro_torch.core.tree import tree_map
    from repro_torch.train import init_train_state, make_train_step

    step_fn = make_train_step(cfg, opt, schedule_kw={
        "warmup": 20, "total": RESTART_STEPS})
    cpu = init_train_state(torch.Generator().manual_seed(SEED), cfg, opt,
                           "cpu")
    if prepare is not None:
        prepare(cpu.params, cfg)
    halves = tree_map(lambda t: t.to(dev, copy=True), cpu) if floor \
        else None
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    cpu, cm = step_fn(cpu, batch)
    card, dm = step_fn(card, batch)

    def errors(got, gm, want, wm) -> dict:
        out = {k: abs(float(gm[k]) - float(wm[k])) / abs(float(wm[k]))
               for k in ("loss", "grad_norm")}
        out["param"], out["param_at"] = _worst_leaf(got.params, want.params)
        out["mu"], out["mu_at"] = _worst_leaf(got.opt["mu"], want.opt["mu"])
        return out
    err = errors(card, dm, cpu, cm)
    limit = {"loss": PARITY_LOSS_RTOL, "grad_norm": PARITY_LOSS_RTOL,
             "param": PARITY_PARAM_RTOL, "mu": PARITY_PARAM_RTOL}
    order = None
    if floor:
        halves, hm = make_train_step(cfg, opt, schedule_kw={
            "warmup": 20, "total": RESTART_STEPS}, microbatches=2)(
                halves, batch)
        order = errors(halves, hm, card, dm)
        limit = {k: max(v, 2 * order[k]) for k, v in limit.items()}
        del halves
    T = batch["tokens"].shape[1]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": int(batch["tokens"].shape[0]), "seq": int(T),
           "loss_card": float(dm["loss"]), "loss_cpu": float(cm["loss"]),
           "loss_rel": err["loss"], "grad_norm_card": float(dm["grad_norm"]),
           "grad_norm_cpu": float(cm["grad_norm"]),
           "grad_norm_rel": err["grad_norm"], "param_rel_frob": err["param"],
           "param_worst_leaf": err["param_at"], "mu_rel_frob": err["mu"],
           "mu_worst_leaf": err["mu_at"], "limits": limit,
           "floor": order}
    log(f"  {label} parity ({cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, batch {out['batch']} x {T}): loss card "
        f"{out['loss_card']:.6f} cpu {out['loss_cpu']:.6f} (rel "
        f"{err['loss']:.2e}), grad norm card {out['grad_norm_card']:.6f} cpu "
        f"{out['grad_norm_cpu']:.6f} (rel {err['grad_norm']:.2e}); worst "
        f"updated parameter {err['param_at']} at {err['param']:.2e}, worst "
        f"mu {err['mu_at']} at {err['mu']:.2e} relative Frobenius; limits "
        f"{limit}" + (f" (floor: the card's step in two microbatches "
                      f"against one, {order})" if floor else ""))
    if not gate_params:
        del limit["param"]
    if not all(err[k] <= v for k, v in limit.items()):
        raise AssertionError(f"{label}: the card's train step of "
                             f"{cfg.name} differs from the CPU's")
    del cpu, card
    return out


def parity_restart_path(dev, layers: int = PARITY_LAYERS,
                        reduced: bool = False) -> dict:
    """Phase 12b: ``TRAIN_ARCH`` at full width (unless ``reduced``), depth
    cut to ``layers``.  One train step on the card against the same step
    on the CPU from the same state, and the same for ``PARITY_REDUCED``'s
    MoE and RG-LRU models; then the reference's restart
    equivalence on the card (``RESTART_STEPS`` steps, a checkpoint every
    ``RESTART_EVERY``, against a run killed at ``RESTART_FAIL`` and
    resumed) under ``torch.use_deterministic_algorithms``."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import SimulatedFailure, TrainLoop
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    cfg = (cfg.reduced() if reduced else cfg).with_(n_layers=layers,
                                                    dtype="float32")
    opt = AdamWConfig(lr=TRAIN_LR)
    step_fn = make_train_step(cfg, opt, schedule_kw={
        "warmup": 20, "total": RESTART_STEPS})
    pipeline = SyntheticLM(cfg.vocab, PARITY_T, PARITY_B)
    out = {"arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
           "batch": PARITY_B, "seq": PARITY_T}

    # one step on the card against the CPU from the same state, then the
    # same for the MoE layer and the RG-LRU scan (reduced configs)
    t0 = time.perf_counter()
    out["parity"] = [_step_parity(dev, cfg, opt, pipeline.batch(0))]
    for arch, t in PARITY_REDUCED:
        rcfg = get_config(arch).reduced().with_(dtype="float32")
        out["parity"].append(_step_parity(
            dev, rcfg, opt, SyntheticLM(rcfg.vocab, t, PARITY_B).batch(0)))
    out["parity_s"] = time.perf_counter() - t0

    # restart equivalence on the card
    def fresh():
        return init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                                cfg, opt, dev)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase12b_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref, ref_hist = TrainLoop(step_fn, pipeline, os.path.join(tmp, "ref"),
                                  ckpt_every=RESTART_EVERY).run(
                                      fresh(), RESTART_STEPS)
        killed = TrainLoop(step_fn, pipeline, os.path.join(tmp, "ft"),
                           ckpt_every=RESTART_EVERY,
                           fail_at_step=RESTART_FAIL)
        try:
            killed.run(fresh(), RESTART_STEPS)
            raise AssertionError("12b: the injected failure did not fire")
        except SimulatedFailure:
            pass
        got, hist = TrainLoop(step_fn, pipeline, os.path.join(tmp, "ft"),
                              ckpt_every=RESTART_EVERY).run(
                                  fresh(), RESTART_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    if hist[0]["step"] != RESTART_EVERY:
        raise AssertionError(f"12b: the run restarted at step "
                             f"{hist[0]['step']} instead of resuming at "
                             f"{RESTART_EVERY}")
    worst, bitwise = 0.0, True
    for a, b in zip(tree_leaves(ref.params) + tree_leaves(ref.opt),
                    tree_leaves(got.params) + tree_leaves(got.opt)):
        bitwise &= torch.equal(a, b)
        if a.is_floating_point():
            worst = max(worst, float((a - b).abs().max()))
    out.update(restart_resumed_at=hist[0]["step"],
               restart_max_abs_diff=worst, restart_bitwise=bitwise,
               restart_losses=[r["loss"] for r in ref_hist],
               restart_s=time.perf_counter() - t0)
    if not all(np.isfinite(out["restart_losses"])):
        raise AssertionError("12b: a loss is not finite")
    log(f"  12b restart: {RESTART_STEPS} steps, checkpoint every "
        f"{RESTART_EVERY}, killed at {RESTART_FAIL}, resumed at step "
        f"{hist[0]['step']}; params, mu, nu max |diff| {worst:.3e} (tol "
        f"{RESTART_TOL}), bitwise under deterministic algorithms: "
        f"{'yes' if bitwise else 'no'}")
    if worst > RESTART_TOL:
        raise AssertionError("12b: the resumed run does not land on the "
                             "uninterrupted one")
    del ref, got
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


class _StepIndex:
    """A pipeline whose batch is its step, for a step that trains nothing."""

    def batch(self, step: int) -> dict:
        return {"step": step}


def fault_runtime_path(dev, p: int = P, b: int = B, f: int = F) -> dict:
    """Phase 12c: the fault runtime over ``LocalMesh(p)`` through K1–K5,
    the ``FAULT_DIST`` sizes at ``b`` rows of ``f`` fp32 a rank: transient
    injected timeouts retried to bitwise results, a persistent one
    escalated to ``CollectiveTimeout``, a ``TrainLoop`` whose straggler
    ladder climbs on those timeouts to evict and hands off to an elastic
    shrink onto ``LocalMesh(p - 1)``, and a ``warn`` from
    ``ChaoticMachine``'s span times reaching a mesh ``PlannerService``."""
    import tempfile

    import repro_torch as rt
    from repro_torch.checkpoint import restore_latest, shrink_consolidation
    from repro_torch.core import torch_collectives as tc
    from repro_torch.core.distributions import block_sizes
    from repro_torch.core.pipeline import execute_reduce_scatterv_plan_numpy
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.runtime import (ChaoticMachine, ExecutionFaultInjector,
                                     FaultSchedule, HostLoss, LinkDegrade,
                                     StragglerPolicy, TimeoutFault, TrainLoop,
                                     remap_root, shrink_sizes,
                                     surviving_ranks)
    from repro_torch.tuner import PlannerService, SyntheticTimingBackend

    mesh = rt.LocalMesh(p, device=dev)
    sizes = block_sizes(FAULT_DIST, p, b, seed=SEED)
    rng = np.random.default_rng(SEED)
    blocks = [rng.standard_normal((s, f), dtype=np.float32) for s in sizes]
    want = np.concatenate(blocks)
    narrow = [rng.standard_normal((sum(sizes), ORACLE_F), dtype=np.float32)
              for _ in range(p)]
    out = {"dist": FAULT_DIST, "p": p, "rows": b, "row_bytes": 4 * f}
    tmp = tempfile.mkdtemp(prefix="phase12c_")
    retries = REGISTRY.counter("run_retries")
    tc.configure_step_deadline(None, retries=FAULT_RETRIES)
    try:
        # (1) one transient timeout an op: retried, bitwise
        inj = ExecutionFaultInjector(FaultSchedule.scripted(
            TimeoutFault(0, attempts=FAULT_RETRIES))).install()
        r0 = retries.value
        got, _ = rt.run_gatherv(mesh, blocks, 0)
        _check_blocks("12c gatherv under injected faults", [got], [want])
        ag, _ = rt.run_allgatherv(mesh, blocks)
        _check_blocks("12c allgatherv under injected faults", ag, [want] * p)
        rs, rs_plan = rt.run_reduce_scatterv(mesh, narrow, sizes)
        _check_blocks("12c reduce_scatterv under injected faults", rs,
                      execute_reduce_scatterv_plan_numpy(rs_plan, narrow))
        out["transient_retries"] = retries.value - r0
        out["transient_injected"] = inj.injected
        if out["transient_retries"] != 3 * FAULT_RETRIES \
                or inj.injected != 3 * FAULT_RETRIES:
            raise AssertionError(f"12c: {out['transient_retries']} retries "
                                 f"of {inj.injected} injected faults, want "
                                 f"{3 * FAULT_RETRIES} each")
        inj.uninstall()
        log(f"  12c transient faults: gatherv, allgatherv, reduce_scatterv "
            f"bitwise after {out['transient_retries']} retries "
            f"(run_retries)")

        # (2) a persistent fault escalates
        inj = ExecutionFaultInjector(FaultSchedule.scripted(
            TimeoutFault(0, op="gatherv", attempts=99))).install()
        try:
            rt.run_gatherv(mesh, blocks, 0)
            raise AssertionError("12c: a persistent fault did not escalate")
        except tc.CollectiveTimeout as e:
            out["persistent_attempts"] = e.attempts
            log(f"  12c persistent fault: {e}")
        inj.uninstall()

        # (3) the ladder climbs on timeouts to evict; the handler shrinks
        sched = FaultSchedule.scripted(
            *[TimeoutFault(s, op="gatherv", attempts=99) for s in range(3)],
            HostLoss(FAULT_VICTIM, 2))
        inj = ExecutionFaultInjector(sched).install()
        state = {"blocks": [torch.from_numpy(x).to(dev) for x in blocks]}
        evicted: dict = {}

        def hung_step(st, batch):
            inj.advance(batch["step"])
            rt.run_gatherv(mesh, blocks, 0)
            return st, {"loss": 0.0}

        def on_evict(step, host):
            inj.uninstall()
            lost = sched.lost_hosts(step)
            survivors = surviving_ranks(p, lost)
            sroot = remap_root(0, survivors)
            sblocks = [blocks[r] for r in survivors]
            if shrink_sizes(sizes, survivors) != [len(x) for x in sblocks]:
                raise AssertionError("12c: shrink_sizes")
            got, _ = rt.run_gatherv(rt.LocalMesh(len(survivors), device=dev),
                                    sblocks, sroot)
            _check_blocks("12c gatherv on the survivors", [got],
                          [np.concatenate(sblocks)])
            _, manifest = restore_latest(state, os.path.join(tmp, "evict"))
            shard_bytes = [4 * int(np.prod(manifest["leaves"][f"blocks/{r}"]
                                           ["shape"])) for r in range(p)]
            evicted.update(step=step, lost=sorted(lost),
                           survivors=len(survivors),
                           checkpoint_step=manifest["step"],
                           consolidation=shrink_consolidation(shard_bytes,
                                                              lost, 0))
        loop = TrainLoop(hung_step, _StepIndex(), os.path.join(tmp, "evict"),
                         ckpt_every=100, on_evict=on_evict)
        _, hist = loop.run(state, 10)
        actions = [r["action"] for r in hist]
        if actions != ["warn", "backup", "evict"] or not evicted:
            raise AssertionError(f"12c: the ladder went {actions}, "
                                 f"evicted {evicted}")
        out["ladder"] = actions
        out["evict"] = evicted
        log(f"  12c ladder on timeouts: {actions}; checkpoint at step "
            f"{evicted['checkpoint_step']}, host {evicted['lost']} lost, "
            f"gatherv bitwise on LocalMesh({evicted['survivors']}); "
            f"consolidation over the survivors: "
            f"{json.dumps(evicted['consolidation'])}")

        # (4) a warn from the chaotic machine's span times reaches the
        # planner service, which replans once and runs bitwise
        # one rank a host, so the straggler's host ids are the
        # machine's ranks (the service expands a host over its ranks)
        svc = PlannerService(mesh=rt.LocalMesh(p, device=dev, hosts=p),
                             quantum=1)
        plan = svc.plan_record("gatherv", sizes, root=0, dtype="float32",
                               row_bytes=4 * f).plan
        machine = ChaoticMachine(SyntheticTimingBackend(),
                                 FaultSchedule.scripted(LinkDegrade(
                                     FAULT_VICTIM, FAULT_FACTOR)))
        epoch0 = svc.params_epoch

        def served_step(st, batch):
            got, _ = svc.gatherv(blocks, 0)
            _check_blocks("12c service gatherv", [got], [want])
            return st, {"loss": 0.0}
        loop = TrainLoop(served_step, _StepIndex(), os.path.join(tmp, "warn"),
                         ckpt_every=100, planner=svc,
                         straggler=StragglerPolicy(evict_after=99),
                         host_times_fn=lambda step: machine.host_span_times(
                             plan, row_bytes=4 * f))
        _, hist = loop.run({"w": torch.zeros(4, device=dev)}, 1)
        verdicts = hist[0].get("host_actions", {})
        if verdicts.get(FAULT_VICTIM) != "warn" \
                or svc.params_epoch != epoch0 + 1:
            raise AssertionError(f"12c: verdicts {verdicts}, epoch "
                                 f"{epoch0} -> {svc.params_epoch}")
        rec = svc.plan_record("gatherv", sizes, root=0, dtype="float32",
                              row_bytes=4 * f)
        got, _ = svc.gatherv(blocks, 0)
        _check_blocks("12c service gatherv after the replan", [got], [want])
        out["warn"] = {"verdicts": verdicts, "epoch": [epoch0,
                                                       svc.params_epoch],
                       "link_health": svc.stats["link_health"],
                       "algo_after": rec.algo}
        log(f"  12c warn: verdicts {verdicts}, params epoch {epoch0} -> "
            f"{svc.params_epoch}, link health {svc.stats['link_health']}, "
            f"replanned gatherv {rec.algo} bitwise")
    finally:
        tc.set_fault_hook(None)
        tc.configure_step_deadline(None)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase 13

def slstm_fan_in(params: dict, cfg) -> None:
    """Scales every sLSTM block's recurrent weight ``rh`` ``(H, hd, 4 hd)``
    in place from the reference's init, whose fan-in is ``shape[0]`` (the
    ``H`` heads: std 1/sqrt(H)), to the fan-in of the product it enters
    (``hd``: std 1/sqrt(hd)).  At the reference's scale xlstm-125m's sLSTM
    recurrence is chaotic: a 1e-6 change of one input moves its output by
    about 4 % after 64 steps and the training gradients overflow past
    some 400 steps, in both packages (ROADMAP Queue 3), so no two
    evaluation orders could be compared."""
    hd = cfg.d_model // cfg.n_heads
    log(f"  {cfg.name}: sLSTM rh scaled to the fan-in hd = {hd} (std "
        f"1/sqrt({hd}); the reference's init: 1/sqrt({cfg.n_heads}))")
    blocks = params["first"] + [b for period in params["body"]
                                for b in period] + params["tail"]
    with torch.no_grad():
        for blk in blocks:
            if "rh" in blk.get("rec", {}):
                blk["rec"]["rh"].mul_(math.sqrt(cfg.n_heads / hd))


def arch_parity_path(dev) -> dict:
    """Phase 13b: one train step on the card against the same step on the
    CPU from the same state, at 12b's gates: xlstm-125m at full width,
    depth cut to its three mLSTM blocks, on ``PARITY_B`` x
    ``PARITY_XLSTM_T`` (the chunkwise mLSTM under autograd); xlstm-125m at
    full width and depth on ``PARITY_B`` x ``PARITY_SLSTM_T`` (the sLSTM
    loop under autograd); for both, each gate is raised to twice the
    move of the card's own step between two summation orders (the xLSTM's
    gradients carry more fp32 rounding than granite's).  At full depth the
    updated parameters are reported, not gated: Adam's first step is
    about lr x sign(g), and one gradient entry within rounding of zero
    that flips its sign moves the 768 x 4 ``wi`` leaf by 1.5e-4 relative,
    so the gradient itself (mu) carries the check.  And reduced
    llama-3.2-vision-11b on ``PARITY_B`` x ``PARITY_T`` with its image
    tokens (a cross block under autograd, where K8 must not launch)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig

    opt = AdamWConfig(lr=TRAIN_LR)
    cfg = get_config(XLSTM_ARCH).with_(dtype="float32")
    out = [_step_parity(dev, cfg.with_(n_layers=3), opt, SyntheticLM(
        cfg.vocab, PARITY_XLSTM_T, PARITY_B).batch(0), "13b", floor=True),
        _step_parity(dev, cfg, opt, SyntheticLM(
            cfg.vocab, PARITY_SLSTM_T, PARITY_B).batch(0), "13b",
            prepare=slstm_fan_in, floor=True, gate_params=False)]
    vcfg = get_config(VLM_ARCH).reduced()
    batch = SyntheticLM(vcfg.vocab, PARITY_T, PARITY_B).batch(0)
    batch["img"] = np.random.default_rng(SEED).standard_normal(
        (PARITY_B, vcfg.n_img_tokens, vcfg.d_model)).astype(np.float32)
    out.append(_step_parity(dev, vcfg, opt, batch, "13b"))
    return {"parity": out}


def xlstm_checks(dev, ctx: dict) -> tuple[dict, dict]:
    """Phase 13c's checks on xlstm-125m: a prefill and a decode step
    launch no kernel and give finite logits; prefill of ``CONSIST_T``
    tokens then ``CONSIST_STEPS`` decode steps against ``forward`` over
    the same tokens, within ``MECH_TOL`` with fp32 activations and, in
    bf16, within ``max(SERVE_TOL, 2 x floor)``, the floor measured here on
    that forward.  Returns the thunks of a prefill and a decode step and
    the numbers."""
    from repro_torch.kernels import backend
    from repro_torch.models import transformer as tf

    cfg, params, queue, rng = (ctx["cfg"], ctx["params"], ctx["queue"],
                               ctx["rng"])
    cfg32 = cfg.with_(dtype="float32", embed_inputs=False)
    cfg_e = cfg.with_(embed_inputs=False)
    toks = first_batch(queue, dev)
    cache_len = toks.shape[1] + SERVE_GEN

    def prefill(c=cfg):
        logits, _, cache = tf.forward(
            params, c, cache=tf.init_cache(c, SERVE_BATCH, cache_len, dev),
            logits_last_only=True, **_token_kw(c, params, toks, "tokens"))
        return logits, cache

    def dec(c, cache, tok):
        return tf.decode_step(params, c, cache,
                              **_token_kw(c, params, tok, "token"))

    backend.reset_launches()
    logits, cache = prefill()
    cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    dlogits, cache = dec(cfg, cache, cur)
    torch.cuda.synchronize(dev)
    launched = {k: n for k, n in backend.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"xlstm-125m's prefill and decode launched "
                             f"{launched}; its blocks have no kernel")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(dlogits).all())):
        raise AssertionError("non-finite logits in prefill or decode")

    T = CONSIST_T
    seq = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, T + CONSIST_STEPS)).astype(np.int32)).to(dev)

    def consist(c):
        full = tf.forward(params, c,
                          **_token_kw(c, params, seq, "tokens"))[0]
        first, _, c1 = tf.forward(
            params, c, cache=tf.init_cache(c, 1, T + CONSIST_STEPS, dev),
            logits_last_only=True,
            **_token_kw(c, params, seq[:, :T], "tokens"))
        outs = [first]
        for i in range(CONSIST_STEPS):
            out, c1 = dec(c, c1, seq[:, T + i:T + i + 1])
            outs.append(out)
        return _rel(torch.cat(outs, 1), full[:, T - 1:T + CONSIST_STEPS])

    errs = {"prefill_decode_vs_forward_fp32": consist(cfg32),
            "prefill_decode_vs_forward_bf16": consist(cfg)}
    floor = _floor(lambda e: tf.forward(params, cfg_e, embeds=e)[0],
                   params["embed"]["e"][seq], rng)
    gate = max(SERVE_TOL, 2 * max(floor.values()))
    log(f"  checks: a prefill and a decode step launch {launched or 'none'}; "
        f"relative errors {errs} (limits: fp32 view {MECH_TOL}, bf16 gate "
        f"{gate}); bf16 floor {floor}")
    for name, err in errs.items():
        limit = MECH_TOL if name.endswith("fp32") else gate
        if not err <= limit:
            raise AssertionError(f"{name}: relative error {err} > {limit}")
    def short_prefill():
        return tf.forward(
            params, cfg, cache=tf.init_cache(cfg, SERVE_BATCH, T, dev),
            logits_last_only=True, tokens=toks[:, -T:])

    fns = {"prefill": prefill, "short_prefill": short_prefill,
           "decode_step": lambda: dec(cfg, cache, cur)}
    return fns, {**errs, "floor_bf16": floor, "gate_bf16": gate}


def slstm_cost(dev, ctx: dict, prefill) -> dict:
    """What the sLSTM's Python loop costs: one sLSTM block's prefill at the
    first batch's shape (bf16, random input from the seed), its device
    kernels counted and its busy time summed by ``torch.profiler``, its
    wall time by the host clock; and the share of a whole prefill spent
    in the sLSTM blocks (each call synchronised and timed in place)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as tf

    cfg, params = ctx["cfg"], ctx["params"]
    group, index, _, _ = next(b for b in tf._blocks(cfg) if b[2] == "slstm")
    p = tf._get(params, group, index)["rec"]
    plen = max(len(q) for q in ctx["queue"][:SERVE_BATCH])
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((SERVE_BATCH, plen, cfg.d_model), generator=g,
                    device=dev).to(getattr(torch, cfg.dtype))
    rec.slstm_block(p, x, cfg.n_heads)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rec.slstm_block(p, x, cfg.n_heads)
    torch.cuda.synchronize(dev)
    block_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec.slstm_block(p, x, cfg.n_heads)
        torch.cuda.synchronize(dev)
    kernels, busy_us = 0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
            busy_us += us
    spent = []
    orig = rec.slstm_block

    def timed(*a, **k):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize(dev)
        spent.append(time.perf_counter() - t)
        return out
    rec.slstm_block = timed
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rec.slstm_block = orig
    out = {"batch": SERVE_BATCH, "tokens": plen,
           "block_wall_ms": block_ms, "block_kernels": kernels,
           "block_busy_ms": busy_us / 1e3,
           "kernels_per_token": kernels / plen,
           "slstm_blocks": len(spent),
           "prefill_slstm_ms": 1e3 * sum(spent), "prefill_ms": prefill_ms,
           "prefill_slstm_share": 1e3 * sum(spent) / prefill_ms}
    log(f"  sLSTM loop: one block's prefill (B {SERVE_BATCH}, T {plen}) "
        f"launches {kernels} kernels ({kernels / plen:.1f} a step), "
        f"{busy_us / 1e3:.3f} ms busy in {block_ms:.3f} ms wall; in a "
        f"prefill its {len(spent)} blocks take {1e3 * sum(spent):.1f} of "
        f"{prefill_ms:.1f} ms ({100 * out['prefill_slstm_share']:.1f} %)")
    return out


def vision_setup(dev) -> dict:
    """llama-3.2-vision-11b's random weights and requests (as
    ``serve_setup``) and its image embeddings ``(SERVE_BATCH,
    n_img_tokens, d_model)`` in fp32, all from the seed."""
    ctx = serve_setup(dev, VLM_ARCH)
    cfg = ctx["cfg"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    ctx["img"] = torch.randn((SERVE_BATCH, cfg.n_img_tokens, cfg.d_model),
                             generator=g, device=dev)
    return ctx


def vision_serve(dev, ctx: dict) -> dict:
    """Phase 13d's main path: the requests served as ``serve_requests``
    serves a token arch (left-padded batches of ``SERVE_BATCH``, a fresh
    cache, one prefill, ``SERVE_GEN`` greedy decode steps), through
    ``make_prefill_step`` / ``make_decode_step`` with the image
    embeddings, which the serving driver does not take."""
    from repro_torch.kernels import backend
    from repro_torch.models.transformer import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg, params, queue, img = (ctx["cfg"], ctx["params"], ctx["queue"],
                               ctx["img"])
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    tokens, prefill_ms, decode_s = [], [], 0.0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for b0 in range(0, len(queue), SERVE_BATCH):
        prompts = queue[b0:b0 + SERVE_BATCH]
        plen = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        im = img[:len(prompts)]
        cache = init_cache(cfg, len(prompts), plen + SERVE_GEN, dev)
        t1 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": torch.from_numpy(toks).to(
            dev), "img": im}, cache)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        picked = [cur]
        for _ in range(SERVE_GEN):
            logits, cache = decode(params, cache, {"tokens": cur, "img": im})
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            picked.append(cur)
        torch.cuda.synchronize(dev)
        prefill_ms.append((t2 - t1) * 1e3)
        decode_s += time.perf_counter() - t2
        tokens.extend(torch.cat(picked, 1).cpu().numpy())
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for toks in tokens:
        if toks.shape != (SERVE_GEN + 1,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"served tokens out of range: {toks}")
    n_out = SERVE_GEN * len(queue)
    out = {"arch": cfg.name, "dtype": SERVE_DTYPE, "layers": cfg.n_layers,
           "parameters": ctx["parameters"],
           "weight_bytes": ctx["weight_bytes"], "init_s": ctx["init_s"],
           "prompt_lens": ctx["lens"].tolist(), "batch": SERVE_BATCH,
           "gen": SERVE_GEN, "img_tokens": cfg.n_img_tokens,
           "prefill_ms": prefill_ms,
           "decode_ms_per_step": 1e3 * decode_s / (len(prefill_ms)
                                                   * SERVE_GEN),
           "tokens_per_s": n_out / wall, "decode_tokens_per_s":
               n_out / decode_s, "wall_s": wall, "peak_bytes": peak,
           "k8_launches": backend.LAUNCHES["flash_attention"]}
    log(f"  served {len(tokens)} requests in {len(prefill_ms)} batches: "
        f"prefill ms {prefill_ms}, decode ms/step "
        f"{out['decode_ms_per_step']:.3f}, {out['tokens_per_s']:.1f} "
        f"tokens/s over {wall:.2f} s, peak {peak} bytes")
    return out


def vision_checks(dev, ctx: dict) -> tuple[dict, dict]:
    """Phase 13d's checks, as phase 7b's: one prefill launches K8 once a
    layer and once more a cross block, a decode step once a cross block,
    with finite logits; the prefill's last logits against the plain
    versions and prefill + decode against ``forward``, with fp32
    activations within ``MECH_TOL`` and in bf16 within phase 8's gate
    ``max(SERVE_TOL, 2 x floor)``, the floor measured here: at 40 layers
    the bf16 readings sit at it."""
    import repro_torch as rt
    from repro_torch.kernels import backend
    from repro_torch.models import transformer as tf

    cfg, params, queue, rng, img = (ctx["cfg"], ctx["params"], ctx["queue"],
                                    ctx["rng"], ctx["img"])
    cfg32 = cfg.with_(dtype="float32", embed_inputs=False)
    n_cross = sum(k == "cross" for _, _, k, _ in tf._blocks(cfg))
    toks = first_batch(queue, dev)
    cache_len = toks.shape[1] + SERVE_GEN

    def prefill(c=cfg):
        logits, _, cache = tf.forward(
            params, c, img=img,
            cache=tf.init_cache(c, SERVE_BATCH, cache_len, dev),
            logits_last_only=True, **_token_kw(c, params, toks, "tokens"))
        return logits, cache

    def dec(c, cache, tok, im=img):
        return tf.decode_step(params, c, cache, img=im,
                              **_token_kw(c, params, tok, "token"))

    backend.reset_launches()
    logits, cache = prefill()
    once = backend.LAUNCHES["flash_attention"]
    cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    backend.reset_launches()
    dlogits, cache = dec(cfg, cache, cur)
    torch.cuda.synchronize(dev)
    in_decode = backend.LAUNCHES["flash_attention"]
    if once != cfg.n_layers + n_cross or in_decode != n_cross:
        raise AssertionError(f"a prefill launched K8 {once} times (want "
                             f"{cfg.n_layers + n_cross}), a decode step "
                             f"{in_decode} (want {n_cross})")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(dlogits).all())):
        raise AssertionError("non-finite logits in prefill or decode")

    T = CONSIST_T
    seq = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, T + CONSIST_STEPS)).astype(np.int32)).to(dev)
    errs = {}
    for label, c in (("bf16", cfg), ("fp32", cfg32)):
        k8 = logits if c is cfg else prefill(c)[0]
        rt.use_kernel_dataplane(False)
        try:
            plain = prefill(c)[0]
        finally:
            rt.use_kernel_dataplane(None)
        errs[f"prefill_vs_plain_{label}"] = _rel(k8[:, -1], plain[:, -1])
        del k8, plain
        full = tf.forward(params, c, img=img[:1],
                          **_token_kw(c, params, seq, "tokens"))[0]
        first, _, c1 = tf.forward(
            params, c, img=img[:1],
            cache=tf.init_cache(c, 1, T + CONSIST_STEPS, dev),
            logits_last_only=True,
            **_token_kw(c, params, seq[:, :T], "tokens"))
        outs = [first]
        for i in range(CONSIST_STEPS):
            out, c1 = dec(c, c1, seq[:, T + i:T + i + 1], img[:1])
            outs.append(out)
        errs[f"prefill_decode_vs_forward_{label}"] = _rel(
            torch.cat(outs, 1), full[:, T - 1:T + CONSIST_STEPS])
        del full, c1, outs
    # the bf16 noise floor of phase 8 on this model: the readings at full
    # depth sit at it, so they are gated as phase 8 gates its own
    cfg_e = cfg.with_(embed_inputs=False)
    floor = _floor(lambda e: tf.forward(params, cfg_e, embeds=e,
                                        img=img[:1])[0],
                   params["embed"]["e"][seq], rng)
    gate = max(SERVE_TOL, 2 * max(floor.values()))
    log(f"  checks: one prefill launches K8 {once} times ({cfg.n_layers} "
        f"self, {n_cross} cross), a decode step {in_decode}; relative "
        f"errors {errs} (limits: fp32 view {MECH_TOL}, bf16 gate {gate}); "
        f"bf16 floor {floor}")
    for name, err in errs.items():
        limit = MECH_TOL if name.endswith("fp32") else gate
        if not err <= limit:
            raise AssertionError(f"{name}: relative error {err} > {limit}")
    fns = {"prefill": prefill, "decode_step": lambda: dec(cfg, cache, cur)}
    return fns, {"k8_per_prefill": once, "k8_per_decode_step": in_decode,
                 **errs, "floor_bf16": floor, "gate_bf16": gate}


def arch_setup(dev, arch: str, layers: int | None) -> dict:
    """``arch`` at full width in bf16 (depth cut to ``layers`` where
    given), random weights from the seed, and the inputs of a prefill of
    ``ARCH_B`` x ``ARCH_T`` and ``CONSIST_STEPS`` decode steps: tokens, or
    frame embeddings for a config fed embeddings."""
    import repro_torch as rt
    from repro_torch.models.transformer import init_params

    cfg = rt.get_config(arch).with_(dtype=SERVE_DTYPE)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    leaves = [t for _, t in _tensors(params)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = ARCH_T + CONSIST_STEPS
    if cfg.embed_inputs:
        seq = torch.randint(0, cfg.vocab, (ARCH_B, n), generator=g,
                            device=dev, dtype=torch.int32)
    else:
        seq = torch.randn((ARCH_B, n, cfg.d_model), generator=g,
                          device=dev).to(getattr(torch, cfg.dtype))
    ctx = {"cfg": cfg, "params": params, "seq": seq, "init_s": init_s,
           "parameters": sum(t.numel() for t in leaves),
           "weight_bytes": sum(t.numel() * t.element_size() for t in leaves)}
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.hd}, {ctx['parameters']} "
        f"parameters, {ctx['weight_bytes']} bytes, made in {init_s:.2f} s")
    return ctx


def _seq_kw(cfg, seq: torch.Tensor, name: str) -> dict:
    return {name: seq} if cfg.embed_inputs else {"embeds": seq}


def arch_main(dev, ctx: dict) -> dict:
    """Phase 13e's main path: a prefill of ``ARCH_T`` tokens and
    ``CONSIST_STEPS`` decode steps through ``make_prefill_step`` /
    ``make_decode_step``, timed; the logits are kept for the checks."""
    from repro_torch.kernels import backend
    from repro_torch.models.transformer import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg, params, seq = ctx["cfg"], ctx["params"], ctx["seq"]
    key = "tokens" if cfg.embed_inputs else "embeds"
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    cache = init_cache(cfg, ARCH_B, ARCH_T + CONSIST_STEPS, dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {key: seq[:, :ARCH_T]}, cache)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    outs = [logits]
    for i in range(CONSIST_STEPS):
        logits, cache = decode(params, cache,
                               {key: seq[:, ARCH_T + i:ARCH_T + i + 1]})
        outs.append(logits)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    ctx["served"] = torch.cat(outs, 1)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "hd": cfg.hd, "parameters": ctx["parameters"],
           "weight_bytes": ctx["weight_bytes"], "init_s": ctx["init_s"],
           "batch": ARCH_B, "prefill_tokens": ARCH_T,
           "prefill_ms": (t1 - t0) * 1e3,
           "decode_ms_per_step": (t2 - t1) * 1e3 / CONSIST_STEPS,
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "k8_launches": backend.LAUNCHES["flash_attention"]}
    log(f"  {cfg.name}: prefill {out['prefill_ms']:.1f} ms ({ARCH_B} x "
        f"{ARCH_T}), decode {out['decode_ms_per_step']:.2f} ms a step, peak "
        f"{out['peak_bytes']} bytes")
    return out


def arch_checks(dev, ctx: dict) -> dict:
    """Phase 13e's checks: one prefill launches K8 once a layer and a
    decode step never; finite logits; the main path's prefill against the
    plain versions and its prefill + decode against ``forward`` over the
    same ``ARCH_T + CONSIST_STEPS`` tokens, within phase 8's gate
    ``max(SERVE_TOL, 2 x floor)``, the floor measured here."""
    import repro_torch as rt
    from repro_torch.kernels import backend
    from repro_torch.models import transformer as tf

    cfg, params, seq, served = (ctx["cfg"], ctx["params"], ctx["seq"],
                                ctx["served"])

    def prefill():
        return tf.forward(params, cfg, cache=tf.init_cache(
            cfg, ARCH_B, ARCH_T + CONSIST_STEPS, dev), logits_last_only=True,
            **_seq_kw(cfg, seq[:, :ARCH_T], "tokens"))

    backend.reset_launches()
    logits, _, cache = prefill()
    once = backend.LAUNCHES["flash_attention"]
    backend.reset_launches()
    tf.decode_step(params, cfg, cache,
                   **_seq_kw(cfg, seq[:, ARCH_T:ARCH_T + 1], "token"))
    torch.cuda.synchronize(dev)
    in_decode = backend.LAUNCHES["flash_attention"]
    if once != cfg.n_layers or in_decode != 0:
        raise AssertionError(f"{cfg.name}: a prefill launched K8 {once} "
                             f"times (want {cfg.n_layers}), a decode step "
                             f"{in_decode} (want 0)")
    if not bool(torch.isfinite(served).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    del cache
    rt.use_kernel_dataplane(False)
    try:
        plain = prefill()[0]
    finally:
        rt.use_kernel_dataplane(None)
    errs = {"prefill_vs_plain_bf16": _rel(served[:, :1], plain)}
    del plain
    full = tf.forward(params, cfg, **_seq_kw(cfg, seq, "tokens"))[0]
    errs["prefill_decode_vs_forward_bf16"] = _rel(
        served, full[:, ARCH_T - 1:ARCH_T + CONSIST_STEPS])
    del full
    # the bf16 noise floor of phase 8 on one sequence, and its gate
    cfg_e = cfg.with_(embed_inputs=False)
    emb = seq[:1] if not cfg.embed_inputs else params["embed"]["e"][seq[:1]]
    floor = _floor(lambda e: tf.forward(params, cfg_e, embeds=e)[0], emb,
                   np.random.default_rng(SEED))
    gate = max(SERVE_TOL, 2 * max(floor.values()))
    log(f"  checks: one prefill launches K8 {once} times, a decode step "
        f"{in_decode}; relative errors {errs} (gate max({SERVE_TOL}, 2 x "
        f"floor) = {gate}); bf16 floor {floor}")
    for name, err in errs.items():
        if not err <= gate:
            raise AssertionError(f"{cfg.name} {name}: relative error {err} "
                                 f"> {gate}")
    return {"k8_per_prefill": once, "k8_per_decode_step": in_decode, **errs,
            "floor_bf16": floor, "gate_bf16": gate}


def model_zoo_phase(dev, main_path_launches) -> None:
    """Phase 13: xlstm-125m trained (13a) and a step of it and of reduced
    llama-3.2-vision-11b held to the CPU's (13b); xlstm-125m served (13c);
    llama-3.2-vision-11b served with its cross-attention on K8 (13d); a
    prefill and decode steps of stablelm-3b (K8 at hd 80), musicgen-large
    and llama3-405b cut to 4 layers (13e).  ``main_path_launches`` runs a
    main path with the launch counts set to 0 just before and read just
    after."""
    from repro_torch.kernels.ragged_gather import ops

    no_grad_kernels = ("ragged_gather", "flash_attention", "rglru_scan")
    t0 = time.perf_counter()
    trained = main_path_launches(
        "xlstm-125m training (13a)", (),
        lambda: train_path(dev, XLSTM_ARCH, batch_size=XLSTM_B, seq=XLSTM_T,
                           pred_gb=XLSTM_PRED_GB, label="13a",
                           prepare=slstm_fan_in, profile=False))
    trained["launches"] = {k: ops.LAUNCHES[k] for k in no_grad_kernels}
    log(json.dumps({"xlstm_train_path": trained}))
    log(f"  phase 13a s: {time.perf_counter() - t0:.1f}")
    t1 = time.perf_counter()
    parity = main_path_launches("step parity (13b)", (),
                                lambda: arch_parity_path(dev))
    parity["launches"] = {k: ops.LAUNCHES[k] for k in no_grad_kernels}
    log(json.dumps({"arch_parity_path": parity}))
    log(f"  phase 13b s: {time.perf_counter() - t1:.1f}")
    for what, got in (("13a", trained), ("13b", parity)):
        if any(got["launches"].values()):
            raise AssertionError(f"{what}: a forward-only kernel launched "
                                 f"under autograd: {got['launches']}")

    t1 = time.perf_counter()
    ctx = serve_setup(dev, XLSTM_ARCH)
    slstm_fan_in(ctx["params"], ctx["cfg"])
    serving = main_path_launches("xlstm-125m serving path (13c)", (),
                                 lambda: serve_main(dev, ctx))
    fns, checks = xlstm_checks(dev, ctx)
    cost = slstm_cost(dev, ctx, fns["prefill"])
    log(json.dumps({"xlstm_serve_path": {**serving, **checks,
                                         "slstm": cost}}))
    # the profile of a prefill of CONSIST_T tokens (a whole prompt's
    # 1e5 launches would take the profiler minutes) and of a decode step
    prof = [_profiled(f"{XLSTM_ARCH} {name}", {name: fn}, reps=1)
            for name, fn in (("prefill_256", fns["short_prefill"]),
                             ("decode_step", fns["decode_step"]))]
    for p in prof:
        p.update(breakdown(p))
    log(json.dumps({"profile": prof}))
    del fns, ctx
    release()
    log(f"  phase 13c s: {time.perf_counter() - t1:.1f}")

    t1 = time.perf_counter()
    bf = torch.bfloat16
    cases = [flash_case(dev, "vision cross bf16 B4 H32/8 T2048 S1600 hd128",
                        bf, 4, 32, 8, 2048, 1600, 128, False, None),
             flash_case(dev, "vision cross decode bf16 B4 H32/8 T1 S1600",
                        bf, 4, 32, 8, 1, 1600, 128, False, None)]
    log(json.dumps({"flash_kernels": cases}))
    release()
    ctx = vision_setup(dev)
    serving = main_path_launches("llama-3.2-vision-11b serving path (13d)",
                                 ("flash_attention",),
                                 lambda: vision_serve(dev, ctx))
    fns, checks = vision_checks(dev, ctx)
    log(json.dumps({"vision_serve_path": {**serving, **checks}}))
    prof = [_profiled(f"{VLM_ARCH} {name}", {name: fn}, reps=2)
            for name, fn in fns.items()]
    for p in prof:
        p.update(breakdown(p))
    log(json.dumps({"profile": prof}))
    del fns, ctx
    release()
    log(f"  phase 13d s: {time.perf_counter() - t1:.1f}")

    t1 = time.perf_counter()
    k8_lines = {"stablelm-3b": (
        "stablelm-3b prefill bf16 B4 H32/32 T2048 hd80", 32, 32, 80),
        "llama3-405b": (
        "llama3-405b prefill bf16 B4 H128/8 T2048 hd128", 128, 8, 128)}
    for arch, layers in ARCHS_13E:
        if arch in k8_lines:
            label, H, Hkv, hd = k8_lines[arch]
            case = flash_case(dev, label, bf, 4, H, Hkv, 2048, 2048, hd,
                              True, None)
            log(json.dumps({"flash_kernels": [case]}))
        release()
        ctx = arch_setup(dev, arch, layers)
        served = main_path_launches(f"{arch} serving path (13e)",
                                    ("flash_attention",),
                                    lambda: arch_main(dev, ctx))
        checks = arch_checks(dev, ctx)
        log(json.dumps({"arch_serve_path": {**served, **checks}}))
        del ctx
        release()
    log(f"  phase 13e s: {time.perf_counter() - t1:.1f}")


# ---------------------------------------------------------------- phase 14

def _granite_fp32():
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig

    return (get_config(TRAIN_ARCH).with_(dtype="float32"),
            AdamWConfig(lr=TRAIN_LR))


def _seed_batch(cfg, batch_size: int, seq: int, dev) -> dict:
    rng = np.random.default_rng(SEED)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (batch_size, seq))
                                .astype(np.int32)).to(dev)
            for k in ("tokens", "labels")}


def _run_steps(step_fn, state, batch: dict, n: int):
    """``n`` steps on ``batch``; each step's loss and gradient norm and its
    host-clock time, the step ending in a synchronise."""
    metrics, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return state, metrics, ms


def remat_path(dev) -> dict:
    """Phase 14a: granite-3-2b's train step under each remat at REMAT_B x
    REMAT_T from the seed's weights, then "full" at REMAT_BIG_B."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.train import init_train_state, make_train_step

    base, opt = _granite_fp32()
    runs = [(m, REMAT_B) for m in REMAT_MODES] + [("full", REMAT_BIG_B)]
    rows = {}
    for mode, batch_size in runs:
        cfg = base.with_(remat=mode)
        release()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                                 opt, dev)
        state_bytes = torch.cuda.memory_allocated()
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        batch = _seed_batch(cfg, batch_size, REMAT_T, dev)
        state, metrics, ms = _run_steps(make_train_step(cfg, opt), state,
                                        batch, REMAT_STEPS)
        label = f"{mode}@{batch_size}x{REMAT_T}"
        rows[label] = {
            "remat": mode, "batch": batch_size, "seq": REMAT_T,
            "params": n_params, "state_bytes": state_bytes,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "first": metrics[0], "step_ms": ms,
            "median_step_ms_after_first": float(np.median(ms[1:]))}
        r = rows[label]
        over = (r["peak_allocated_bytes"] - state_bytes) / 1e9
        log(f"  14a remat {label}: peak {r['peak_allocated_bytes'] / 1e9:.2f} "
            f"GB allocated ({over:.2f} GB over params + mu + nu "
            f"{state_bytes / 1e9:.2f} GB), "
            f"{r['median_step_ms_after_first']:.1f} ms a step (median after "
            f"the first), first step loss {metrics[0]['loss']:.7f} grad norm "
            f"{metrics[0]['grad_norm']:.7f}")
        del state
    none = rows[f"none@{REMAT_B}x{REMAT_T}"]
    # what none would hold at the big batch: the state, the gradients (one
    # fp32 copy of the parameters) and its activations grown linearly
    grads = 4 * none["params"]
    per_seq = (none["peak_allocated_bytes"] - none["state_bytes"]
               - grads) / REMAT_B
    need = none["state_bytes"] + grads + per_seq * REMAT_BIG_B
    card = torch.cuda.get_device_properties(dev).total_memory
    big = rows[f"full@{REMAT_BIG_B}x{REMAT_T}"]
    big["none_would_need_bytes"] = need
    log(f"  14a none at {REMAT_BIG_B} x {REMAT_T} would need {need / 1e9:.1f} "
        f"GB ({per_seq / 1e9:.2f} GB of activations a sequence over the "
        f"state and the gradients) of the card's {card / 1e9:.1f} GB; full "
        f"holds it in {big['peak_allocated_bytes'] / 1e9:.2f} GB")
    if need <= card:
        raise AssertionError(f"14a: none would hold {REMAT_BIG_B} x "
                             f"{REMAT_T} ({need / 1e9:.1f} GB): pick a "
                             f"larger batch")
    for mode in ("full", "dots"):
        r = rows[f"{mode}@{REMAT_B}x{REMAT_T}"]
        r["rel_to_none"] = {k: abs(r["first"][k] - none["first"][k])
                            / abs(none["first"][k])
                            for k in ("loss", "grad_norm")}
        r["bitwise_to_none"] = r["first"] == none["first"]
        r["time_vs_none"] = (r["median_step_ms_after_first"]
                             / none["median_step_ms_after_first"])
        r["peak_vs_none"] = (r["peak_allocated_bytes"]
                             / none["peak_allocated_bytes"])
        rel = r["rel_to_none"]
        log(f"  14a {mode} against none: loss rel {rel['loss']:.2e}, grad "
            f"norm rel {rel['grad_norm']:.2e} "
            f"(limit {REMAT_RTOL}; bitwise: {r['bitwise_to_none']}); step "
            f"time x{r['time_vs_none']:.3f}, peak x{r['peak_vs_none']:.3f}")
        if max(r["rel_to_none"].values()) > REMAT_RTOL:
            raise AssertionError(f"14a: remat {mode} changes the step: "
                                 f"{r['rel_to_none']}")
    return rows


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _rel_on_device(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.to(a.device).double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def sharded_step_path(dev, full_ms: float) -> dict:
    """Phase 14b: granite-3-2b's steps on a (1, 1) CUDA DeviceMesh of a
    one-rank NCCL group under SHARDED_VARIANT, against the same steps
    unsharded; ms per step against 14a's ``full`` (``full_ms``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.sharding import distribute, tree_param_specs
    from repro_torch.launch.specs import apply_variant, train_state_specs
    from repro_torch.train import init_train_state, make_train_step

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        base, opt = _granite_fp32()
        cfg, knobs = apply_variant(base, SHARDED_VARIANT, mesh)
        batch = _seed_batch(cfg, REMAT_B, REMAT_T, dev)
        release()
        state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                                 opt, dev)
        state, um, ums = _run_steps(make_train_step(cfg, opt), state, batch,
                                    SHARDED_STEPS)
        want = {"param": [t.cpu() for t in tree_leaves(state.params)],
                "mu": [t.cpu() for t in tree_leaves(state.opt["mu"])]}
        del state
        release()
        state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                                 opt, dev)
        specs = train_state_specs(state, mesh, knobs)
        state = distribute(state, specs, mesh)
        release()
        step = make_train_step(
            cfg, opt, accum_dtype=knobs["accum_dtype"],
            grad_specs=tree_param_specs(state.params, mesh)
            if knobs["grad_constrain"] else None)
        state, sm, sms = _run_steps(step, state, batch, SHARDED_STEPS)
        err = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(sm, um))
               for k in ("loss", "grad_norm")}
        for name, got in (("param", state.params), ("mu", state.opt["mu"])):
            err[name] = max(_rel_on_device(t.to_local(), w) for t, w in
                            zip(tree_leaves(got), want[name]))
        del state, want
        limit = {"loss": PARITY_LOSS_RTOL, "grad_norm": PARITY_LOSS_RTOL,
                 "param": PARITY_PARAM_RTOL, "mu": PARITY_PARAM_RTOL}
        out = {"variant": SHARDED_VARIANT, "mesh": [1, 1],
               "steps": SHARDED_STEPS, "batch": REMAT_B, "seq": REMAT_T,
               "unsharded": um, "sharded": sm, "errors": err,
               "limits": limit, "unsharded_step_ms": ums,
               "sharded_step_ms": sms,
               "sharded_ms": float(np.median(sms[1:])),
               "unsharded_ms": float(np.median(ums[1:])),
               "full_ms_14a": full_ms}
        out["dispatch_ms"] = out["sharded_ms"] - out["unsharded_ms"]
        log(f"  14b {SHARDED_VARIANT} on a (1, 1) mesh: {SHARDED_STEPS} steps, "
            f"errors {err} (limits {limit}); {out['sharded_ms']:.1f} ms a "
            f"step sharded (first {sms[0]:.0f} ms), {out['unsharded_ms']:.1f}"
            f" ms unsharded, 14a full {full_ms:.1f} ms: DTensor's dispatch "
            f"{out['dispatch_ms']:.1f} ms a step (placements on size-1 mesh "
            f"dims move no bytes)")
        if not all(err[k] <= v for k, v in limit.items()):
            raise AssertionError(f"14b: the sharded step differs from the "
                                 f"unsharded one: {err}")
        return out
    finally:
        dist.destroy_process_group()


def sharding_phase(dev, main_path_launches) -> None:
    """Phase 14: remat at full width (14a) and the sharded step on a (1, 1)
    CUDA mesh (14b); neither may launch a forward-only kernel."""
    from repro_torch.kernels.ragged_gather import ops

    no_grad_kernels = ("ragged_gather", "flash_attention", "rglru_scan")
    t0 = time.perf_counter()
    rows = main_path_launches("remat (14a)", (), lambda: remat_path(dev))
    launched = {k: ops.LAUNCHES[k] for k in no_grad_kernels}
    log(json.dumps({"remat_path": rows, "launches": launched}))
    log(f"  phase 14a s: {time.perf_counter() - t0:.1f}")
    t1 = time.perf_counter()
    full_ms = rows[f"full@{REMAT_B}x{REMAT_T}"]["median_step_ms_after_first"]
    sharded = main_path_launches("sharded step (14b)", (),
                                 lambda: sharded_step_path(dev, full_ms))
    sharded["launches"] = {k: ops.LAUNCHES[k] for k in no_grad_kernels}
    log(json.dumps({"sharded_step_path": sharded}))
    log(f"  phase 14b s: {time.perf_counter() - t1:.1f}")
    for what, got in (("14a", launched), ("14b", sharded["launches"])):
        if any(got.values()):
            raise AssertionError(f"{what}: a forward-only kernel launched "
                                 f"under autograd: {got}")


def _timed(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _serve_run(dev, cfg, params, cache, toks, put, feed=None) -> dict:
    """A prefill of ``toks`` (run twice, the second timed warm) and
    SHARDED_SERVE_STEPS decode steps through the step builders, greedy
    (``feed`` None) or fed ``feed``'s tokens; each step's logits on this
    rank, the tokens fed, host ms a step (synchronised) and K8's and K9's
    launches in one prefill and in decode."""
    from repro_torch.core.dtensor import local
    from repro_torch.kernels import backend
    from repro_torch.train import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    kernels = ("flash_attention", "rglru_scan")
    before = {k: backend.LAUNCHES[k] for k in kernels}
    (logits, cache), first_ms = _timed(
        lambda: prefill(params, put({"tokens": toks}), cache), dev)
    launched = {"prefill": {k: backend.LAUNCHES[k] - before[k]
                            for k in kernels}}
    # again, warm: a prefill writes the same slots and states anew
    (logits, cache), prefill_ms = _timed(
        lambda: prefill(params, put({"tokens": toks}), cache), dev)
    before = {k: backend.LAUNCHES[k] for k in kernels}
    out = {"logits": [local(logits)], "fed": [], "decode_ms": [],
           "prefill_ms": prefill_ms, "first_prefill_ms": first_ms}
    for i in range(SHARDED_SERVE_STEPS):
        nxt = feed[i] if feed is not None else \
            out["logits"][-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out["fed"].append(nxt)
        (logits, cache), ms = _timed(
            lambda: decode(params, cache, put({"tokens": nxt})), dev)
        out["logits"].append(local(logits))
        out["decode_ms"].append(ms)
    launched["decode"] = {k: backend.LAUNCHES[k] - before[k]
                          for k in kernels}
    out["launched"] = launched
    return out


def sharded_serve_path(dev) -> dict:
    """Phase 15a: phase 7's yi-6b and phase 8's recurrentgemma-2b, their
    first batch prefilled and decoded through ``make_prefill_step`` /
    ``make_decode_step`` on a DTensor state on a (1, 1) CUDA DeviceMesh
    (parameters by ``tree_param_specs``, cache and tokens by
    ``tree_auto_specs``), against the same steps unsharded: logits bit
    for bit, K8 and K9 launched as often, and the host ms of a prefill
    and of a decode step in each (DTensor's serving dispatch)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import mesh_context
    from repro_torch.launch.sharding import (distribute, tree_auto_specs,
                                             tree_param_specs)
    from repro_torch.models.transformer import init_cache

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    rows = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for arch, prompt in ((SERVE_ARCH, SERVE_PROMPT), (RG_ARCH, RG_PROMPT)):
            release()
            ctx = serve_setup(dev, arch, prompt)
            cfg, params = ctx.pop("cfg"), ctx.pop("params")
            toks = first_batch(ctx["queue"], dev)
            length = toks.shape[1] + SHARDED_SERVE_STEPS
            want = _serve_run(dev, cfg, params, init_cache(
                cfg, toks.shape[0], length, dev), toks, lambda b: b)
            p_specs = tree_param_specs(params, mesh)
            sp = distribute(params, p_specs, mesh)
            del params
            release()
            cache = init_cache(cfg, toks.shape[0], length, dev)
            sc = distribute(cache, tree_auto_specs(cache, mesh, 0), mesh)
            del cache
            with mesh_context(mesh):
                got = _serve_run(dev, cfg, sp, sc, toks, lambda b: distribute(
                    b, tree_auto_specs(b, mesh, batch_dim=0), mesh),
                    feed=want["fed"])
            del sp, sc
            bitwise = all(torch.equal(a, b) for a, b in
                          zip(got["logits"], want["logits"]))
            errs = [_rel(a.float(), b.float())
                    for a, b in zip(got["logits"], want["logits"])]
            row = {"arch": arch, "batch": list(toks.shape),
                   "decode_steps": SHARDED_SERVE_STEPS, "bitwise": bitwise,
                   "worst_rel": max(errs), "limit": SERVE_TOL,
                   "launches_sharded": got["launched"],
                   "launches_unsharded": want["launched"],
                   "prefill_ms_sharded": got["prefill_ms"],
                   "prefill_ms_unsharded": want["prefill_ms"],
                   "first_prefill_ms_sharded": got["first_prefill_ms"],
                   "first_prefill_ms_unsharded": want["first_prefill_ms"],
                   "decode_ms_sharded": float(np.median(got["decode_ms"])),
                   "decode_ms_unsharded": float(np.median(
                       want["decode_ms"]))}
            rows[arch] = row
            log(f"  15a {arch} on a (1, 1) mesh: prefill of "
                f"{tuple(toks.shape)} + {SHARDED_SERVE_STEPS} decode steps, "
                f"logits {'bitwise' if bitwise else 'NOT bitwise'} (worst "
                f"rel {max(errs):.3e}); launches sharded {got['launched']}, "
                f"unsharded {want['launched']}; prefill ms (warm) "
                f"{got['prefill_ms']:.1f} sharded, {want['prefill_ms']:.1f} "
                f"unsharded (first {got['first_prefill_ms']:.1f} / "
                f"{want['first_prefill_ms']:.1f}); decode ms a step {row['decode_ms_sharded']:.2f} "
                f"sharded, {row['decode_ms_unsharded']:.2f} unsharded "
                f"(DTensor's serving dispatch; placements on size-1 mesh "
                f"dims move no bytes)")
            if got["launched"] != want["launched"]:
                raise AssertionError(f"15a {arch}: K8/K9 launched "
                                     f"{got['launched']} sharded, "
                                     f"{want['launched']} unsharded")
            if not bitwise and max(errs) > SERVE_TOL:
                raise AssertionError(f"15a {arch}: sharded logits differ: "
                                     f"{errs}")
        return rows
    finally:
        dist.destroy_process_group()


def dryrun_card_path(dev) -> dict:
    """Phase 15b: ``analysis.flow`` on meta tensors for yi-6b's prefill of
    phase 7's first batch and one decode step, then the same steps on the
    card under ``FlopCounterMode``: the dot FLOPs must be equal; the meta
    estimate of the peak bytes beyond the arguments beside the card's
    rise of ``max_memory_allocated`` over them (reported, not gated)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.flow import trace_step
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.train import make_decode_step, make_prefill_step

    ctx = serve_setup(dev, SERVE_ARCH, SERVE_PROMPT)
    cfg, params = ctx["cfg"], ctx["params"]
    toks = first_batch(ctx["queue"], dev)
    B, plen = toks.shape
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    pm = init_params(cfg, None, device="meta")
    tm = torch.empty((B, plen), dtype=toks.dtype, device="meta")
    t0 = time.perf_counter()
    _, mp = trace_step(prefill, pm, {"tokens": tm},
                       init_cache(cfg, B, plen + 1, device="meta"))
    _, md = trace_step(decode, pm, init_cache(cfg, B, plen + 1,
                                              device="meta"),
                       {"tokens": tm[:, :1]})
    meta_s = time.perf_counter() - t0
    cache = init_cache(cfg, B, plen + 1, dev)
    rows = {}
    for name, meta, fn in (
            ("prefill", mp, lambda: prefill(params, {"tokens": toks},
                                            cache)),
            ("decode", md, lambda: decode(params, cache,
                                          {"tokens": nxt}))):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with FlopCounterMode(display=False) as fc:
            logits, cache = fn()
        torch.cuda.synchronize(dev)
        rise = torch.cuda.max_memory_allocated(dev) - base
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        rows[name] = {"meta_dot_flops": meta.flow.dot_flops,
                      "card_dot_flops": fc.get_total_flops(),
                      "meta_peak_bytes": meta.peak_bytes,
                      "card_peak_rise_bytes": rise,
                      "peak_ratio": meta.peak_bytes / max(rise, 1),
                      "meta_traffic_bytes": meta.flow.traffic_bytes}
        log(f"  15b {SERVE_ARCH} {name} {tuple(toks.shape)}: dot FLOPs "
            f"{meta.flow.dot_flops:.6e} on meta, {fc.get_total_flops():.6e} "
            f"on the card; peak beyond the arguments {meta.peak_bytes} B "
            f"estimated on meta, {rise} B risen on the card (ratio "
            f"{rows[name]['peak_ratio']:.3f})")
        if int(meta.flow.dot_flops) != fc.get_total_flops():
            raise AssertionError(f"15b {name}: the meta FLOPs "
                                 f"{meta.flow.dot_flops} are not the card's "
                                 f"{fc.get_total_flops()}")
    rows["meta_s"] = meta_s
    return rows


def sharded_serving_phase(dev, main_path_launches) -> None:
    """Phase 15: the serving steps on a DTensor state (15a) and the
    dry-run's analysis held to the card (15b)."""
    t0 = time.perf_counter()
    rows = main_path_launches("sharded serving (15a)",
                              ("flash_attention", "rglru_scan"),
                              lambda: sharded_serve_path(dev))
    log(json.dumps({"sharded_serve_path": rows}))
    log(f"  phase 15a s: {time.perf_counter() - t0:.1f}")
    release()
    t1 = time.perf_counter()
    log(json.dumps({"dryrun_card_path": dryrun_card_path(dev)}))
    log(f"  phase 15b s: {time.perf_counter() - t1:.1f}")


def breakdown(p: dict) -> dict:
    """A profile's device time split into K8, K9, the GEMMs and the rest."""
    by = p["device_ms_per_round"]
    k8 = sum(ms for k, ms in by.items() if "flash_fwd" in k)
    k9 = sum(ms for k, ms in by.items() if any(
        w in k for w in ("chained_scan_kernel", "rescan_kernel",
                         "chunk_summary_kernel")))
    gemm = sum(ms for k, ms in by.items()
               if any(w in k.lower() for w in ("gemm", "nvjet", "cutlass",
                                               "xmma")))
    busy = p["busy_ms_per_round"] or float("nan")
    rest = busy - k8 - k9 - gemm
    log(f"  {p['case']}: K8 {k8:.3f} ms ({100 * k8 / busy:.1f} %), K9 "
        f"{k9:.3f} ms ({100 * k9 / busy:.1f} %), GEMMs {gemm:.3f} ms "
        f"({100 * gemm / busy:.1f} %), the rest {rest:.3f} ms "
        f"({100 * rest / busy:.1f} %) of {busy:.3f} ms busy")
    return {"k8_ms": k8, "k9_ms": k9, "gemm_ms": gemm, "rest_ms": rest}


def _tensors(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tensors(v, path + (i,))
    else:
        yield path, tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch as rt
    from repro_torch.core.distributions import block_sizes
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ragged_gather import kernel, ops
    from repro_torch.kernels.rg_lru import kernel as rglru_kernel

    t_script = time.perf_counter()
    watch = Watchdog()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    watch.start(1, "device")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:   # one nvcc per source, together
        for lib in [pool.submit(kernel.library),
                    pool.submit(kernel.reduce_library),
                    pool.submit(kernel.pack_library),
                    pool.submit(flash_kernel.library),
                    pool.submit(rglru_kernel.library)]:
            lib.result()
    log(f"kernel build + load s: {time.perf_counter() - t0:.2f}")
    for lib in ("slab", "slab_reduce", "pack", "flash", "rglru"):
        for line in _build.BUILD_LOG.get(lib, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas ({lib}):", line.strip())
    # K8's Hopper kernel (TMA, wgmma) at hd 64, 128, 256: no spills
    wgmma = {k: v for k, v in ptxas_report(_build.BUILD_LOG["flash"]).items()
             if "flash_fwd_bf16_wgmma" in k}
    serialised = [line for line in _build.BUILD_LOG["flash"].splitlines()
                  if "C7513" in line]
    for k, v in sorted(wgmma.items()):
        hd = k.split("flash_fwd_bf16_wgmmaILi")[1].split("E")[0]
        log(f"  K8 flash_fwd_bf16_wgmma<{hd}>: {v.get('registers')} registers "
            f"at entry, {v.get('spill_stores')} bytes spill stores, "
            f"{v.get('spill_loads')} bytes spill loads, products serialised "
            f"by ptxas: {'yes' if any(k in x for x in serialised) else 'no'}")
    if len(wgmma) != 3 or any(v.get("spill_stores") or v.get("spill_loads")
                              or v.get("stack") for v in wgmma.values()):
        raise AssertionError(f"K8's wgmma kernels spill or are missing from "
                             f"the build log: {wgmma}")
    # K8's mma.sync kernel at hd 80 (stablelm-3b's head dim): present and
    # no spills
    mma80 = {k: v for k, v in ptxas_report(_build.BUILD_LOG["flash"]).items()
             if "flash_fwd_bf16ILi80E" in k}
    for k, v in mma80.items():
        log(f"  K8 flash_fwd_bf16<80> (mma.sync): {v.get('registers')} "
            f"registers, {v.get('spill_stores')} bytes spill stores, "
            f"{v.get('spill_loads')} bytes spill loads")
    if len(mma80) != 1 or any(v.get("spill_stores") or v.get("spill_loads")
                              for v in mma80.values()):
        raise AssertionError(f"K8's hd-80 kernel spills or is missing from "
                             f"the build log: {mma80}")
    # K1's and K6's bulk-copy kernels (K6: whole rows a stage, and pieces
    # of rows wider than a stage): present and no spills
    bulk = {**{k: v for k, v in ptxas_report(_build.BUILD_LOG["slab"]).items()
               if "slab_extract_kernel" in k},
            **{k: v for k, v in ptxas_report(_build.BUILD_LOG["pack"]).items()
               if "ragged_gather_bulk_kernel" in k}}
    for k, v in sorted(bulk.items()):
        log(f"  bulk copy {k}: {v.get('registers')} registers, "
            f"{v.get('spill_stores')} bytes spill stores, "
            f"{v.get('spill_loads')} bytes spill loads")
    if len(bulk) != 3 or any(v.get("spill_stores") or v.get("spill_loads")
                             for v in bulk.values()):
        raise AssertionError(f"K1's or K6's bulk kernels spill or are missing "
                             f"from the build log: {bulk}")
    # K9's single pass (bulk copies, decoupled look-back): present and no
    # spills
    chained = {k: v for k, v in ptxas_report(_build.BUILD_LOG["rglru"]).items()
               if "chained_scan_kernel" in k}
    for k, v in chained.items():
        log(f"  K9 single pass {k}: {v.get('registers')} registers, "
            f"{v.get('spill_stores')} bytes spill stores, "
            f"{v.get('spill_loads')} bytes spill loads")
    if len(chained) != 1 or any(v.get("spill_stores") or v.get("spill_loads")
                                for v in chained.values()):
        raise AssertionError(f"K9's single pass spills or is missing from "
                             f"the build log: {chained}")

    watch.start(2, "kernels vs plain (bitwise)")
    spikes = rt.plan_gatherv(block_sizes("spikes", P, B, seed=SEED), 0)
    record: dict = {}
    kernel_phase(dev, spikes, torch.float32, F, record)
    kernel_phase(dev, spikes, torch.bfloat16, 2 * F, None)
    spikes_rs = rt.plan_reduce_scatterv(block_sizes("spikes", P, B, seed=SEED))
    reduce_kernel_phase(dev, spikes_rs, torch.float32, F, record)
    reduce_kernel_phase(dev, spikes_rs, torch.bfloat16, 2 * F, None)
    reduce_kernel_phase(dev, spikes_rs, torch.int32, F, None)

    launches = {k: 0 for k in REPLACES}

    def main_path_launches(label: str, kernels, run):
        """Run a main path with the counts set to 0 just before it and
        read just after; each of ``kernels`` must have launched."""
        ops.reset_launches()
        out = run()
        counted = dict(ops.LAUNCHES)
        log(f"launches on the {label}: {counted}")
        for name in kernels:
            if counted[name] <= 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{label}")
        for name, n in counted.items():
            launches[name] += n
        return out

    watch.start(3, "gatherv/scatterv path (LocalMesh(16), bitwise)")
    rows = main_path_launches("gatherv path",
                              ("slab_extract", "slab_merge", "slab_step"),
                              lambda: main_path(dev))
    log(json.dumps({"main_path": rows}))

    watch.start(4, "where the time goes (torch.profiler)")
    prof = [profile_phase(dev, "spikes", 0, 1), profile_phase(dev, "same", 0, 4),
            profile_reduce_phase(dev, "spikes", 1)]
    log(json.dumps({"profile": prof}))

    watch.start(5, "reduction and composed path (LocalMesh(16), bitwise)")
    rows = main_path_launches("reduction and composed path",
                              ("slab_extract", "slab_merge", "slab_step",
                               "slab_merge_add", "slab_step_reduce"),
                              lambda: reduce_composed_path(dev))
    log(json.dumps({"reduce_composed_path": rows}))

    watch.start(6, "MoE path (Mixtral-8x7B MoE layer, expert exchange on "
        "LocalMesh(8))")
    torch.backends.cuda.matmul.allow_tf32 = False    # the fp32 recomputation
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, layer, x, r = moe_setup(dev)
    log(f"  weights and batch made in {time.perf_counter() - t0:.2f} s "
        f"({sum(b.numel() * b.element_size() for b in layer.buffers())} "
        f"bytes of weights)")
    cases = pack_kernel_phase(dev, x, r, record)
    log(json.dumps({"pack_kernels": cases}))
    fns, moe = main_path_launches("MoE path",
                                  ("slab_extract", "slab_merge", "slab_step",
                                   "ragged_gather", "ragged_scatter"),
                                  lambda: moe_path(dev, layer, x, r))
    log(json.dumps({"moe_path": moe}))
    log(json.dumps({"profile": [_profiled("MoE layer and exchange", fns)]}))
    del layer, x, r, fns
    torch.cuda.empty_cache()

    watch.start(7, "serving path (yi-6b, full width and depth, bf16, "
        "prefill attention on K8)")
    t0 = time.perf_counter()
    cases = flash_kernel_phase(dev, record)
    log(json.dumps({"flash_kernels": cases}))
    log(f"  phase 7a s: {time.perf_counter() - t0:.1f}")
    ctx = serve_setup(dev)
    serving = main_path_launches("serving path", ("flash_attention",),
                                 lambda: serve_main(dev, ctx))
    fns, checks = serve_checks(dev, ctx)
    log(json.dumps({"serve_path": {**serving, **checks}}))
    # phase 11b serves yi-6b again on these weights and this queue
    yi = {k: ctx[k] for k in ("cfg", "params", "queue", "tokens")}
    prof = [_profiled(f"yi-6b {name}", {name: fn}, reps=2)
            for name, fn in fns.items()]
    for p in prof:
        p.update(breakdown(p))
    log(json.dumps({"profile": prof}))
    del fns, ctx
    torch.cuda.empty_cache()
    log(f"  phase 7 s: {time.perf_counter() - t0:.1f}")

    watch.start(8, "serving path (recurrentgemma-2b, full width and depth, "
        "bf16, RG-LRU scan on K9, local attention on K8)")
    t0 = time.perf_counter()
    ctx = serve_setup(dev, RG_ARCH, RG_PROMPT)
    cases = rglru_kernel_phase(dev, ctx, record)
    log(json.dumps({"rglru_kernels": cases}))
    log(f"  phase 8a s: {time.perf_counter() - t0:.1f}")
    serving = main_path_launches("recurrentgemma-2b serving path",
                                 ("flash_attention", "rglru_scan"),
                                 lambda: serve_main(dev, ctx))
    fns, checks = rg_checks(dev, ctx)
    log(json.dumps({"serve_path": {**serving, **checks}}))
    prof = [_profiled(f"{RG_ARCH} {name}", {name: fn}, reps=2)
            for name, fn in fns.items()]
    for p in prof:
        p.update(breakdown(p))
    log(json.dumps({"profile": prof}))
    del fns, ctx
    torch.cuda.empty_cache()
    log(f"  phase 8 s: {time.perf_counter() - t0:.1f}")

    watch.start(9, "the paper's trees on the card (LocalMesh(16), bitwise, "
        "traced)")
    t0 = time.perf_counter()
    zoo = main_path_launches("paper's trees",
                             ("slab_extract", "slab_merge", "slab_step"),
                             lambda: zoo_path(dev))
    log(json.dumps({"zoo_path": zoo}))
    log(f"  phase 9 s: {time.perf_counter() - t0:.1f}")

    watch.start(10, "the tuner on the card (LocalMesh(16, hosts=4): host "
        "split, metadata exchange, calibration, raced candidates, bitwise)")
    t0 = time.perf_counter()
    tuned = main_path_launches("tuner's races",
                               ("slab_extract", "slab_merge", "slab_step",
                                "slab_merge_add", "slab_step_reduce"),
                               lambda: tuner_path(dev))
    log(json.dumps({"tuner_path": tuned}))
    log(f"  phase 10 s: {time.perf_counter() - t0:.1f}")

    watch.start(11, "the planner service and the serving planner on the "
        "card (captured per-plan executors, bitwise)")
    from repro_torch import tuner as tt

    t0 = time.perf_counter()
    cal = tt.Calibration(**tuned["calibration"])
    served = main_path_launches("planner service",
                                ("slab_extract", "slab_merge", "slab_step",
                                 "slab_merge_add", "slab_step_reduce"),
                                lambda: service_path(dev, cal))
    log(json.dumps({"service_path": served}))
    log(f"  phase 11a s: {time.perf_counter() - t0:.1f}")
    planned = main_path_launches("serving planner",
                                 ("flash_attention", "slab_extract",
                                  "slab_merge", "slab_step", "slab_merge_add",
                                  "slab_step_reduce"),
                                 lambda: serving_planner_path(dev, cal, yi))
    log(json.dumps({"serving_planner_path": planned}))
    del yi
    torch.cuda.empty_cache()
    capture_failure_raises(dev)
    log(f"  phase 11 s: {time.perf_counter() - t0:.1f}")

    watch.start(12, "the training path on the card (granite-3-2b in fp32 "
        "through launch/train, step parity and restart, the fault runtime)")
    torch.backends.cuda.matmul.allow_tf32 = False   # torch's default
    log(f"  TF32 off (matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()}): the card computes the "
        f"reference's fp32 function")
    no_grad_kernels = ("ragged_gather", "flash_attention", "rglru_scan")
    t0 = time.perf_counter()
    trained = main_path_launches("training path (12a)", (),
                                 lambda: train_path(dev))
    trained["launches"] = {k: ops.LAUNCHES[k] for k in no_grad_kernels}
    log(json.dumps({"train_path": trained}))
    log(f"  phase 12a s: {time.perf_counter() - t0:.1f}")
    t1 = time.perf_counter()
    parity = main_path_launches("step parity and restart (12b)", (),
                                lambda: parity_restart_path(dev))
    parity["launches"] = {k: ops.LAUNCHES[k] for k in no_grad_kernels}
    log(json.dumps({"parity_restart_path": parity}))
    log(f"  phase 12b s: {time.perf_counter() - t1:.1f}")
    for what, got in (("12a", trained), ("12b", parity)):
        if any(got["launches"].values()):
            raise AssertionError(f"{what}: a forward-only kernel launched "
                                 f"under autograd: {got['launches']}")
    t1 = time.perf_counter()
    faults = main_path_launches("fault runtime (12c)", SERVICE_KERNELS,
                                lambda: fault_runtime_path(dev))
    faults["launches"] = {k: ops.LAUNCHES[k] for k in SERVICE_KERNELS}
    log(json.dumps({"fault_runtime_path": faults}))
    log(f"  phase 12c s: {time.perf_counter() - t1:.1f}")
    log(f"  phase 12 s: {time.perf_counter() - t0:.1f}")

    watch.start(13, "the rest of the model zoo (xlstm-125m trained and "
                "served, llama-3.2-vision-11b served with cross-attention "
                "on K8, stablelm-3b, musicgen-large, llama3-405b)")
    t0 = time.perf_counter()
    model_zoo_phase(dev, main_path_launches)
    log(f"  phase 13 s: {time.perf_counter() - t0:.1f}")

    watch.start(14, "the sharding layer (granite-3-2b's step under each "
                "remat, and on a (1, 1) CUDA DeviceMesh)")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    sharding_phase(dev, main_path_launches)
    log(f"  phase 14 s: {time.perf_counter() - t0:.1f}")

    watch.start(15, "the serving cells executed sharded (yi-6b and "
                "recurrentgemma-2b on a (1, 1) CUDA DeviceMesh) and the "
                "dry-run's analysis held to the card")
    t0 = time.perf_counter()
    sharded_serving_phase(dev, main_path_launches)
    log(f"  phase 15 s: {time.perf_counter() - t0:.1f}")
    watch.stop()
    for name, n in launches.items():
        record[name]["launches"] = n

    log(f"script s: {time.perf_counter() - t_script:.1f}")
    log(card)
    log(json.dumps({"kernels": [record[k] for k in REPLACES]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
