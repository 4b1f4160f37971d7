"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only K         # the build and phase K alone
    python3 chip_smoke.py --only V         # the build, path M, serve M, V
    python3 chip_smoke.py --only D         # the build and phase D alone
    python3 chip_smoke.py --only C         # the build, phases C2 and C3
    python3 chip_smoke.py --only Z         # the build, paths L, B, A, G, N,
                                           # each served


Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, and the build of every hand-written kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, started together),
   then one line a library with each kernel's registers, spills and static
   shared memory (``ptxas -v``); the RMSNorm and RG-LRU kernels must not
   spill;
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes (path H's: flash at (2, 2048, 10 / 1 heads, 256) f32 and
   bf16, RMSNorm at (4096, 2560) and (2, 2560) f32, RG-LRU from a nonzero
   state; path E's: flash at (2, 2048, 16 / 16 heads, 128) f32, RMSNorm at
   (4096, 2048) and (2, 2048) f32 on the generic loop; path X's: flash at
   (2, 448, 12 / 12 heads, 64) causal f32, RMSNorm at (3000, 768), (896,
   768) and (2, 768) f32 on the generic loop, and flash at the encoder's
   and the cross-attention's non-causal shapes, (2, 1500 / 448 queries,
   1500 keys, 12 heads of 64) in f32 and bf16, which no path binds yet;
   phase P's: flash at (1, 4, 1 / 1 head, 128) causal, RMSNorm at (64,
   1024), RG-LRU at (1, 64, 2560) from a nonzero state, all f32; phase
   K's: flash at (1, 2048, 1 / 1 head, 128) causal and RMSNorm at (2048,
   1024), f32; path L's flash at (1, 4096, 32 / 8 heads, 128), path A's
   at (2, 2048, 40 / 8 heads, 128), path G's at (2, 2048, 16 / 16 heads,
   256) and path N's at (2, 2048, 32 / 4 heads, 64), causal f32; path G's
   RMSNorm at (4096, 3072) and (2, 3072) f32 on the generic loop (path N's
   widths are path E's); and a few edge cases),
   with its time (CUDA events, median
   of 25 launches, L2 flushed before each; the plain scan loops, median of
   5), the plain version's time, the time of the one PyTorch call that
   computes the same function where there is one (``library_ms``, timed
   here only), and its bound on an H100 SXM.  Flash-attention rows name the
   kernel path each launch took (``wgmma``, ``mma``, ``scalar``) and its
   design, the worst relative error of a (batch, head, 128-query-row)
   block beside the element-wise one, and on the ``wgmma`` path the host
   time of a call (the wrapper, the bare launch, and the encoding of its
   three tensor maps alone); RMSNorm rows name the variant each launch took
   (instance and lanes a row); RG-LRU rows name the load route each launch
   took (``tma``, ``cp_async``) and, forced through every route the inputs
   allow, each route's time and error; both time beside the kernel one
   element-wise PyTorch op that moves the same bytes (``same_bytes_ms``: a
   copy of x; ``h = log_a + b`` on the same views), a yardstick for the
   bytes under this timing; WKV-6 rows name the design, time each of its
   launches, and run decays at the model's clamp and past it (log_w = -20
   every step);
P. phase P, numeric Python source through the python_ast frontend
   (``Offloader.prepare`` + ``search``, which is ``plan``), the launch
   counters set to 0 before it and read after: the differential suite's
   three workloads at full width, f32 on the card from float64 inputs,
   seed 0 -- ``ATTN_SRC`` at qwen3_0_6b's head dim 128 over 4 positions,
   ``RMS_SRC`` at its d_model 1024 over 64 rows, ``REC_SRC`` at
   recurrentgemma_2b's RG-LRU width 2560 over 64 steps from a nonzero
   ``h`` (``reduced``: the positions, rows and steps, which CPython
   interprets) -- each planned with GA 4 x 2 and repeats 1: the loops and
   why each excluded one left, the variant menu, the feasibility-check,
   calibration and search seconds, the winner and its speedup over the
   interpreted program; then the forced chromosome (``gpu_kernel`` on the
   variant site) must bind ``cuda``, launch its kernel (flash, RMSNorm,
   RG-LRU) once a run and verify, with its device launches and idle share
   and its transfers beside the transfer planner's prediction.  Then
   ``BLOCK_SRC`` (the suite's size): both ``attention_stack`` block
   variants verify and launch no hand kernel; and the demo ``app``
   (``examples/python_offload_demo.py`` at its own sizes): the matmul and
   DFT nests match, the library adapters run, and every top-level loop run
   eagerly on the card (one launch a scalar op) verifies, with its launch
   count;
K. phase K, function-block genes in the export frontend (the reference's
   ``bench_block_offload`` comparison at published widths), the launch
   counters set to 0 before it and read after.  Two ``nn.Module`` programs,
   each planned through ``Offloader.plan`` (f32, seed 0, GA 6 x 2, 1
   repeat) with block sites on (the default) and with
   ``options={"block_sites": False}``: K1, the attention stack at
   Qwen3-0.6B's width (x (2048, 1024), an ``RMSNorm`` submodule, wq/wk/wv
   (1024, 128), a causal single-head attention submodule, wo (128, 1024)
   and the residual) must get exactly one ``fnblock_*`` region, whose
   ``block_chunked`` and ``block_fused`` bind and verify, and the loop
   arm's forced chromosome must launch the RMSNorm and flash kernels once
   each and verify; K2, OLMoE-1B-7B's MoE in the ``moe_dispatch`` record's
   dense one-hot form (router, softmax, top-8, one-hot combine and the
   three expert einsums over 4096 tokens, d 2048, 64 experts of width
   1024) must get one ``fnblock_*`` region whose ``block_scatter`` (the
   dropless capacity-limited dispatch) binds and verifies.  Each arm's
   winner, its forward time, and the forced chromosomes' times are
   printed, and the overlap phase's estimate and backoff;
J. phase J, inside the phases that build its programs: the programs the
   port captures as CUDA graphs where the reference calls ``jax.jit``
   (``repro_torch.core.device_program``), each against the eager port
   (``disable_capture``): Q, R, W, M and H's all-reference and all-kernel
   programs (in phase 3), P's demo ``app`` with every top-level loop
   offloaded (in phase P) and one decode step of each served model (S,
   SH, SE, SF, SW, SL, SB, SA, in the serve phases; SL's, SB's and SA's
   replay must equal the eager step bit for bit).  One line each, ``phase J
   <label>:``, beside the card's name and power limit: the replay's
   output against the eager one (bit for bit, else the first leaf that
   differs and by how much; within the verifier's 1e-2 or the run
   fails), a replay on new inputs against the eager run on them, the
   host's CUDA submissions and the replays of one call (one graph a
   program, or a loop), wall and device time and the idle share, eager
   and captured, and the first call's and the capture's seconds.  The
   GA's timed calls, the serve phases' prefill and decode and the
   "where the time goes" lines of phase 3 are taken on captured programs;
3. the main paths, each through ``Offloader.plan`` with the launch
   counters set to 0 just before it and read just after.  Each plan must
   verify; the forced all-kernel plan must bind the CUDA kernels at every
   matched site and match the unsubstituted program, and one forward of it
   must launch each kernel once a site, by the kernel path, RMSNorm
   variant and RG-LRU route the path's shapes select; no chromosome that
   selects a kernel may have failed with an error; then, for the
   all-reference program, the plan's winner and the all-kernel program,
   where one forward's time goes (``torch.profiler``: device time, idle
   share, top kernels), and the device's span of one forward by CUDA
   events.  On path Q every flash launch must have taken the wgmma path;
   on paths Q and R every RMSNorm launch the variant its width selects,
   and on path R every RG-LRU launch the ``tma`` route.  Every path's
   plan carries the export frontend's function-block genes: the count of
   ``fnblock_*`` regions that bind, their variants and members, and the
   overlap phase's estimate and backoff are printed; the forced all-kernel
   chromosome leaves each ``fnblock_*`` gene on ``ref``.  After path Q,
   phase QO plans Q twice, its prepares serial (``compile_workers=0``) and
   on 4 threads, each chromosome's time a fixed function of its bits (the
   prepares -- substitution, warm-up and verification on the card -- are
   real): the two searches must give the same best bits, measure the
   same chromosomes and fail the same prepares, each failure printed
   with its error.

   - Q: one full-width Qwen3-0.6B dense block (d_model 1024, 16 q / 8 kv
     heads, head_dim 128, d_ff 3072) in bf16 at batch 2 x 2048 tokens, GA
     population 8 x 4 generations: 4 ``rmsnorm`` + 1 ``softmax_attention``
     sites, the flash-attention and RMSNorm kernels;
   - R: one full-width RecurrentGemma-2B recurrent sublayer (d_model and
     d_rnn 2560, 10 gate heads of 256, conv width 4, d_ff 7680 GeGLU) in
     bf16 at batch 2 x 2048 tokens, the scan in f32, GA 8 x 4: 2 ``rmsnorm``
     + 1 ``linear_recurrence`` sites, the RMSNorm and RG-LRU scan kernels;
   - W: a single-head WKV-6 scan program (the reference's ``_wkv_app``) at
     RWKV-6-3B's head width, D = 64, S = 4096, f32, GA 6 x 3: 1
     ``wkv_recurrence`` site, the WKV-6 kernel;
   - M: the whole Qwen3-0.6B (28 layers at full width, random weights from
     seed 0 in the reference's distributions, drawn on the card by a CUDA
     generator, as every path model is)
     built with ``build_model``,
     its prefill of (2, 2048) tokens -> (last-token logits, decode state)
     planned through a lambda over ``Model.prefill`` in f32 by the planning
     service (``PlanService.plan``: one search, on the service's pool
     thread; its store and the winner's output kept for phase V2), GA 8 x
     4: 28
     ``softmax_attention`` + 113 ``rmsnorm`` sites (ln1, q-norm, k-norm and
     ln2 of each layer, and the final norm); one forward of the forced
     all-kernel plan must launch flash 28 times and RMSNorm 113 times.
     Then the same model in bf16: the forced all-kernel bf16 prefill against
     the bf16 reference, each output leaf's error printed (a diagnostic:
     nothing is asserted on it); and ``Server.generate`` in bf16 under
     ``OFFLOAD_PLAN``: 4 requests of 512 prompt tokens and 32 greedy new
     tokens, twice (identical tokens), then under ``REFERENCE_PLAN`` after
     ``swap_plan`` (the tokens of a server built on that plan), with the
     prefill time, the decode time per token and tokens/s; then phase V3:
     the config's ``exec_plan`` stored by ``PlanService.plan`` (the module
     frontend's static cost, GA 4 x 1), ``Server.from_store`` serving the
     same requests (the tokens of a server built on that plan, its prefill
     and decode times), and ``swap_plan`` between it and
     ``REFERENCE_PLAN`` while a client thread generates (every generation
     one plan's tokens);
   - H: RecurrentGemma-2B at full width and 3 of its 26 layers (one
     period of its pattern; cut for the run's time, ``PATH_LAYERS``: 8
     until the captured programs came) in the pattern rglru, rglru, local
     attention (random weights from seed 0 in
     the reference's distributions) built with ``build_model``, its
     prefill of (2, 2048) tokens -- S = the local window, so the local
     attention is exactly causal -- planned like M in f32 (the ``step``
     scan: one scan site a recurrent sublayer), GA 4 x 2 (cut from 6 x 3
     for the run's time): 2 ``linear_recurrence`` + 1
     ``softmax_attention`` + 7 ``rmsnorm`` sites;
     one forward of the forced all-kernel plan must launch RG-LRU twice
     (all ``tma``), flash once (all ``scalar``) and RMSNorm 7 times
     (all ``d2560_l32``).  The all-reference program (~25k launches) is
     profiled for one forward.  Then the bf16 diagnostic of the forced
     all-kernel prefill, and ``Server.generate`` in bf16 under
     ``OFFLOAD_PLAN`` (the ``assoc`` scan in prefill; RG-LRU states and ring
     caches in decode): 4 requests of 512 prompt tokens and 16 greedy new
     tokens, twice (identical tokens), with the launches of a decode step;
   - E: OLMoE-1B-7B at full width (64 experts top-8 of width 1024, MHA
     with QK-norm) and 4 of its 16 layers (cut for the run's time, 8
     until the captured programs came; random
     weights from seed 0), alone on the
     card, its prefill of (2, 2048) tokens planned in f32 under the
     ``scatter_ep`` MoE, GA 6 x 3 seeded with the forced all-kernel
     chromosome: exactly 4 ``softmax_attention`` + 17 ``rmsnorm`` sites
     (no router, expert or MoE region binds); one forward of the forced
     plan must launch flash 4 times (all ``scalar``) and RMSNorm 17 times
     (9 ``generic_l32``, 8 ``d128_l32``); no chromosome may fail with an
     error; the all-reference prefill run twice gives the same bits.  The
     forced plan verifies (outcome a), or (outcome b) a routing diagnostic
     finds a (layer, token) whose top-k set the kernels' rounding changed
     while the layer-0 K and V stay within 1e-4 of the reference's; either
     is printed with the per-layer K/V errors.  Then one all-reference
     forward under ``dense_onehot`` (time only), and ``Server.generate``
     in bf16 under ``OFFLOAD_PLAN`` (16 new tokens);
   - F: RWKV-6-3B at full width (40 heads of 64) and 2 of its 32 layers
     (cut for the run's time; 8 until phase D came, 4 until the captured
     programs came),
     alone on the card: its f32 ``chunked`` prefill of (2, 2048) tokens
     planned with GA 4 x 2 (its ``step`` prefill, once a check against
     ``chunked``, went for the run's time: the CPU and card tests hold the
     two forms to each other),
     seeded like E: only the final norm binds (``d2560_l32``); the 5
     LayerNorm regions (x, scale, bias) and the 2 multi-head WKV scans
     match and are refused; the forced plan verifies.  Then
     ``Server.generate`` in bf16 under ``OFFLOAD_PLAN`` (chunked prefill,
     RWKV states replaced in decode; 16 new tokens);
   - X: the whole Whisper-small (12 encoder and 12 decoder layers at full
     width, d_model 768, 12 heads of 64; random weights from seed 0),
     alone on the card: its f32 prefill of 2 x 448 tokens over 2 x 1500
     stub frames (bf16, seed 1) -> (last-token logits, each layer's k, v,
     xk, xv), planned with GA 6 x 3 seeded with the forced chromosome.  The
     export must find 62 ``rmsnorm`` and 36 ``softmax_attention`` sites in
     program order (``whisper_sites``).  Both packages' attention binders
     compute attention causal whatever the region's mask, so the forced
     plan binds ``cuda`` at every norm and at each site whose module is a
     causal attention core (the 12 decoder self-attentions), ``ref`` at
     the 12 encoder and 12 cross-attentions; one forward of it must launch
     flash 12 times (``scalar``) and RMSNorm 62 times (``generic_l32``)
     and verify.  The finding of the causal binder: ``cuda`` at every
     matched site, and ``fused_torch`` at one encoder site alone, each run
     once, must fail verification (not raise); their errors by leaf group
     are printed.  Then the bf16 diagnostic of the forced plan, and
     ``Server.generate`` in bf16 under ``OFFLOAD_PLAN`` (path SW): 4
     requests of a 4-token prompt over (4, 1500, 768) frames, 32 greedy new
     tokens, twice (identical tokens), then after ``swap_plan``;
   - L, B, A, G, N (``ZOO``): the zoo configs whose code or shapes no
     other path runs, at published widths, each alone on the card after
     X: L the LLaVA-NeXT-Mistral-7B prefill (8 of 32 layers) of 1 x (2880
     patch features through the projector, then 1216 tokens); B the
     Qwen1.5-4B prefill (10 of 40 layers; QKV bias, 20 heads of 128), A
     the Llama-4 Scout prefill (2 of 48 layers; top-1 of 16 experts and a
     shared expert under ``scatter_ep``, 40 query heads over 8 KV heads),
     G the Gemma-7B prefill (4 of 28 layers; 16 MHA heads of 256, GeGLU,
     the sqrt(d_model)-scaled tied 256000 x 3072 embedding) and N the
     whole TinyLlama-1.1B prefill (22 layers; 32 query heads over 4 KV
     heads of 64), each of 2 x 2048 tokens; all f32, weights drawn on the
     card from a CUDA generator seeded 0 with every zero-initialised leaf
     (QKV and projector biases, norm scales) redrawn N(0, 0.1).  Each
     export finds an attention and two norms a layer and the final norm;
     GA 4 x 2 seeded with the forced chromosome, which launches flash
     (``scalar``) once a layer and RMSNorm 2 x layers + 1 times and
     verifies (A: or the routing diagnostic explains the miss).  Then
     ``Server.generate`` in bf16 under ``OFFLOAD_PLAN`` (SL, SB, SA, SG,
     SN): 4 requests of 512 prompt tokens (L's after 2880 patches), 16
     greedy new tokens, twice (identical tokens); each decode step's
     replay bit-equal to the eager step (phase J).

   On every path the verifier runs as the fitness runs it (the reference
   kept on the card, each pair compared there in f64; ``verify_s``) and as
   the parent commit ran it (the reference as f64 host arrays, the
   candidate copied over; ``verify_host_s``), and the path's peak device
   memory is printed.  Phase C1 on every path: the all-reference and the
   forced all-kernel programs' rooflines from their aten graphs
   (``repro_torch.hlo_analysis``, a host-only walk; every kernel node
   charged its registry variant's cost, no node left without one), their
   compute, memory and step ms printed beside the measured device ms,
   which must reach the compute ms;
V. phase V, the planning service (``repro_torch.service``), after serve
   H, the launch counters set to 0 before it and read after: V1, the
   service's lifecycle on path Q's block (bf16, GA 8 x 4): four client
   threads submit it at once (one search, three coalesced), a fifth
   submit is a live hit, the endpoint verifies and launches flash and
   RMSNorm, a restarted service warm-loads (no GA generation, no
   measurement; bit-equal output), a record tampered to a foreign env
   re-measures, ``refine_once`` runs while two client threads call the
   endpoint (every output one deployed plan's; a swap is rolled back),
   the latency operating point keeps the plan and ``evict_stale(0)``
   spares it; V4, ``obsreport`` renders V1's trace (its
   ``service.admit`` spans: cold search, warm load, re-measure); V2, a
   fresh process (this script with ``--warm-child``) builds the whole
   Qwen3-0.6B in f32 from path M's seed and warm-loads path M's plan
   from its store: no search, output bit-equal to path M's winner, each
   bound kernel launched once a site; its seconds (imports, kernel load,
   model, prepare, apply, first forward) beside path M's plan wall;
4. phase T, training (no hand kernel lies on it: the reference trains
   through the jnp twin of the flash kernel, ``_flash``'s custom VJP):

   - T1: the chunked attention's custom backward (the ``_Flash`` autograd
     Function) against autograd through the materialized ``attend_naive``
     at path M's attention shape, (2, 2048, 16 / 8 heads, 128) f32 causal,
     chunks of 128: dq, dk, dv within 1e-4, each one's forward+backward
     time (CUDA events) and peak device memory; the Function's must be
     the lower;
   - T2: one train step of Qwen3-0.6B at full width and 2 layers under the
     launcher's plan, batch 2 x 256, on the card and on the CPU, TF32 off:
     loss, gradient norm, first moments and updates must agree;
   - T3: the launcher's ``_run`` on the whole Qwen3-0.6B (28 layers, f32,
     random weights from seed 0): 6 steps of 4 x 2048 tokens in 2
     microbatches, checkpoints every 4 steps under ``build/``; six finite
     losses, the last below the first; s/step (median of steps 2-6),
     tokens/s, peak device memory, each checkpoint's bytes and seconds,
     and one step's device time and idle share (``torch.profiler``);
   - T4: ``_run`` again with ``--resume --steps 6``: it restores step 4,
     checkpoints it again and its replayed steps 4 and 5 must match T3's
     losses within 1e-4 relative; the checkpoints are deleted after;

C. phase C2, a plan chosen by the compiled-artifact cost model:
   ``Offloader.plan`` of the Qwen3-0.6B config with ``options={"lower_fn":
   ...}`` (the module frontend's ``CostModelFitness``): each chromosome's
   ExecPlan lowers the train step at full width and depth, f32, over one
   sequence of 4096 tokens (fake tensors on the card; 2 and 3 layers traced
   and extrapolated to 28), scored by its roofline, ∞ above the card's
   memory; GA 6 x 2 from seed 0.  Every chromosome's terms, ``live_bytes``
   and fit are printed, then the winner's plan against the baseline; the
   winner (and the baseline, where it differs and fits) runs 3 real steps:
   each must take at least its compute time; s/step and the peak device
   memory are printed beside ``step_s`` and ``live_bytes``;
C3. phase C3 (after C2), train steps through a scan: RecurrentGemma-2B
   (the RG-LRU ``assoc`` scan) and RWKV-6-3B (the WKV ``chunked`` scan)
   under their production plans.  Its children start before phase T and
   trace beside T and C2 at the lowest CPU priority: for each model
   ``chip_smoke.py --c3-trace`` (the dry run's ``train_4k`` record on one
   card at full depth, one sequence a microbatch of the plan's 2,
   extrapolated by periods; then C3b's configuration traced); with
   ``--only C`` also the dry run on ``pod16x16`` (cut from the full run
   for its time).  C3b: 3
   real train steps of each model on the card in f32 at 2 x 4096 tokens
   in 2 microbatches, at ``PATH_LAYERS``' depth (3 of 26 and 2 of 32
   layers), weights drawn on the card from seed 0: finite losses, s/step
   (median of steps 2-3), the profiled third step's device time, both
   at least the traced program's compute term, the peak device memory
   beside its ``live_bytes``.  C3a: each record ok, with ``live_bytes``,
   ``fits_80gb``, the compute, memory and collective ms, FLOPs x devices
   / 6 N D (at least 1) and the lowering seconds; on the mesh (``--only
   C``) the collectives by group (each a divisor of 256, a 16-rank one
   among them).  Then phase C's seconds (C1's graph walks, C2 and C3);
D. phase D, sharding and the mesh (after C2), the launch counters set to
   0 before it and read after; D3's two children start first and trace
   while D1 and D2 run on the card, their records read last:

   - D1: ``make_host_mesh()`` (NCCL at world size 1, a (1, 1) mesh); the
     whole Qwen3-0.6B (28 layers, f32, random weights from seed 0) under
     ``OFFLOAD_PLAN`` (chunked attention) over 1 x 2048 tokens at a
     constant lr of 1e-3, 2 steps of ``make_train_step`` and 2 of
     ``jit_train_step`` (DTensor state) from the same init: losses and
     every parameter within 1e-5; s/step, peak memory, device launches
     and NCCL kernels of each (the last step profiled); then ``reshard``
     of the step-2 checkpoint (under ``build/``, deleted after) onto the
     same mesh: bit-equal, with its bytes and seconds;
   - D2: path Q's block (bf16) with its first RMSNorm site on
     ``mesh:data:1:batch`` and the attention and the other RMSNorm sites
     on ``cuda``: the report says ``local_map over 1xdata``, one forward
     launches flash once and RMSNorm 3 times, and it verifies; then the
     GA (4 x 2, seed 0) with the mesh gene in the alphabet: its winner
     verifies; a ``PlanStore`` round trip of the forced mesh plan
     rehydrates bit-equal; ``mesh:data:8:batch`` falls back,
     ``unavailable``, ``modeled cost``;
   - D3: ``python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape
     train_4k --mesh pod16x16`` and ``--mesh pod2x16x16`` (a fake world of
     256 / 512 ranks, fake tensors on the card's device type; one
     sequence a data-parallel rank): status ok, every collective's group
     a divisor of the mesh, a 16-rank group on both and a 2-rank one on
     the multi-pod mesh only, per-device FLOPs x devices at least 6 N D;
     per device ``live_bytes``, the collective histogram, and the compute,
     memory and collective ms, with the lowering seconds; then phase D's
     seconds;
5. a ``{"kernels": [...]}`` line (each RMSNorm and RG-LRU entry carries its
   per-shape rows beside the path sums), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Needs a CUDA device; without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

#: the clock at the start of the imports (phase V2's child reports them)
_IMPORT_T0 = time.perf_counter()

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch._dynamo  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch._higher_order_ops.scan import scan  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import hlo_analysis  # noqa: E402
from repro_torch import roofline as rl  # noqa: E402
from repro_torch.configs.base import TRAIN_4K, get_config  # noqa: E402
from repro_torch.core.device_program import disable_capture  # noqa: E402
from repro_torch.core.evaluator import MeasurementCache  # noqa: E402
from repro_torch.core.objectives import nvml_power_w  # noqa: E402
from repro_torch.core.frontends.ast_frontend import PyOffloadArtifact  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.core.transfer_planner import plan_transfers  # noqa: E402
from repro_torch.core.verifier import verify  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    block_rel_err, flash_attention_plain, select_path)
from repro_torch.kernels.flash_attention import launch as flash_launch  # noqa: E402
from repro_torch.kernels import rglru_scan as rg_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import (rmsnorm_plain,  # noqa: E402
                                         select_variant, variant_name)
from repro_torch.kernels.wkv6 import wkv6_plain  # noqa: E402
from repro_torch.models import (OFFLOAD_PLAN, REFERENCE_PLAN,  # noqa: E402
                                build_model)
from repro_torch.models.attention import Attention  # noqa: E402
from repro_torch.models.layers import RMSNorm  # noqa: E402
from repro_torch.models.transformer import (INIT_STD, DenseBlock,  # noqa: E402
                                            RecurrentSublayer)
from repro_torch.launch import obsreport  # noqa: E402
from repro_torch.models.plan import ExecPlan  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.trace import read_trace  # noqa: E402
from repro_torch.runtime.serve import Server  # noqa: E402
from repro_torch.service import (PlanService, PlanStore,  # noqa: E402
                                 ServiceConfig)

BATCH, SEQ = 2, 2048
#: path W: one WKV head at RWKV-6-3B's head width
WKV_SEQ, WKV_DIM = 4096, 64
#: serving requests: 4 prompts of 512 tokens, 32 new tokens each (path M's
#: model), 16 (path H's)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_NEW_H = 4, 512, 32, 16
#: path X: the whole Whisper-small over its 1500 encoder frames, with
#: tokens of its published decoder context; its serving prompts are the
#: 4-token start-of-transcript prefix
WHISPER = get_config("whisper_small")
X_TOKENS, SERVE_PROMPT_X = 448, 4
#: depth cut for the run's time, widths as published: path H's
#: RecurrentGemma-2B runs 3 of its 26 layers (one period of the pattern
#: rglru, rglru, local attention), path E's OLMoE-1B-7B 4 of its 16, path
#: F's RWKV-6-3B 2 of its 32 (H and E 8, F 4 until phase J's captured
#: programs came; F 8 until phase D came)
PATH_LAYERS = {"recurrentgemma_2b": 3, "olmoe_1b_7b": 4, "rwkv6_3b": 2,
               "llava_next_mistral_7b": 8, "qwen1_5_4b": 10,
               "llama4_scout_17b_a16e": 2, "gemma_7b": 4,
               "tinyllama_1_1b": 22}
#: the zoo configs whose code or shapes no other path runs, each at
#: published widths and the depth above (``PATH_LAYERS``): path L,
#: LLaVA-NeXT-Mistral-7B (the projector and a 2880-patch prefix; 8 of 32
#: layers, for the run's time);
#: path B, Qwen1.5-4B (QKV bias, 20 MHA heads of 128; 10 of 40); path A,
#: Llama-4 Scout (top-1 routing, a shared expert, 40 query heads over 8 KV
#: heads; 2 of 48: 108B parameters, 216 GB in bf16, never fit one card);
#: path G, Gemma-7B (16 MHA heads of 256, GeGLU, a sqrt(d_model)-scaled
#: tied 256000 x 3072 embedding; 4 of 28, for the run's time); path N,
#: TinyLlama-1.1B (32 query heads over 4 KV heads of 64; all 22 layers)
ZOO = {"L": "llava_next_mistral_7b", "B": "qwen1_5_4b",
       "A": "llama4_scout_17b_a16e", "G": "gemma_7b", "N": "tinyllama_1_1b"}
#: each zoo path's prefill: (batch, tokens a row, a VLM's patches
#: included): L 1 x (2880 patches + 1216 text tokens), the others 2 x 2048
ZOO_BATCH = {"L": (1, 4096), "B": (BATCH, SEQ), "A": (BATCH, SEQ),
             "G": (BATCH, SEQ), "N": (BATCH, SEQ)}
SEED = 0
REPEATS = 25


def path_config(arch: str):
    """``arch``'s published config at the depth its path runs
    (``PATH_LAYERS``)."""
    cfg = get_config(arch)
    if arch in PATH_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=PATH_LAYERS[arch])
    return cfg


#: the plain scan loops take thousands of launches a call
PLAIN_SCAN_REPEATS = 5
#: the RWKV-6 time-mix clamps its decay at -exp(2) a step (``rwkv.py:239``)
STRONG_LOG_W = -math.exp(2.0)
#: a decay far past the clamp, where exp(-cumsum log_w) overflows f32 after
#: five steps
EXTREME_LOG_W = -20.0
#: what each flash-attention path is (``csrc/flash_attention.cu``)
FLASH_DESIGNS = {
    "wgmma": "TMA + wgmma, producer/2-consumer warpgroups, 128x128 tiles, "
             "3-stage K/V ring",
    "mma": "mma.sync m16n8k16 + cp.async double buffer, 64-row tiles, "
           "head dim 32",
    "scalar": "f32 FMA, 64-row tiles"}
WKV_DESIGN = ("chunk-parallel: 64-step chunks, 16-step sub-chunks, chunk "
              "states + state pass, 3 launches")
RMSNORM_DESIGN = ("rows held in registers, lanes a row matched to the width, "
                  "scale in registers, grid-stride with the next row group's "
                  "loads in flight")
RGLRU_DESIGN = ("one block per (batch row, 32 channels) walks all of S; a "
                "4-stage ring of 64-step stages filled by TMA or cp.async; 4 "
                "consumer warps scan 16-step slices and fold their maps")
#: libraries whose kernels must not spill (the ones this run redesigned)
NO_SPILL = ("rmsnorm", "rglru_scan")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {what}")


def bound_ms(cost: rl.KernelCost) -> tuple:
    """The least time an H100 SXM could take for ``cost`` (its published
    dense peaks at 700 W, ``repro_torch.roofline``): bytes over the HBM
    rate or operations over the peak of their precision, the larger."""
    t_bytes = cost.bytes / rl.HBM_BW
    t_ops = cost.flops / rl.PEAK_FLOPS[cost.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, flush: torch.Tensor, repeats: int = REPEATS) -> float:
    """Median over ``repeats`` calls, CUDA events around each, L2 flushed
    (a 64 MiB write) before each.  A GPU-side spin (~0.5 ms) before the
    start event lets the host enqueue the whole call first, so the time is
    the device's and not the Python launch overhead's (for a call that
    takes longer to enqueue than the spin, the host's share shows)."""
    for _ in range(min(3, repeats)):
        fn()
    times = []
    for _ in range(repeats):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(what: str, got: torch.Tensor, want: torch.Tensor,
            tol: float, rtol: float | None = None) -> float:
    """Max |got - want|; fails unless |got - want| <= tol + rtol*|want|
    everywhere (rtol defaults to tol)."""
    got, want = got.float(), want.float()
    rtol = tol if rtol is None else rtol
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool(torch.isfinite(want).all()), f"{what}: non-finite plain output")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=tol, rtol=rtol),
          f"{what}: max abs err {err} outside atol {tol} rtol {rtol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rmsnorm_case(dev, n, d, dtype, tol, flush, gen):
    x = torch.randn(n, d, generator=gen).to(dev, dtype)
    s = (torch.randn(d, generator=gen) * 0.1).to(dev, dtype)
    before = dict(ops.rmsnorm.launches_by_variant)
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    variant = [v for v, k in ops.rmsnorm.launches_by_variant.items()
               if k != before.get(v, 0)]
    want_variant = variant_name(select_variant(x))
    check(variant == [want_variant],
          f"rmsnorm ({n},{d}): the launch went through {variant}, not "
          f"{want_variant}")
    err = compare(f"rmsnorm ({n},{d}) {dtype}", got, rmsnorm_plain(x, s), tol)
    w = 1.0 + s.float()
    row = {"shape": [n, d], "dtype": str(dtype).split(".")[-1],
           "variant": want_variant, "max_abs_err": err,
           "ms": time_ms(lambda: ops.rmsnorm(x, s), flush),
           "plain_ms": time_ms(lambda: rmsnorm_plain(x, s), flush),
           "library_ms": time_ms(
               lambda: F.rms_norm(x, (d,), w.to(dtype), 1e-6), flush),
           "same_bytes_ms": time_ms(lambda: torch.empty_like(x).copy_(x),
                                    flush)}
    row["bound_ms"], row["bound_by"] = bound_ms(
        rl.rmsnorm_cost(n, d, x.dtype, s.dtype))
    return row


def flash_case(dev, b, sq, sk, hq, hkv, d, causal, dtype, tol, rel_limit,
               flush, gen):
    q = torch.randn(b, sq, hq, d, generator=gen).to(dev, dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen).to(dev, dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen).to(dev, dtype)
    before = dict(ops.flash_attention.launches_by_path)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    path = [p for p, n in ops.flash_attention.launches_by_path.items()
            if n != before[p]]
    check(path == [select_path(q, k, v)],
          f"flash: the launch went through {path}, not "
          f"{select_path(q, k, v)}")
    want = flash_attention_plain(q, k, v, causal=causal,
                                 scale=1.0 / math.sqrt(d))
    what = f"flash ({b},{sq},{sk},{hq},{hkv},{d}) causal={causal} {dtype}"
    err = compare(what, got, want, tol)
    rel = block_rel_err(got, want)
    check(rel <= rel_limit,
          f"{what}: block relative err {rel} above {rel_limit}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = {"shape": [b, sq, sk, hq, hkv, d], "causal": causal,
           "dtype": str(dtype).split(".")[-1], "path": path[0],
           "design": FLASH_DESIGNS[path[0]], "max_abs_err": err,
           "block_rel_err": rel, "block_rel_limit": rel_limit,
           "ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                         flush),
           "plain_ms": time_ms(lambda: flash_attention_plain(
               q, k, v, causal=causal, scale=1.0 / math.sqrt(d)), flush),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=True), flush)}
    # work this run's inputs need: the (row, key) pairs the mask keeps
    row["bound_ms"], row["bound_by"] = bound_ms(
        rl.flash_cost(b, sq, sk, hq, hkv, d, causal, dtype))
    if path == ["wgmma"]:
        # host time of one call: the wrapper, the bare launch (three
        # tensor-map encodings and the launch), and the encodings alone
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(d)
        row["host_us"] = {
            "wrapper": host_us(lambda: ops.flash_attention(q, k, v,
                                                           causal=causal)),
            "launch_wgmma": host_us(lambda: flash_launch(
                q, k, v, out, causal=causal, scale=scale, path="wgmma")),
            "encode_maps": encode_maps_us(q, k, v)}
    return row


def encode_maps_us(q, k, v, reps: int = 1000) -> float:
    """Host time of encoding the wgmma path's three tensor maps (µs, mean
    of ``reps`` inside one C call, so no ctypes cost is in it)."""
    fn = build.library("flash_attention").flash_attention_encode_maps
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    b, sq, hq, d = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), b, hq, k.shape[2], sq,
            k.shape[1], d, *(s for t in (q, k, v) for s in t.stride()[:3]))
    check(fn(*args, 1) == 0, "flash: tensor-map encoding failed")
    t0 = time.perf_counter()
    err = fn(*args, reps)
    elapsed = time.perf_counter() - t0
    check(err == 0, "flash: tensor-map encoding failed")
    return elapsed / reps * 1e6


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` (µs, mean of ``calls``), enqueued
    behind a ~25 ms GPU spin so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def rglru_case(dev, b, s, d, *, h0, time_major, flush, gen):
    """The scan at (b, s, d) f32, coefficients drawn as the reference's
    sweep draws them (``tests/test_kernels.py``).  ``time_major`` stores
    them (s, b, d) and hands the kernel (b, s, d) views, as path R's scan
    site does."""
    shape = (s, b, d) if time_major else (b, s, d)
    la = (-torch.randn(*shape, generator=gen).abs() * 0.2).to(dev)
    bb = (torch.randn(*shape, generator=gen) * 0.5).to(dev)
    if time_major:
        la, bb = la.transpose(0, 1), bb.transpose(0, 1)
    h = torch.randn(b, d, generator=gen).to(dev) if h0 else None
    what = f"rglru_scan ({b},{s},{d}) h0={h0} time_major={time_major}"
    before = dict(ops.rglru_scan.launches_by_route)
    got = ops.rglru_scan(la, bb, h)
    torch.cuda.synchronize()
    route = [r for r, n in ops.rglru_scan.launches_by_route.items()
             if n != before[r]]
    check(route == [rg_kernel.select_route(la, bb)],
          f"{what}: the launch went through {route}, not "
          f"{rg_kernel.select_route(la, bb)}")
    want = rglru_scan_plain(la, bb, h)
    err = compare(what, got, want, 1e-5, 1e-4)
    # every route these inputs allow, forced (h0 = 0: the bare launch)
    routes = ["tma", "cp_async"] if route == ["tma"] else ["cp_async"]
    plain0 = rglru_scan_plain(la, bb) if h0 else want
    out = torch.empty(b, s, d, device=dev)
    by_route = {}
    for r in routes:
        out.fill_(float("nan"))
        rg_kernel.launch(la, bb, out, route=r)
        torch.cuda.synchronize()
        by_route[r] = {
            "max_abs_err": compare(f"{what} route={r}", out, plain0,
                                   1e-5, 1e-4),
            "ms": time_ms(lambda: rg_kernel.launch(la, bb, out, route=r),
                          flush)}
    row = {"shape": [b, s, d], "h0": h0, "time_major": time_major,
           "route": route[0], "design": RGLRU_DESIGN, "max_abs_err": err,
           "forced_routes": by_route,
           "ms": time_ms(lambda: ops.rglru_scan(la, bb, h), flush),
           "plain_ms": time_ms(lambda: rglru_scan_plain(la, bb, h), flush,
                               PLAIN_SCAN_REPEATS),
           "library_ms": None,
           "same_bytes_ms": time_ms(lambda: torch.add(la, bb, out=out),
                                    flush)}
    row["bound_ms"], row["bound_by"] = bound_ms(rl.rglru_cost(b, s, d, h0))
    return row


def wkv6_case(dev, b, s, h, d, *, log_w, flush, gen):
    """WKV-6 at (b, s, h, d) f32, drawn as the reference's sweep draws
    (``tests/test_kernels.py``); a number ``log_w`` puts the decay there at
    every step (the model's clamp, -exp(2), or past it)."""
    r, k, v = ((torch.randn(b, s, h, d, generator=gen) * 0.5).to(dev)
               for _ in range(3))
    lw = torch.full((b, s, h, d), log_w) if log_w is not None \
        else -torch.randn(b, s, h, d, generator=gen).abs() * 0.3
    lw = lw.to(dev)
    u = (torch.randn(h, d, generator=gen) * 0.1).to(dev)
    got = ops.wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    err = compare(f"wkv6 ({b},{s},{h},{d}) log_w={log_w}", got,
                  wkv6_plain(r, k, v, lw, u), 5e-5, 1e-3)
    row = {"shape": [b, s, h, d], "log_w": log_w, "design": WKV_DESIGN,
           "max_abs_err": err,
           "ms": time_ms(lambda: ops.wkv6(r, k, v, lw, u), flush),
           "plain_ms": time_ms(lambda: wkv6_plain(r, k, v, lw, u), flush,
                               PLAIN_SCAN_REPEATS),
           "library_ms": None}
    row["launch_us"] = launch_breakdown_us(lambda: ops.wkv6(r, k, v, lw, u))
    # the step form: about 4 f32 operations per state entry per step
    row["bound_ms"], row["bound_by"] = bound_ms(rl.wkv6_cost(b, s, h, d))
    return row


def launch_breakdown_us(fn, calls: int = 5) -> dict:
    """Device time of each kernel one call of ``fn`` launches (µs a call,
    ``torch.profiler`` over ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    def short(key):
        key = key.replace("void ", "").replace("(anonymous namespace)::", "")
        return key.split("(")[0][:48]
    return {short(e.key): e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def x_norm_calls(cfg) -> list:
    """Path X's RMSNorm calls of one prefill, as (rows, width): ln1 and
    ln2 of each encoder layer and the encoder's final norm over B x 1500
    frames, ln1, ln_x and ln2 of each decoder layer over B x 448 tokens,
    and the final norm over the last token's rows."""
    enc, dec = BATCH * cfg.encoder_seq, BATCH * X_TOKENS
    return ([(enc, cfg.d_model)] * (2 * cfg.n_encoder_layers + 1)
            + [(dec, cfg.d_model)] * (3 * cfg.n_layers)
            + [(BATCH, cfg.d_model)])


def flash_keys(row: dict) -> dict:
    return {k: row[k] for k in ("shape", "dtype", "path", "design",
                                "max_abs_err", "block_rel_err", "ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}


def _entry(name, path_row, **extra):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            **extra,
            **{k: path_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}}


def phase_kernels(dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config("qwen3_0_6b")
    rg = path_config("recurrentgemma_2b")
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = BATCH * SEQ
    # path Q's four RMSNorm calls per block forward: ln1, q-norm, k-norm,
    # ln2; path R's two: ln1, ln2
    path_norms = [(tokens, cfg.d_model), (tokens * nq, hd),
                  (tokens * nkv, hd), (tokens, cfg.d_model)]
    path_r_norms = [(tokens, rg.d_model)] * 2
    norms = {}
    for n, d in sorted(set(path_norms + path_r_norms)):
        norms[(n, d)] = rmsnorm_case(dev, n, d, bf16, 2e-2, flush, gen)
        print("rmsnorm  ", json.dumps(norms[(n, d)]), flush=True)
    # path M's 113 calls per prefill, in f32: the four of each of 28
    # layers and the final norm over the last token's rows
    path_m_norms = path_norms * cfg.n_layers + [(BATCH, cfg.d_model)]
    norms_m = {}
    for n, d in sorted(set(path_m_norms)):
        norms_m[(n, d)] = rmsnorm_case(dev, n, d, f32, 1e-5, flush, gen)
        print("rmsnorm  ", json.dumps(norms_m[(n, d)]), flush=True)

    # path H's 17 calls per prefill, in f32: ln1 and ln2 of each of 8
    # sublayers and the final norm over the last token's rows
    path_h_norms = [(tokens, rg.d_model)] * (2 * rg.n_layers) \
        + [(BATCH, rg.d_model)]
    norms_h = {}
    for n, d in sorted(set(path_h_norms)):
        norms_h[(n, d)] = rmsnorm_case(dev, n, d, f32, 1e-5, flush, gen)
        print("rmsnorm  ", json.dumps(norms_h[(n, d)]), flush=True)
    # path E's 17 calls per prefill, in f32: ln1, q-norm, k-norm (16 kv
    # heads: as many rows as the q-norm) and ln2 of each of 4 layers, and
    # the final norm; d_model 2048 takes the generic loop.  Path F's one
    # call is path H's final norm, (2, 2560)
    olmoe = path_config("olmoe_1b_7b")
    oh = olmoe.resolved_head_dim
    path_e_norms = [(tokens, olmoe.d_model), (tokens * olmoe.n_heads, oh),
                    (tokens * olmoe.n_kv_heads, oh),
                    (tokens, olmoe.d_model)] * olmoe.n_layers \
        + [(BATCH, olmoe.d_model)]
    norms_e = {}
    for n, d in sorted(set(path_e_norms)):
        norms_e[(n, d)] = norms_m.get((n, d)) or rmsnorm_case(
            dev, n, d, f32, 1e-5, flush, gen)
        print("rmsnorm  ", json.dumps(norms_e[(n, d)]), flush=True)
    path_f_norms = [(BATCH, get_config("rwkv6_3b").d_model)]
    # the calls of paths G and N per prefill, in f32: ln1 and ln2 of each
    # layer and the final norm over the last token's rows; d_model 3072
    # and 2048 take the generic loop, and N's widths are E's rows.  G's and
    # N's rows draw from a generator of their own, so the rows before
    # them keep their inputs
    zoo_gen = torch.Generator().manual_seed(SEED + 2)
    zoo_norms, norms_zoo = {}, dict(norms_e)
    for label in ("G", "N"):
        zc = path_config(ZOO[label])
        zoo_norms[label] = [(tokens, zc.d_model)] * (2 * zc.n_layers) \
            + [(BATCH, zc.d_model)]
        for n, d in sorted(set(zoo_norms[label]) - set(norms_zoo)):
            norms_zoo[(n, d)] = rmsnorm_case(dev, n, d, f32, 1e-5, flush,
                                             zoo_gen)
            print("rmsnorm  ", json.dumps(norms_zoo[(n, d)]), flush=True)
    # path X's 62 calls per prefill, in f32: the encoder's ln1 and ln2 of
    # each of 12 layers and its final norm over 2 x 1500 frames, the
    # decoder's ln1, ln_x and ln2 of each of 12 layers over 2 x 448 tokens,
    # and the final norm; d_model 768 takes the generic loop
    path_x_norms = x_norm_calls(WHISPER)
    norms_x = {}
    for n, d in sorted(set(path_x_norms)):
        norms_x[(n, d)] = rmsnorm_case(dev, n, d, f32, 1e-5, flush, gen)
        print("rmsnorm  ", json.dumps(norms_x[(n, d)]), flush=True)

    path_flash = flash_case(dev, BATCH, SEQ, SEQ, nq, nkv, hd, True, bf16,
                            2e-2, 1e-2, flush, gen)
    print("flash    ", json.dumps(path_flash), flush=True)
    path_m_flash = flash_case(dev, BATCH, SEQ, SEQ, nq, nkv, hd, True, f32,
                              2e-5, 1e-4, flush, gen)
    print("flash    ", json.dumps(path_m_flash), flush=True)
    # path H's local attention at S = window: MQA, 10 heads of 256; f32 on
    # the path, bf16 for the diagnostic and serving
    path_h_flash = {
        dt: flash_case(dev, BATCH, SEQ, SEQ, rg.n_heads, rg.n_kv_heads,
                       rg.resolved_head_dim, True, dt, *tols, flush, gen)
        for dt, tols in ((f32, (2e-5, 1e-4)), (bf16, (2e-2, 1e-2)))}
    for row in path_h_flash.values():
        print("flash    ", json.dumps(row), flush=True)
    # path E's causal MHA, 16 heads of 128, f32
    path_e_flash = flash_case(dev, BATCH, SEQ, SEQ, olmoe.n_heads,
                              olmoe.n_kv_heads, oh, True, f32, 2e-5, 1e-4,
                              flush, gen)
    print("flash    ", json.dumps(path_e_flash), flush=True)
    # path X's decoder self-attention, causal MHA, 12 heads of 64, f32; and
    # the encoder's and the cross-attention's non-causal shapes, which no
    # path binds yet (Sk = 1500 is not a multiple of the KV tile; bf16
    # takes the wgmma path)
    wh, wd = WHISPER, WHISPER.resolved_head_dim
    path_x_flash = flash_case(dev, BATCH, X_TOKENS, X_TOKENS, wh.n_heads,
                              wh.n_kv_heads, wd, True, f32, 2e-5, 1e-4,
                              flush, gen)
    print("flash    ", json.dumps(path_x_flash), flush=True)
    x_non_causal = []
    for sq in (wh.encoder_seq, X_TOKENS):
        for dt, tols in ((f32, (2e-5, 1e-4)), (bf16, (2e-2, 1e-2))):
            x_non_causal.append(flash_case(
                dev, BATCH, sq, wh.encoder_seq, wh.n_heads, wh.n_kv_heads,
                wd, False, dt, *tols, flush, gen))
            print("flash    ", json.dumps(x_non_causal[-1]), flush=True)
    # the zoo paths' causal prefills, f32: L's 1 x 4096 positions (2880
    # patches and 1216 tokens), 32 query heads over 8; A's 2 x 2048, 40
    # over 8 (a group of 5); G's 2 x 2048, 16 MHA heads of 256; N's 2 x
    # 2048, 32 over 4 (a group of 8) at head dim 64
    zoo_flash = {}
    for label in ("L", "A", "G", "N"):
        zc = path_config(ZOO[label])
        b, sq = ZOO_BATCH[label]
        zoo_flash[label] = flash_case(dev, b, sq, sq, zc.n_heads,
                                      zc.n_kv_heads, zc.resolved_head_dim,
                                      True, f32, 2e-5, 1e-4, flush,
                                      zoo_gen if label in ("G", "N")
                                      else gen)
        print("flash    ", json.dumps(zoo_flash[label]), flush=True)
    for case in [(2, 1000, 1000, 4, 2, 128, True),    # ragged S=1000
                 (2, 130, 70, 4, 2, 64, True),        # Sq != Sk, hd 64
                 (2, 512, 512, 4, 2, 64, False),      # non-causal
                 (2, 1000, 1000, 4, 2, 32, True)]:    # hd 32: the mma path
        print("flash    ", json.dumps(
            flash_case(dev, *case, bf16, 2e-2, 1e-2, flush, gen)), flush=True)
    for case in [(1, 512, 512, 8, 1, 128, True),      # MQA
                 (2, 1000, 1000, 4, 2, 128, True),    # ragged S=1000
                 (2, 512, 512, 4, 2, 64, False)]:     # non-causal
        print("flash    ", json.dumps(
            flash_case(dev, *case, f32, 2e-5, 1e-4, flush, gen)), flush=True)

    path_rglru = rglru_case(dev, BATCH, SEQ, rg.d_rnn_resolved, h0=False,
                            time_major=True, flush=flush, gen=gen)
    print("rglru    ", json.dumps(path_rglru), flush=True)
    # the decode continuation's fold: path H's shape from a nonzero state
    path_h_rglru_h0 = rglru_case(dev, BATCH, SEQ, rg.d_rnn_resolved, h0=True,
                                 time_major=True, flush=flush, gen=gen)
    print("rglru    ", json.dumps(path_h_rglru_h0), flush=True)
    rglru_rows = [path_rglru, path_h_rglru_h0]
    for b, s, d, h0 in [(1, 1000, 384, False),        # ragged S; 12 blocks
                        (2, 512, 2560, True),         # nonzero h0
                        (3, 1000, 130, False),        # D = 130: cp_async
                        (1, 33, 5, False)]:           # B*D below 32
        rglru_rows.append(rglru_case(dev, b, s, d, h0=h0, time_major=False,
                                     flush=flush, gen=gen))
        print("rglru    ", json.dumps(rglru_rows[-1]), flush=True)

    # phase P's shapes, f32: the differential suite's python_ast workloads
    # at full width -- flash over one head of 128 at P's positions, causal;
    # RMSNorm over P's rows of 1024; RG-LRU over P's steps of 2560 from a
    # nonzero state (the wrapper's fold), as (1, S, D)
    p_flash = flash_case(dev, 1, P_SCALE["attention"], P_SCALE["attention"],
                         1, 1, hd, True, f32, 2e-5, 1e-4, flush, gen)
    print("flash    ", json.dumps(p_flash), flush=True)
    p_norm = rmsnorm_case(dev, P_SCALE["rmsnorm"], cfg.d_model, f32, 1e-5,
                          flush, gen)
    print("rmsnorm  ", json.dumps(p_norm), flush=True)
    p_rglru = rglru_case(dev, 1, P_SCALE["recurrence"], rg.d_rnn_resolved,
                         h0=True, time_major=False, flush=flush, gen=gen)
    print("rglru    ", json.dumps(p_rglru), flush=True)

    # phase K's loop arm, f32: flash over one causal head of 128 at K1's
    # 2048 positions, RMSNorm over K1's (2048, 1024) residual stream
    k_flash = flash_case(dev, 1, K1_S, K1_S, 1, 1, hd, True, f32, 2e-5, 1e-4,
                         flush, gen)
    print("flash    ", json.dumps(k_flash), flush=True)
    k_norm = rmsnorm_case(dev, K1_S, cfg.d_model, f32, 1e-5, flush, gen)
    print("rmsnorm  ", json.dumps(k_norm), flush=True)

    path_wkv = wkv6_case(dev, 1, WKV_SEQ, 1, WKV_DIM, log_w=None,
                         flush=flush, gen=gen)
    print("wkv6     ", json.dumps(path_wkv), flush=True)
    rwkv = get_config("rwkv6_3b")
    full_wkv = wkv6_case(dev, BATCH, SEQ, rwkv.d_model // rwkv.rwkv_head_dim,
                         rwkv.rwkv_head_dim, log_w=None, flush=flush,
                         gen=gen)
    print("wkv6     ", json.dumps(full_wkv), flush=True)
    for b, s, h, d, log_w in [
            (1, 1000, 2, 32, None),                  # ragged S, D=32
            (1, 1024, 2, 64, STRONG_LOG_W),          # decay at the clamp
            (1, WKV_SEQ, 1, WKV_DIM, STRONG_LOG_W),  # path W's shape, clamp
            (1, WKV_SEQ, 1, WKV_DIM, EXTREME_LOG_W),
            (2, 1000, 3, 16, EXTREME_LOG_W)]:        # D=16, past the clamp
        print("wkv6     ", json.dumps(wkv6_case(
            dev, b, s, h, d, log_w=log_w, flush=flush, gen=gen)),
            flush=True)

    def norm_sums(calls, rows=norms):
        return {"max_abs_err": max(rows[nd]["max_abs_err"] for nd in calls),
                **{k: sum(rows[nd][k] for nd in calls)
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "bound_by": "bytes"}

    row_keys = ("shape", "dtype", "variant", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "same_bytes_ms")
    rms_entry = _entry(
        "rmsnorm", norm_sums(path_norms),
        replaces="src/repro/kernels/rmsnorm.py:23", design=RMSNORM_DESIGN,
        per_block_forward=[list(nd) for nd in path_norms],
        path_r={"per_sublayer_forward": [list(nd) for nd in path_r_norms],
                **norm_sums(path_r_norms)},
        path_m={"calls_per_prefill": len(path_m_norms),
                **norm_sums(path_m_norms, norms_m),
                "shapes": [{k: norms_m[nd][k] for k in row_keys}
                           for nd in sorted(norms_m)]},
        path_h={"calls_per_prefill": len(path_h_norms),
                **norm_sums(path_h_norms, norms_h),
                "shapes": [{k: norms_h[nd][k] for k in row_keys}
                           for nd in sorted(norms_h)]},
        path_e={"calls_per_prefill": len(path_e_norms),
                **norm_sums(path_e_norms, norms_e),
                "shapes": [{k: norms_e[nd][k] for k in row_keys}
                           for nd in sorted(norms_e)]},
        path_f={"calls_per_prefill": len(path_f_norms),
                **norm_sums(path_f_norms, norms_h)},
        path_x={"calls_per_prefill": len(path_x_norms),
                **norm_sums(path_x_norms, norms_x),
                "shapes": [{k: norms_x[nd][k] for k in row_keys}
                           for nd in sorted(norms_x)]},
        path_p={"calls_per_run": 1, **{k: p_norm[k] for k in row_keys}},
        path_k={"calls_per_forward": 1, **{k: k_norm[k] for k in row_keys}},
        **{f"path_{label.lower()}": {
            "calls_per_prefill": len(calls), **norm_sums(calls, norms_zoo),
            "shapes": [{k: norms_zoo[nd][k] for k in row_keys}
                       for nd in sorted(set(calls))]}
           for label, calls in zoo_norms.items()},
        shapes=[{k: norms[nd][k] for k in row_keys}
                for nd in sorted(norms)])
    flash_entry = _entry("flash_attention", path_flash,
                         replaces="src/repro/kernels/flash_attention.py:73",
                         shape=path_flash["shape"], path=path_flash["path"],
                         design=path_flash["design"],
                         block_rel_err=path_flash["block_rel_err"],
                         host_us=path_flash["host_us"],
                         path_m={"calls_per_prefill": cfg.n_layers,
                                 **flash_keys(path_m_flash)},
                         path_h={"calls_per_prefill": rg.n_layers // 3,
                                 **flash_keys(path_h_flash[f32]),
                                 "bf16": flash_keys(path_h_flash[bf16])},
                         path_e={"calls_per_prefill": olmoe.n_layers,
                                 **flash_keys(path_e_flash)},
                         path_x={"calls_per_prefill": WHISPER.n_layers,
                                 **flash_keys(path_x_flash),
                                 "non_causal": [
                                     {**flash_keys(r), "causal": False}
                                     for r in x_non_causal]},
                         path_p={"calls_per_run": 1, **flash_keys(p_flash)},
                         path_k={"calls_per_forward": 1,
                                 **flash_keys(k_flash)},
                         **{f"path_{label.lower()}": {
                             "calls_per_prefill":
                                 PATH_LAYERS[ZOO[label]],
                             **flash_keys(row)}
                            for label, row in zoo_flash.items()})
    rglru_entry = _entry("rglru_scan", path_rglru,
                         replaces="src/repro/kernels/rglru_scan.py:55",
                         path_h={"calls_per_prefill": 2 * (rg.n_layers // 3)
                                 + rg.n_layers % 3,
                                 "note": "the prefill's calls run path R's "
                                         "row (h0 = 0, time-major)",
                                 "h0_row": {k: path_h_rglru_h0[k] for k in (
                                     "shape", "route", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by")}},
                         path_p={"calls_per_run": 1, **{k: p_rglru[k] for k in (
                             "shape", "h0", "route", "max_abs_err", "ms",
                             "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}},
                         shape=path_rglru["shape"], design=RGLRU_DESIGN,
                         load_route=path_rglru["route"],
                         forced_routes=path_rglru["forced_routes"],
                         shapes=[{k: r[k] for k in (
                             "shape", "h0", "time_major", "route",
                             "forced_routes", "max_abs_err", "ms",
                             "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "same_bytes_ms")}
                             for r in rglru_rows])
    wkv_entry = _entry("wkv6", path_wkv, replaces="src/repro/kernels/wkv6.py:68",
                       shape=path_wkv["shape"], design=WKV_DESIGN,
                       launch_us=path_wkv["launch_us"],
                       full_width={k: full_wkv[k] for k in (
                           "shape", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "launch_us")})
    return {"flash_attention": flash_entry, "rmsnorm": rms_entry,
            "rglru_scan": rglru_entry, "wkv6": wkv_entry}


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------


def wkv_app(r, k, v, lw, u):
    """The reference's ``_wkv_app`` (``tests/test_substitution.py``): one
    head's WKV-6 recurrence as a scan, the final state dropped."""
    def step(s, rkvw):
        rt, kt, vt, lwt = rkvw
        kv = kt[:, None] * vt[None, :]
        y = rt @ (s + u[:, None] * kv)
        return torch.exp(lwt)[:, None] * s + kv, y
    _, ys = scan(step, torch.zeros(r.shape[-1], v.shape[-1], device=r.device),
                 (r, k, v, lw))
    return ys


def path_q(dev):
    cfg = get_config("qwen3_0_6b")
    gen = torch.Generator().manual_seed(SEED)
    block = DenseBlock(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    # the residual stream entering the first block of a model whose
    # embeddings are drawn like its other weights, N(0, INIT_STD)
    x = (torch.randn(BATCH, SEQ, cfg.d_model, generator=gen)
         * INIT_STD).to(dev, torch.bfloat16)
    return block, (x,)


def path_r(dev):
    cfg = get_config("recurrentgemma_2b")
    gen = torch.Generator().manual_seed(SEED)
    layer = RecurrentSublayer(cfg, dtype=torch.bfloat16, device=dev,
                              generator=gen)
    x = (torch.randn(BATCH, SEQ, cfg.d_model, generator=gen)
         * INIT_STD).to(dev, torch.bfloat16)
    return layer, (x,)


def path_w(dev):
    """One head of RWKV-6's time mix as the reference draws its inputs:
    r, k, v ~ N(0, 1) and log_w = -exp(clip(w, -8, 2)) (``rwkv.py:238``)
    with w ~ N(-0.6, 1); u ~ N(0, 0.1)."""
    gen = torch.Generator().manual_seed(SEED)
    r, k, v = (torch.randn(WKV_SEQ, WKV_DIM, generator=gen) for _ in range(3))
    lw = -torch.exp(torch.clamp(torch.randn(WKV_SEQ, WKV_DIM, generator=gen)
                                - 0.6, -8.0, 2.0))
    u = torch.randn(WKV_DIM, generator=gen) * 0.1
    return wkv_app, tuple(t.to(dev) for t in (r, k, v, lw, u))


def qwen3_model(dev, dtype):
    """The whole Qwen3-0.6B (28 layers, full width) and 2 x 2048 tokens, as
    :func:`_model_f32` draws them once and keeps them on the card; another
    ``dtype`` is that draw cast, as ``Model.init`` casts it."""
    model, params, tokens = _model_f32(dev, "qwen3_0_6b")
    return model, cast_draw(params, dtype), tokens


def cast_draw(params, dtype, keep=lambda name: False):
    """``params`` (an f32 draw) with every weight but those ``keep`` names
    cast to ``dtype``, as ``Model.init`` would draw them in ``dtype``; the
    draw itself when ``dtype`` is f32."""
    if dtype == torch.float32:
        return params
    memo = {id(w): torch.nn.Parameter(w.detach().to(dtype))
            for name, w in params.named_parameters() if not keep(name)}
    return copy.deepcopy(params, memo)


def path_m(dev):
    model, params, tokens = qwen3_model(dev, PATH_M_DTYPE)
    plan = REFERENCE_PLAN.replace(compute_dtype=str(PATH_M_DTYPE)[6:])
    return (lambda tok: model.prefill(params, {"tokens": tok}, plan),
            (tokens,))


#: two models kept: paths M and H, their bf16 diagnostics and their
#: serving interleave, and each redraw took 7-8 s of host time on the card's
#: machine
@functools.lru_cache(maxsize=2)
def _model_f32(dev, arch: str):
    """``arch`` at its published widths (at its path's depth,
    :func:`path_config`), weights drawn in f32 in the reference's
    distributions on the card, from a CUDA generator seeded ``SEED`` (the
    host's generator took 6-20 s a model on the card's machine, and would
    take minutes for Llama-4 Scout's two layers); tokens uniform in [0,
    vocab) from the same generator, batch 2 x 2048.  Kept on the card
    until two others are asked for or ``free_models``.

    In a zoo path's model (``ZOO``) every leaf the reference starts at zero
    -- the QKV biases, the projector's biases, the norm scales -- is
    redrawn N(0, 0.1), so that one a program drops shows; its inputs are
    ``Model.demo_batch``'s from a CPU generator seeded ``SEED + 1``
    (``ZOO_BATCH``; a VLM's patch features in bf16), a dict."""
    cfg = path_config(arch)
    zoo = arch in ZOO.values()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(gen, dtype=torch.float32, device=dev)
    if zoo:
        with torch.no_grad():
            for w in params.parameters():
                if not w.any():
                    w.normal_(0.0, 0.1, generator=gen)
    torch.cuda.synchronize()
    print(f"{arch}: {sum(w.numel() for w in params.parameters())} "
          f"parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if zoo:
        label = next(k for k, a in ZOO.items() if a == arch)
        batch = model.demo_batch(torch.Generator().manual_seed(SEED + 1),
                                 *ZOO_BATCH[label], device=dev)
        return model, params, {k: v for k, v in batch.items()
                               if k != "labels"}
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen,
                           device=dev)
    return model, params, tokens


def zoo_path(label: str):
    """Path ``label``'s program maker: the zoo model's prefill under the
    path's plan (``ZOO_PLAN``), its inputs as positional arguments (a
    VLM's tokens, then its patch features)."""
    def make(dev):
        model, params, inputs = _model_f32(dev, ZOO[label])
        keys, plan = list(inputs), ZOO_PLAN[label]
        return (lambda *xs: model.prefill(params, dict(zip(keys, xs)), plan),
                tuple(inputs.values()))
    return make


def recurrentgemma_model(dev, dtype):
    """RecurrentGemma-2B at full width and 3 of its 26 layers and 2 x 2048
    tokens (= the local window), as :func:`_model_f32` draws them once and
    keeps them on the card; another ``dtype`` is that draw cast as
    ``Model.init`` casts it (every weight but the RG-LRU's ``lam``)."""
    model, params, tokens = _model_f32(dev, "recurrentgemma_2b")
    return model, cast_draw(params, dtype,
                            lambda name: name.endswith(".lam")), tokens


def path_h(dev):
    model, params, tokens = recurrentgemma_model(dev, torch.float32)
    check(SEQ == model.cfg.local_window,
          "path H: the causal flash kernel binds local attention only at "
          "S = window")
    plan = REFERENCE_PLAN.replace(compute_dtype="float32")
    return (lambda tok: model.prefill(params, {"tokens": tok}, plan),
            (tokens,))


#: path E's plan: the reference's production MoE (capacity-limited
#: dispatch), f32
PATH_E_PLAN = REFERENCE_PLAN.replace(compute_dtype="float32",
                                     moe_impl="scatter_ep")


def path_e(dev):
    model, params, tokens = _model_f32(dev, "olmoe_1b_7b")
    return (lambda tok: model.prefill(params, {"tokens": tok}, PATH_E_PLAN),
            (tokens,))


#: path F's plan: the chunked WKV form, f32
PATH_F_PLAN = REFERENCE_PLAN.replace(compute_dtype="float32",
                                     wkv_impl="chunked")


def path_f(dev):
    model, params, tokens = _model_f32(dev, "rwkv6_3b")
    return (lambda tok: model.prefill(params, {"tokens": tok}, PATH_F_PLAN),
            (tokens,))


#: path X's plan: f32, as for M, H and E
PATH_X_PLAN = REFERENCE_PLAN.replace(compute_dtype="float32")
#: the zoo paths' plans: f32, and A under the production MoE, as path E
ZOO_PLAN = {"L": PATH_X_PLAN, "B": PATH_X_PLAN, "A": PATH_E_PLAN,
            "G": PATH_X_PLAN, "N": PATH_X_PLAN}


def whisper_model(dev, dtype):
    """The whole Whisper-small (12 encoder and 12 decoder layers at full
    width; weights drawn from seed 0 in the reference's distributions in
    f32 and kept on the card; another ``dtype`` is that draw cast whole, as
    ``Model.init`` would draw it) and its inputs from seed 1, as
    ``Model.demo_batch`` draws them: 2 x 448 tokens uniform in [0, vocab)
    and 2 x 1500 stub frames ~ N(0, 1) in bf16 (the reference's input
    specs)."""
    model, params, _ = _model_f32(dev, "whisper_small")
    if dtype != torch.float32:
        params = copy.deepcopy(params).to(dtype)
    batch = model.demo_batch(torch.Generator().manual_seed(SEED + 1), BATCH,
                             X_TOKENS, device=dev)
    return model, params, {k: batch[k] for k in ("tokens", "frames")}


def causal_sites(params):
    """A matched site's variant by its module, as path X binds it:
    ``cuda`` at a norm or a causal attention core, ``ref`` at a non-causal
    one (both packages' binders compute attention causal whatever the
    region's mask)."""
    def variant(module_path: str) -> str:
        module = params.get_submodule(module_path.removeprefix("params."))
        return "cuda" if getattr(module, "causal", True) else "ref"
    return variant


def path_x(dev):
    model, params, inputs = whisper_model(dev, torch.float32)
    return (lambda tok, fr: model.prefill(params, {"tokens": tok,
                                                   "frames": fr},
                                          PATH_X_PLAN),
            (inputs["tokens"], inputs["frames"]), causal_sites(params))


def whisper_sites(cfg) -> list:
    """Path X's matched sites in program order, each (module path,
    pattern, the variant the forced plan must bind): each encoder layer's
    ln1, self-attention (non-causal: ``ref``) and ln2; the encoder's final
    norm; each decoder layer's ln1, self-attention (causal: ``cuda``),
    ln_x, cross-attention (non-causal: ``ref``) and ln2; the final norm."""
    norm, attn = "rmsnorm", "softmax_attention"
    out = []
    for i in range(cfg.n_encoder_layers):
        p = f"params.enc_blocks.{i}."
        out += [(p + "ln1", norm, "cuda"), (p + "attn", attn, "ref"),
                (p + "ln2", norm, "cuda")]
    out.append(("params.enc_final_norm", norm, "cuda"))
    for i in range(cfg.n_layers):
        p = f"params.blocks.{i}."
        out += [(p + "ln1", norm, "cuda"), (p + "attn", attn, "cuda"),
                (p + "ln_x", norm, "cuda"), (p + "cross", attn, "ref"),
                (p + "ln2", norm, "cuda")]
    out.append(("params.final_norm", norm, "cuda"))
    return out


def free_models() -> None:
    """Drop the full-depth models kept on the card, so the next path's peak
    memory is its own.  Dynamo's caches are reset too: the export frontend
    releases what its exports compiled (``ROADMAP.md`` §3 item 6), and the
    reset drops what the scans run eagerly (serving) compiled."""
    _model_f32.cache_clear()
    torch._dynamo.reset()
    gc.collect()
    torch.cuda.empty_cache()


#: path M plans the prefill in f32: in bf16 one rounding flip of a
#: normalized key (|k| up to ~4, a bf16 step of 0.0156 there) fails the
#: verifier's 1e-2 (see the bf16 diagnostic)
PATH_M_DTYPE = torch.float32
#: sites of path M: attention and four norms a layer, and the final norm
PATH_M_SITES = ([("softmax_attention", "cuda")] * 28
                + [("rmsnorm", "cuda")] * (4 * 28 + 1))

#: sites of path H: a recurrence or a local attention a layer (6 and 2 of
#: 8), two norms a sublayer and the final norm
_H_KINDS = [path_config("recurrentgemma_2b").block_pattern[i % 3]
            for i in range(PATH_LAYERS["recurrentgemma_2b"])]
PATH_H_SITES = ([("linear_recurrence", "cuda")] * _H_KINDS.count("rglru")
                + [("softmax_attention", "cuda")]
                * _H_KINDS.count("local_attn")
                + [("rmsnorm", "cuda")] * (2 * len(_H_KINDS) + 1))

#: sites of path E: attention and four norms a layer, and the final norm;
#: no router, expert or MoE region
E_LAYERS = PATH_LAYERS["olmoe_1b_7b"]
PATH_E_SITES = ([("softmax_attention", "cuda")] * E_LAYERS
                + [("rmsnorm", "cuda")] * (4 * E_LAYERS + 1))
#: sites of path F: the final norm binds; the embedding's and each
#: layer's two LayerNorms (x, scale, bias) and each layer's multi-head WKV
#: scan match and are refused
PATH_F_SITES = ([("rmsnorm", "cuda")]
                + [("rmsnorm", "ref")] * (1 + 2 * PATH_LAYERS["rwkv6_3b"])
                + [("wkv_recurrence", "ref")] * PATH_LAYERS["rwkv6_3b"])
#: sites of path X: 62 norms and 12 causal self-attentions on the
#: kernels, the 12 encoder and 12 cross-attentions on ``ref``
PATH_X_SITES = [(p, v) for _, p, v in whisper_sites(WHISPER)]
#: paths whose matched sites the export must find in this program order
PATH_SITE_ORDER = {"X": [(m, p) for m, p, _ in whisper_sites(WHISPER)]}
#: sites of the zoo paths L, B, A, G and N: an attention and two norms a
#: layer (no q/k norms in these configs) and the final norm; A's router
#: and shared expert, like E's MoE, and L's projector match nothing
PATH_ZOO_SITES = {
    label: [("softmax_attention", "cuda")] * PATH_LAYERS[arch]
    + [("rmsnorm", "cuda")] * (2 * PATH_LAYERS[arch] + 1)
    for label, arch in ZOO.items()}

PATHS = {
    # label: (program maker, GA population x generations, expected (pattern,
    # variant) bindings of the forced all-kernel plan, the kernels it runs,
    # profiled iterations)
    "Q": (path_q, (8, 4), [("rmsnorm", "cuda")] * 4
          + [("softmax_attention", "cuda")], ("flash_attention", "rmsnorm"),
          10),
    "R": (path_r, (8, 4), [("linear_recurrence", "cuda")]
          + [("rmsnorm", "cuda")] * 2, ("rglru_scan", "rmsnorm"), 3),
    "W": (path_w, (6, 3), [("wkv_recurrence", "cuda")], ("wkv6",), 2),
    "M": (path_m, (8, 4), PATH_M_SITES, ("flash_attention", "rmsnorm"), 3),
    "H": (path_h, (4, 2), PATH_H_SITES,
          ("flash_attention", "rmsnorm", "rglru_scan"), 1),
    "E": (path_e, (6, 3), PATH_E_SITES, ("flash_attention", "rmsnorm"), 1),
    "F": (path_f, (4, 2), PATH_F_SITES, ("rmsnorm",), 1),
    "X": (path_x, (6, 3), PATH_X_SITES, ("flash_attention", "rmsnorm"), 3),
    **{label: (zoo_path(label), (4, 2), PATH_ZOO_SITES[label],
               ("flash_attention", "rmsnorm"), 1) for label in ZOO},
}
#: timing repeats of each chromosome (after its warm-up run) on the
#: full-depth paths, cut from 3 for the run's time: their forwards take
#: 0.05-3 s, well above the host clock's spread
PATH_REPEATS = dict.fromkeys("MHEFXLBAGN", 1)
#: paths whose all-reference and all-kernel programs phase J holds against
#: the eager port (H at its ``PATH_LAYERS`` depth)
J_PATHS = ("Q", "R", "W", "M", "H")
#: paths with top-k routing, each with its model and plan: the reference
#: must repeat bit for bit, and the forced plan verifies or a routing
#: diagnostic explains why not
ROUTED = {"E": ("olmoe_1b_7b", PATH_E_PLAN),
          "A": (ZOO["A"], ZOO_PLAN["A"])}
#: paths whose search is seeded with the forced chromosome
#: (``Offloader.search``'s ``extra_seeds``), and on which no chromosome at
#: all may fail with an error
SEEDED = {"H", "E", "F", "X", "L", "B", "A", "G", "N"}


#: the kernel each pattern's ``cuda`` variant launches
PATTERN_KERNEL = {"softmax_attention": "flash_attention",
                  "rmsnorm": "rmsnorm", "linear_recurrence": "rglru_scan",
                  "wkv_recurrence": "wkv6"}

#: the RMSNorm variants each path's widths select (path Q: d_model 1024 and
#: the q/k-norms' head_dim 128; path R: d_model 2560, all bf16), and the
#: RG-LRU route path R's time-major views take
PATH_VARIANTS = {"Q": {"d1024_l32", "d128_l16"}, "R": {"d2560_l32"},
                 "M": {"d1024_l32", "d128_l32"}, "H": {"d2560_l32"},
                 "E": {"generic_l32", "d128_l32"}, "F": {"d2560_l32"},
                 "X": {"generic_l32"}, "K": {"d1024_l32"},
                 "L": {"generic_l32"}, "B": {"d2560_l32"},
                 "A": {"generic_l32"}, "G": {"generic_l32"},
                 "N": {"generic_l32"},
                 "V": {"d1024_l32", "d128_l16"},
                 "D": {"d1024_l32", "d128_l16"}}
#: RMSNorm launches by variant of one forward of the forced plan, where
#: a path pins them: path E's ln1, ln2 and final norm at d 2048 take the
#: generic loop, its q- and k-norms the d = 128 instance; path X's 62
#: norms at d 768 all take the generic loop
PATH_VARIANT_COUNTS = {"E": {"generic_l32": 2 * E_LAYERS + 1,
                             "d128_l32": 2 * E_LAYERS},
                       "X": {"generic_l32": len(x_norm_calls(WHISPER))},
                       **{label: {next(iter(PATH_VARIANTS[label])):
                                  2 * PATH_LAYERS[arch] + 1}
                          for label, arch in ZOO.items()}}
PATH_ROUTES = {"R": {"tma"}, "H": {"tma"}}
#: the flash path each path's launches take (paths M, H, E and X in f32,
#: path H at head dim 256: ``scalar``)
PATH_FLASH = {"Q": "wgmma", "M": "scalar", "H": "scalar", "E": "scalar",
              "X": "scalar", "K": "scalar", "V": "wgmma", "D": "wgmma",
              "L": "scalar", "B": "scalar", "A": "scalar", "G": "scalar",
              "N": "scalar"}


def sub_counts() -> dict:
    """Each kernel's launches by flash path, RMSNorm variant, RG-LRU route."""
    return {"flash_attention": dict(ops.flash_attention.launches_by_path),
            "rmsnorm": dict(ops.rmsnorm.launches_by_variant),
            "rglru_scan": dict(ops.rglru_scan.launches_by_route)}


def counts_since(before: tuple) -> tuple:
    """The launches, and their splits (:func:`sub_counts`), made since
    ``before = (ops.launch_counts(), sub_counts())``: a phase reads a part
    of its run this way without setting the counts to 0."""
    (b, b_sub), a, a_sub = before, ops.launch_counts(), sub_counts()
    return ({k: n - b[k] for k, n in a.items()},
            {name: {k: n - b_sub[name].get(k, 0) for k, n in split.items()}
             for name, split in a_sub.items()})


def check_sub_counts(label, what, counts, launches, kernels) -> None:
    """Every launch in ``counts`` went through the flash path, RMSNorm
    variants and RG-LRU route that path ``label``'s shapes select."""
    want = {"flash_attention": {PATH_FLASH.get(label)},
            "rmsnorm": PATH_VARIANTS.get(label),
            "rglru_scan": PATH_ROUTES.get(label)}
    for name in kernels:
        if want.get(name) in (None, {None}):
            continue
        got = {k for k, n in counts[name].items() if n}
        check(got == want[name] and sum(counts[name].values())
              == launches[name],
              f"path {label}: {what}: {name} launches went through "
              f"{counts[name]}, not {sorted(want[name])}")


def forced_chromosome(graph, coding, site_variant=None) -> tuple:
    """Every matched site on its ``cuda`` variant (with ``site_variant``,
    on the variant it names for the site's module, ``cuda`` or ``ref``),
    every other site -- a function block's gene too, so that its members
    bind the kernels -- on ``ref``."""
    bits = []
    for s in coding.sites:
        region = graph.by_name(s.region)
        if not region.meta.get("pattern") or s.members:
            bits.append(0)              # unmatched, or a function block
            continue
        variant = site_variant(region.meta["module"]) if site_variant \
            else "cuda"
        bits.append({"cuda": 2, "ref": 0}[variant])
    return tuple(bits)


def check_site_order(label, graph, coding) -> None:
    """Path ``label``'s matched sites are the ones it expects, in program
    order (``PATH_SITE_ORDER``)."""
    if label not in PATH_SITE_ORDER:
        return
    found = [(r.meta["module"], r.meta["pattern"]) for r in
             (graph.by_name(s.region) for s in coding.sites)
             if r.meta.get("pattern") and not r.meta.get("block_members")]
    want = PATH_SITE_ORDER[label]
    first = next((i for i, (f, w) in enumerate(itertools.zip_longest(
        found, want)) if f != w), None)
    if first is not None:
        check(False, f"path {label}: the export found {len(found)} matched "
                     f"sites ({dict(collections.Counter(p for _, p in found))})"
                     f", not the {len(want)} expected in program order; site "
                     f"{first}: found {found[first:first + 1]}, expected "
                     f"{want[first:first + 1]}")


def phase_path(label, dev, scratch: Path, store: Path = None) -> tuple:
    """Path ``label``; with ``store`` (``SERVICE_PATHS``) planned through a
    ``PlanService`` on that directory, which keeps the plan and the
    winner's output (``M_WINNER_OUT``) for phase V2."""
    make, (pop, gens), expected, kernels, iters = PATHS[label]
    torch.cuda.reset_peak_memory_stats()
    target, args, *rule = make(dev)
    site_variant = rule[0] if rule else None
    resident_gb = torch.cuda.memory_allocated() / 1e9
    with torch.no_grad():
        reference = target(*args)
    torch.cuda.synchronize()
    first = pytree.tree_leaves(reference)[0]
    print(f"path {label} output: {len(pytree.tree_leaves(reference))} "
          f"tensor(s), the first {tuple(first.shape)} max |y| "
          f"{first.float().abs().max().item():.4f}", flush=True)
    if label in ROUTED:
        # the fitness's baseline must not move under top-k routing
        with torch.no_grad():
            again = target(*args)
        check(all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(reference), pytree.tree_leaves(again))),
            f"path {label}: two runs of the all-reference program differ")
        del again

    ga = GAConfig(population=pop, generations=gens, seed=SEED,
                  cache_dir=str(scratch))
    config = OffloadConfig(device=str(dev), ga=ga,
                           repeats=PATH_REPEATS.get(label, 3),
                           options={"example_args": args},
                           log=lambda s: print(f"  plan {label}:", s,
                                               flush=True))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    offloader = Offloader(config)
    if label in SEEDED:
        ctx = offloader.prepare(target)
        check_site_order(label, ctx.graph, ctx.coding)
        res = offloader.search(ctx, extra_seeds=[
            forced_chromosome(ctx.graph, ctx.coding, site_variant)])
    elif store is not None:
        # the search runs on the service's pool thread
        with PlanService(str(store), config=config) as svc:
            served = svc.plan(target)
        check(svc.stats.searches == 1 and not served.warm,
              f"path {label}: the service did not search: "
              f"{svc.stats.as_dict()}")
        print(f"path {label} through the planning service:",
              json.dumps(svc.stats.as_dict()), flush=True)
        res = served.search
    else:
        res = offloader.plan(target)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    planned_gb = torch.cuda.memory_allocated() / 1e9
    launches = ops.launch_counts()
    search_counts = sub_counts()
    flash_paths = search_counts["flash_attention"]
    print(f"path {label} launches:", json.dumps(launches),
          "flash by kernel path:", json.dumps(flash_paths),
          "rmsnorm by variant:", json.dumps(search_counts["rmsnorm"]),
          "rglru by route:", json.dumps(search_counts["rglru_scan"]),
          flush=True)
    for name in kernels:
        check(launches[name] > 0,
              f"path {label}: the {name} kernel was never launched by the "
              f"search")
    check_sub_counts(label, "the search", search_counts, launches, kernels)

    check(res.verification["verified"], f"path {label}: the winning plan "
                                        f"did not verify")
    out = res.artifact(*args)
    torch.cuda.synchronize()
    v = verify(reference, out, rtol=1e-2, atol=1e-2)
    check(pytree.tree_leaves(out)[0].device.type == "cuda" and v.ok,
          f"path {label}: the plan's artifact differs from the program: {v}")
    if store is not None:
        torch.save([t.detach().cpu() for t in pytree.tree_leaves(out)],
                   store / M_WINNER_OUT)

    engine = res.details["engine"]
    matched = {s.region: res.graph.by_name(s.region).meta.get("pattern")
               for s in res.coding.sites}
    check_site_order(label, res.graph, res.coding)
    forced_bits = forced_chromosome(res.graph, res.coding, site_variant)
    t0 = time.perf_counter()
    forced = engine.substitute(res.coding.decode(forced_bits))
    substitute_s = time.perf_counter() - t0
    blocks = {r.name: r for r in block_regions(res.graph)}
    chosen = [(c.pattern, c.chosen) for c in forced.report.choices
              if c.pattern and c.region not in blocks]
    check(sorted(chosen) == sorted(expected),
          f"path {label}: forced all-kernel plan did not bind the kernels: "
          f"{chosen} ({forced.report.fallbacks})")
    ops.reset_launch_counts()
    forced_out = forced(*args)
    torch.cuda.synchronize()
    forced_launches = {k: n for k, n in ops.launch_counts().items() if n}
    forced_counts = sub_counts()
    want = {name: sum(1 for p, v in expected
                      if v == "cuda" and PATTERN_KERNEL[p] == name)
            for name in kernels}
    check(forced_launches == want,
          f"path {label}: one forward of the forced all-kernel plan launched "
          f"{forced_launches}, not {want}")
    check_sub_counts(label, "one forward of the forced all-kernel plan",
                     forced_counts, forced_launches, kernels)
    if label in PATH_VARIANT_COUNTS:
        got = {k: n for k, n in forced_counts["rmsnorm"].items() if n}
        check(got == PATH_VARIANT_COUNTS[label],
              f"path {label}: one forward of the forced all-kernel plan ran "
              f"RMSNorm by {got}, not {PATH_VARIANT_COUNTS[label]}")
    # the verifier as the fitness runs it: the reference kept on the card,
    # each pair compared there in f64; and as the parent commit ran it:
    # the reference as f64 host arrays, the candidate copied over
    t0 = time.perf_counter()
    fv = verify(reference, forced_out, rtol=1e-2, atol=1e-2)
    verify_s = time.perf_counter() - t0
    reference64 = pytree.tree_map(
        lambda x: x.detach().to("cpu", torch.float64).numpy(), reference)
    t0 = time.perf_counter()
    fv_host = verify(reference64, forced_out, rtol=1e-2, atol=1e-2)
    verify_host_s = time.perf_counter() - t0
    del reference64
    check((fv_host.ok, fv_host.max_abs, fv_host.max_rel)
          == (fv.ok, fv.max_abs, fv.max_rel),
          f"path {label}: the verifier on the card ({fv}) and on the host "
          f"({fv_host}) disagree")
    print(f"path {label} forced all-kernel plan: {len(chosen)} sites bound, "
          f"max_abs {fv.max_abs} max_rel {fv.max_rel}, one forward "
          f"launched {json.dumps(forced_launches)} by "
          f"{json.dumps(forced_counts)}; verify {verify_s:.4f} s on the "
          f"card, {verify_host_s:.4f} s on the host", flush=True)
    routing = None
    if label in ROUTED:
        routing = routing_outcome(label, dev, reference, forced_out, fv)
    else:
        check(fv.ok, f"path {label}: forced all-kernel plan differs from "
                     f"the program: {fv}")

    # every measured chromosome, from the search's measurement journal
    records = MeasurementCache(str(scratch),
                               _journal_fingerprint(scratch)).load()
    kernel_errors, verify_fails = [], {}
    for bits, ev in records.items():
        impl = res.coding.decode(bits)
        if "error" in ev.detail and (label in SEEDED or any(
                engine.resolved_impl(r, i) == "cuda"
                for r, i in impl.items())):
            kernel_errors.append(("".join(map(str, bits)), ev.detail["error"]))
        if "verify" in ev.detail:
            verify_fails["".join(map(str, bits))] = ev.detail["verify"]
    check(not kernel_errors,
          f"path {label}: chromosomes selecting a kernel failed: "
          f"{kernel_errors}")
    per_site = {f"{s.region}:{matched[s.region] or '-'}":
                res.artifact.report.substituted.get(s.region, "ref")
                for s in res.coding.sites}
    summary = {
        "timed": "captured CUDA graphs (replays)",
        "speedup": res.speedup, "best_s": res.best.time_s,
        "baseline_s": res.baseline.time_s,
        "best_bits": "".join(map(str, res.best.bits)),
        "chosen": per_site,
        "measurements": res.ga.evaluations,
        "s_per_chromosome": res.ga.eval_wall_s / max(res.ga.evaluations, 1),
        "plan_s": plan_s,
        "overlap": {"compile_overlap_saved_s":
                    res.ga.compile_overlap_saved_s,
                    "overlap_est_saved_s": res.ga.overlap_est_saved_s,
                    "overlap_disabled": res.ga.overlap_disabled},
        "fnblock": {name: {"pattern": r.meta["pattern"],
                           "variants": list(r.alternatives[1:]),
                           "members": list(r.meta["block_members"]),
                           "chosen": res.artifact.report.substituted.get(
                               name, "ref")}
                    for name, r in blocks.items()},
        "n_fnblock": len(blocks),
        "verify_failures": verify_fails,
        "n_verify_failures": len(verify_fails),
        "artifact_max_abs": v.max_abs, "forced_max_abs": fv.max_abs,
        "forced_max_rel": fv.max_rel, "forced_launches": forced_launches,
        "substitute_s": substitute_s, "verify_s": verify_s,
        "verify_host_s": verify_host_s,
        "graph_nodes": len(engine.gm.graph.nodes),
        "gene_length": res.coding.length,
        "sites": dict(collections.Counter(
            p for p in matched.values() if p)),
        "launches": launches, "flash_launches_by_kernel_path": flash_paths,
        "rmsnorm_launches_by_variant": search_counts["rmsnorm"],
        "rglru_launches_by_route": search_counts["rglru_scan"],
        "routing": routing}
    if label in CAUSAL_FINDING:
        summary["causal_binder"] = causal_binder_finding(
            label, res, engine, args, reference)
    print(f"path {label}:", json.dumps(summary), flush=True)
    unsubstituted = engine.substitute({})
    measured = {}
    if label in J_PATHS:
        j = {name: capture_entry(
                f"{label} {name}", fn, args, new_inputs(args), iters,
                lambda fn=fn: list(fn.captured.programs.values()),
                eager_iters=min(iters, 3))
             for name, fn in (("baseline (all ref)", unsubstituted),
                              ("all kernels", forced))}
        print_capture(label, j)
        measured = {name: e["captured"] for name, e in j.items()}
    for name, fn in (("baseline (all ref)", unsubstituted),
                     ("plan winner", res.artifact), ("all kernels", forced)):
        if name not in measured:
            measured[name] = where_time_goes(fn, args, iters)
        print(f"where the time goes, path {label}, {name}:",
              json.dumps(measured[name]), flush=True)
    summary["roofline"] = path_rooflines(
        label, {"baseline (all ref)": unsubstituted, "all kernels": forced},
        measured, sum(v == "cuda" for _, v in expected))
    print(f"path {label} device memory: {resident_gb:.2f} GB held when the "
          f"program is made, {planned_gb:.2f} GB after planning, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return launches, {k: search_counts[k] for k in kernels
                      if k in search_counts}, {
        k: summary[k] for k in ("plan_s", "n_fnblock", "fnblock", "overlap",
                                "measurements", "gene_length", "roofline")}


def path_rooflines(label, programs: dict, measured: dict,
                   kernel_sites: int) -> dict:
    """Phase C1: each program's roofline on one H100 from its aten graph
    (``repro_torch.hlo_analysis``, a host-only walk; the all-kernel
    program's kernel nodes charged their registry variants' costs) beside
    its measured device time.  The FLOPs' time is a hard lower bound:
    the device time (profiler, else the CUDA-event span) must reach it;
    the bytes' time is printed only (L2 holds activations that the
    analyzer counts as HBM traffic)."""
    out = {}
    for name, prog in programs.items():
        t0 = time.perf_counter()
        cost = hlo_analysis.analyze_hlo(prog, 1)
        roof = rl.analyze(prog)
        analyze_s = time.perf_counter() - t0
        kernels = [n.target.cost for n in prog.gm.graph.nodes
                   if isinstance(getattr(n.target, "cost", None),
                                 rl.KernelCost)]
        check(not cost.uncosted, f"C1 path {label} {name}: nodes without a "
                                 f"cost: {cost.uncosted}")
        want = kernel_sites if name == "all kernels" else 0
        check(len(kernels) == want,
              f"C1 path {label} {name}: {len(kernels)} kernel nodes costed, "
              f"not {want}")
        m = measured[name]
        device_ms = m["device_ms"] or m["event_ms"]
        row = {"compute_ms": roof.compute_s * 1e3,
               "memory_ms": roof.memory_s * 1e3,
               "step_ms": roof.step_s * 1e3, "dominant": roof.dominant,
               "flops": roof.flops, "flops_by_dtype": roof.flops_by_dtype,
               "hbm_bytes": roof.hbm_bytes, "kernel_nodes": len(kernels),
               "kernel_flops": sum(k.flops for k in kernels),
               "kernel_bytes": sum(k.bytes for k in kernels),
               "device_ms": m["device_ms"], "event_ms": m["event_ms"],
               "device_over_step": device_ms / (roof.step_s * 1e3)
               if roof.step_s else None, "analyze_s": analyze_s}
        print(f"C1 path {label} roofline, {name}:", json.dumps(row),
              flush=True)
        check(device_ms >= roof.compute_s * 1e3,
              f"C1 path {label} {name}: device {device_ms} ms below the "
              f"FLOPs' time {roof.compute_s * 1e3} ms")
        out[name] = row
    return out


#: paths that run the finding of the causal binder
CAUSAL_FINDING = {"X"}


def causal_binder_finding(label, res, engine, args, reference) -> dict:
    """Both packages' attention binders compute a causal attention
    whatever the region's mask.  Two chromosomes of path ``label``, each
    run once, unplanned: ``cuda`` at every matched site (every norm and
    every attention core, the non-causal ones too), and ``fused_torch``
    alone at the first encoder self-attention.  Each must bind, run, and
    fail verification (not raise); its largest error by leaf group
    (logits, the self caches k/v, the cross caches xk/xv) is printed."""
    regions = [res.graph.by_name(s.region) for s in res.coding.sites]
    attn = [r for r in regions if r.meta.get("pattern")
            == "softmax_attention"]
    first_enc = next(r for r in attn if ".enc_blocks." in r.meta["module"])
    cases = {
        "cuda at every matched site": (
            tuple(2 if r.meta.get("pattern") else 0 for r in regions),
            {"softmax_attention:cuda": len(attn)}),
        f"fused_torch at {first_enc.meta['module']} alone": (
            tuple(1 if r is first_enc else 0 for r in regions),
            {"softmax_attention:fused_torch": 1})}
    group_of = {"k": "k/v", "v": "k/v", "xk": "xk/xv", "xv": "xk/xv"}
    out = {}
    for what, (bits, must_bind) in cases.items():
        sub = engine.substitute(res.coding.decode(bits))
        bound = dict(collections.Counter(
            f"{c.pattern}:{c.chosen}" for c in sub.report.choices
            if c.pattern and c.chosen != "ref"))
        check(all(bound.get(k) == n for k, n in must_bind.items()),
              f"path {label}: {what}: bound {bound}, not {must_bind}")
        got = sub(*args)
        torch.cuda.synchronize()
        v = verify(reference, got, rtol=1e-2, atol=1e-2)
        groups = {}
        for (path, r), c in zip(pytree.tree_flatten_with_path(reference)[0],
                                pytree.tree_leaves(got), strict=True):
            key = getattr(path[-1], "key", None)
            group = group_of.get(key, "logits" if len(path) == 1 else key)
            err = (c.float() - r.float()).abs().max().item()
            groups[group] = max(groups.get(group, 0.0), err)
        out[what] = {"bound": bound, "verified": v.ok, "max_abs": v.max_abs,
                     "max_rel": v.max_rel, "max_abs_by_leaf_group": groups}
        check(not v.ok, f"path {label}: {what} verified, though the binders "
                        f"compute the non-causal sites causal: {out[what]}")
    print(f"path {label} finding of the causal binder:", json.dumps(out),
          flush=True)
    return out


def routing_flips(model, params, inputs: dict, plan) -> dict:
    """Each layer's top-k experts for every token of a routed path's eager
    prefill (``inputs`` under ``plan``), once as it is and once with the
    forced plan's kernels swapped
    in by forward hooks (each RMSNorm's output replaced by the RMSNorm
    kernel's on its input, each attention's by the flash kernel's): the
    (layer, token) pairs whose top-k set differs, and the first layer where
    one does.  The kernels change each router's input by rounding only.
    (``norm_impl="fused"`` would not: it is the reference's expression op
    for op, bitwise the same output.)"""
    def run(kernels: bool) -> list:
        picks, hooks = [], []
        for blk in params.blocks:
            hooks.append(blk.moe.router.register_forward_hook(
                lambda m, a, out: picks.append(torch.sort(out[1], -1).values)))
        if kernels:
            for m in params.modules():
                if isinstance(m, RMSNorm):
                    hooks.append(m.register_forward_hook(
                        lambda m, a, out: ops.rmsnorm(a[0], m.weight,
                                                      eps=m.eps)))
                elif isinstance(m, Attention):
                    hooks.append(m.register_forward_hook(
                        lambda m, a, out: ops.flash_attention(*a[:3],
                                                              causal=True)))
        try:
            with torch.no_grad():
                model.prefill(params, inputs, plan)
        finally:
            for h in hooks:
                h.remove()
        return picks

    per_layer = [int((a != b).any(-1).sum())
                 for a, b in zip(run(False), run(True), strict=True)]
    return {"routing_flips": sum(per_layer), "flips_by_layer": per_layer,
            "first_flip_layer": next((i for i, n in enumerate(per_layer)
                                      if n), None)}


def routing_outcome(label, dev, reference, forced_out, fv) -> dict:
    """Path ``label``'s verification finding, fixed before any card run:
    (a) the forced all-kernel plan verifies; or (b) it does not, the
    routing diagnostic finds at least one (layer, token) whose top-k set
    the kernels' rounding changed, and the forced plan's layer-0 K and V
    (no routing decision comes before them) are within 1e-4 of the
    reference's.  Fails unless (a) or (b) holds."""
    arch, plan = ROUTED[label]
    model, params, inputs = _model_f32(dev, arch)
    if not isinstance(inputs, dict):
        inputs = {"tokens": inputs}
    n = model.cfg.n_layers
    ref, got = pytree.tree_leaves(reference), pytree.tree_leaves(forced_out)
    check(len(ref) == len(got) == 2 + 2 * n,
          f"path {label}: {len(ref)} output leaves, not logits, {n} (K, V) "
          f"pairs and cache_len")
    kv_err = [[(got[1 + 2 * i + j].float() - ref[1 + 2 * i + j].float())
               .abs().max().item() for j in (0, 1)] for i in range(n)]
    out = {"verified": fv.ok, "max_abs": fv.max_abs, "max_rel": fv.max_rel,
           "logits_max_abs": (got[0] - ref[0]).abs().max().item(),
           "kv_max_abs_by_layer": kv_err,
           **routing_flips(model, params, inputs, plan)}
    if fv.ok:
        out["outcome"] = "a"
    else:
        check(out["routing_flips"] >= 1 and max(kv_err[0]) <= 1e-4,
              f"path {label}: the forced plan does not verify ({fv}) and "
              f"no routing flip explains it: {json.dumps(out)}")
        out["outcome"] = "b"
    print(f"path {label} verification finding:", json.dumps(out), flush=True)
    return out


def moe_dense_forward(dev) -> dict:
    """One all-reference forward of path E's prefill under
    ``dense_onehot`` (every token through all 64 experts): where its time
    goes and the peak device memory."""
    model, params, tokens = _model_f32(dev, "olmoe_1b_7b")
    plan = PATH_E_PLAN.replace(moe_impl="dense_onehot")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = where_time_goes(
            lambda tok: model.prefill(params, {"tokens": tok}, plan),
            (tokens,), 1)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("where the time goes, path E, all reference under dense_onehot:",
          json.dumps(out), flush=True)
    return out


def bf16_diagnostic(dev, label: str, make_model, n_sites: int,
                    site_rule=None) -> dict:
    """Path ``label``'s forced prefill in bf16 against the bf16 reference:
    each output leaf's largest errors (logits, then the decode state's
    leaves).  ``make_model`` gives the model, its weights and its inputs
    (the tokens, or a dict of inputs); the forced plan puts every matched
    site on ``cuda``, or where ``site_rule(params)`` says.  Nothing is
    asserted on the errors."""
    model, params, inputs = make_model(dev, torch.bfloat16)
    if not isinstance(inputs, dict):
        inputs = {"tokens": inputs}
    keys, args = list(inputs), tuple(inputs.values())
    plan = REFERENCE_PLAN
    offloader = Offloader(OffloadConfig(
        device=str(dev), options={"example_args": args}))
    ctx = offloader.prepare(
        lambda *xs: model.prefill(params, dict(zip(keys, xs)), plan))
    engine = ctx.bundle.context["engine"]
    forced_bits = forced_chromosome(ctx.graph, ctx.coding,
                                    site_rule and site_rule(params))
    forced = engine.substitute(ctx.coding.decode(forced_bits))
    bound = sum(c.chosen == "cuda" for c in forced.report.choices)
    check(bound == n_sites,
          f"bf16 diagnostic {label}: {bound} sites bound to the kernels, not "
          f"{n_sites}")
    got = forced(*args)
    torch.cuda.synchronize()
    want = engine.reference()
    per_leaf = {}
    for (path, r), c in zip(pytree.tree_flatten_with_path(want)[0],
                            pytree.tree_leaves(got)):
        lv = verify(r, c, rtol=1e-2, atol=1e-2)
        per_leaf[pytree.keystr(path)] = {"max_abs": lv.max_abs,
                                         "max_rel": lv.max_rel, "ok": lv.ok}
    whole = verify(want, got, rtol=1e-2, atol=1e-2)
    worst = max(per_leaf, key=lambda n: per_leaf[n]["max_abs"])
    out = {"verified": whole.ok, "max_abs": whole.max_abs,
           "max_rel": whole.max_rel, "worst_leaf": worst,
           "leaves_failing": sorted(n for n, lv in per_leaf.items()
                                    if not lv["ok"]),
           "per_leaf": per_leaf}
    print(f"bf16 diagnostic, path {label} forced all-kernel prefill:",
          json.dumps(out), flush=True)
    return out


#: each serving phase's label in phase J
SERVE_LABEL = {"M": "S", "H": "SH", "E": "SE", "F": "SF", "X": "SW",
               "L": "SL", "B": "SB", "A": "SA", "G": "SG", "N": "SN"}


def serve_phase(dev, label: str, make_model, new_tokens: int,
                swap: bool, prompt_len: int = SERVE_PROMPT,
                store: Path = None) -> dict:
    """``Server.generate`` on path ``label``'s model in bf16 under
    ``OFFLOAD_PLAN`` (``make_model`` gives its weights in bf16, or in f32
    for the ``Server`` to cast once, keeping the leaves the reference reads
    in f32): 4 requests of ``prompt_len`` prompt tokens (and the model's
    other inputs, an enc-dec model's frames or a VLM's patch features
    before the prompt, drawn as ``Model.demo_batch`` draws them),
    ``new_tokens`` greedy new tokens.  Two calls give identical tokens; with ``swap``,
    after ``swap_plan(REFERENCE_PLAN)`` the next call gives the tokens of a
    server built on that plan.  Times: a prefill (``max_new = 1``: prefill
    and one sample), the whole call, and the decode time per token between
    them; and where one decode step's time goes (its device launches).
    With ``store`` (and ``swap``), phase V3 serves the same requests from a
    plan stored there (:func:`serve_from_store`)."""
    model, params, _ = make_model(dev, torch.bfloat16)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(SEED + 1)
    prompts = {"tokens": torch.randint(
        0, cfg.vocab, (SERVE_BATCH, prompt_len), generator=gen).to(dev)}
    patches = cfg.vision_patches or 0
    prompts.update((k, v) for k, v in model.demo_batch(
        gen, SERVE_BATCH, prompt_len + patches, device=dev).items()
        if k not in ("tokens", "labels"))
    server = Server(model, params, OFFLOAD_PLAN)
    # warm-up: the prefill and decode programs of both timed capacities
    # are captured before the clock starts
    server.generate(prompts, 1)
    server.generate(prompts, new_tokens)

    def timed(max_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = server.generate(prompts, max_new)
        return toks, time.perf_counter() - t0

    _, prefill_s = timed(1)
    first, total_s = timed(new_tokens)
    second, _ = timed(new_tokens)
    check(first.shape == (SERVE_BATCH, new_tokens),
          f"serve {label}: tokens of shape {first.shape}")
    check(bool(((first >= 0) & (first < cfg.vocab)).all()),
          f"serve {label}: a token outside the vocab")
    check((first == second).all(), f"serve {label}: two greedy calls differ")
    out = {"requests": SERVE_BATCH, "prompt_tokens": prompt_len,
           "prompt_patches": patches,
           "new_tokens": new_tokens, "dtype": "bfloat16",
           "timed": "captured prefill and decode (replays)",
           "prefill_ms": prefill_s * 1e3, "generate_ms": total_s * 1e3,
           "decode_ms_per_token": (total_s - prefill_s) / (new_tokens - 1)
           * 1e3, "tokens_per_s": SERVE_BATCH * new_tokens / total_s}
    out["decode_tokens_per_s"] = SERVE_BATCH / out["decode_ms_per_token"] \
        * 1e3
    if swap:
        server.swap_plan(REFERENCE_PLAN)
        check(server.plan is REFERENCE_PLAN,
              f"serve {label}: swap_plan did not bind")
        swapped = server.generate(prompts, new_tokens)
        fresh = Server(model, params, REFERENCE_PLAN).generate(prompts,
                                                               new_tokens)
        check((swapped == fresh).all(), f"serve {label}: the call after "
                                        f"swap_plan did not run the new plan")
        out["same_tokens_offload_and_reference_plan"] = \
            bool((first == swapped).all())
        if store is not None:
            out["V3"] = serve_from_store(model, params, prompts, new_tokens,
                                         store, fresh)
    # one decode step, where its time goes: eager (the step at the last
    # position of these requests' caches, repeated) and captured
    # (consecutive steps), each against the other (phase J)
    j = decode_capture_entry(server._bound, prompts, prompt_len + patches)
    out[f"decode_step_{'reference' if swap else 'offload'}_plan"] = \
        j["captured"]
    if label in ZOO:
        check(j["bit_equal"], f"phase J {SERVE_LABEL[label]}: the decode "
                              f"step's replay differs from the eager step "
                              f"at {j['differs']}")
    print(f"serve, path {label}:", json.dumps(out), flush=True)
    print_capture(SERVE_LABEL[label], {"decode step": j})
    return out


# ---------------------------------------------------------------------------
# phase T: training
# ---------------------------------------------------------------------------

#: T1: path M's attention, (batch, seq, q heads, kv heads, head dim), at
#: the launcher's 128-key chunks
T1_SHAPE = (BATCH, SEQ, 16, 8, 128)
T_CHUNK = 128
#: T2: the train step at full width, 2 layers, batch 2 x 256
T2_LAYERS, T2_BATCH, T2_SEQ = 2, 2, 256
T_LR = 1e-3
#: T3/T4: the launcher on the whole Qwen3-0.6B, 4 x 2048 tokens a step
T3_BATCH, T3_SEQ = 4, SEQ
T3_ARGS = ["--arch", "qwen3_0_6b", "--no-reduced", "--seq-len", str(T3_SEQ),
           "--global-batch", str(T3_BATCH), "--microbatch", "2",
           "--ckpt-every", "4"]
T3_STEPS, T4_STEPS = 6, 6


def train_flash_backward(dev) -> dict:
    """T1: the chunked attention's custom backward (``_Flash``) against
    autograd through the materialized ``attend_naive`` at path M's
    attention shape, f32, causal: dq, dk and dv within 1e-4, each path's
    forward+backward time (CUDA events, median of 5) and its peak device
    memory above what was allocated before it."""
    from repro_torch.models import attention as A
    from repro_torch.models.plan import ExecPlan

    b, s, hq, hkv, d = T1_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    q = torch.randn(b, s, hq, d, generator=gen).to(dev)
    k, v = (torch.randn(b, s, hkv, d, generator=gen).to(dev)
            for _ in range(2))
    do = torch.randn(b, s, hq, d, generator=gen).to(dev)
    plan = ExecPlan(compute_dtype="float32", attn_kv_chunk=T_CHUNK)
    pos = torch.arange(s, device=dev)

    def fwd_bwd(fn):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*xs, pos, pos, True, 0, plan)
        return torch.autograd.grad(out, xs, do)

    res, grads = {}, {}
    for name, fn in (("flash", A.attend_chunked), ("naive", A.attend_naive)):
        fwd_bwd(fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads[name] = fwd_bwd(fn)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        spans = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fwd_bwd(fn)
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end))
        res[name] = {"fwd_bwd_ms": statistics.median(spans),
                     "peak_bytes": peak}
    res["max_abs_err"] = {
        f"d{n}": compare(f"T1 d{n}", g, w, 1e-4)
        for n, g, w in zip("qkv", grads["flash"], grads["naive"])}
    check(res["flash"]["peak_bytes"] < res["naive"]["peak_bytes"],
          "T1: the custom backward's peak memory is not below the "
          "materialized path's")
    res["shape"] = {"batch_seq_hq_hkv_d": list(T1_SHAPE), "chunk": T_CHUNK,
                    "dtype": "float32", "causal": True}
    return res


def train_step_card_vs_cpu(dev) -> dict:
    """T2: one train step of Qwen3-0.6B at full width and 2 layers under
    the launcher's plan, batch 2 x 256 of the launcher's synthetic data,
    on the card and on the CPU from the same weights, at a constant lr of
    1e-3 (the launcher's schedule gives 0 at step 0), TF32 off: loss and
    gradient norm within 1e-5 relative, every first moment within 1e-4 of
    its norm, every parameter's update within 1e-2 of the CPU update's
    norm (the first AdamW step moves an element by lr * g / (|g| + eps):
    where |g| is within rounding of eps the devices' moves differ by a
    good part of lr, in a few elements)."""
    import dataclasses

    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import launcher_plan
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    check(not torch.backends.cuda.matmul.allow_tf32, "T2: TF32 is on")
    cfg = dataclasses.replace(get_config("qwen3_0_6b"), n_layers=T2_LAYERS)
    model = build_model(cfg)
    plan, _ = launcher_plan(cfg)
    batch = SyntheticLMDataset(DataConfig(
        seq_len=T2_SEQ, global_batch=T2_BATCH, vocab=cfg.vocab,
        seed=0)).batch(0)
    out = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state = init_train_state(model, torch.Generator().manual_seed(SEED),
                                 device=dev if where == "cuda" else "cpu")
        if where == "cpu":
            before = [p.detach().clone() for p in state.params.parameters()]
        step = make_train_step(model, plan, OptimizerConfig(),
                               lambda s: torch.full((), T_LR))
        tb = {k: torch.from_numpy(x).to(state.opt.step.device)
              for k, x in batch.items()}
        state, metrics = step(state, tb)
        float(metrics["loss"])
        out[where] = (state, metrics, time.perf_counter() - t0)
    (gs, gm, gt), (cs, cm, ct) = out["cuda"], out["cpu"]
    res = {"layers": T2_LAYERS, "batch": [T2_BATCH, T2_SEQ],
           "seconds": {"cuda": gt, "cpu": ct}}
    for key in ("loss", "grad_norm"):
        got, want = float(gm[key]), float(cm[key])
        check(abs(got - want) <= 1e-5 * abs(want),
              f"T2: {key} {got} on the card, {want} on the CPU")
        res[key] = {"cuda": got, "cpu": want}
    worst_p, worst_mu = 0.0, 0.0
    for (name, p), w, w0 in zip(gs.params.named_parameters(),
                                cs.params.parameters(), before):
        err = ((p.detach().cpu() - w.detach()).norm()
               / (w.detach() - w0).norm()).item()
        check(err <= 1e-2, f"T2: the update of {name} is off by {err} of "
                           f"its norm")
        mu, wmu = gs.opt.mu[name].cpu(), cs.opt.mu[name]
        rel = ((mu - wmu).norm() / wmu.norm().clamp(min=1e-30)).item()
        check(rel <= 1e-4, f"T2: first moment of {name} off by {rel}")
        worst_p, worst_mu = max(worst_p, err), max(worst_mu, rel)
    res.update(max_update_rel_err=worst_p, max_mu_rel_err=worst_mu)
    return res


def train_launcher(dev, ckpt_dir: Path) -> dict:
    """T3 and T4: the launcher's ``_run`` on the whole Qwen3-0.6B (28
    layers, f32) for 6 steps of 4 x 2048 tokens in 2 microbatches,
    checkpoints every 4 steps under ``ckpt_dir``, then ``--resume --steps
    6``, which restores step 4 and replays steps 4 and 5.  The launcher's
    step is captured: its first step is an eager step and the capture,
    each later one a replay (``s_per_step_median_2_6``); phase J's entry
    holds a replay to the eager step from one state and batch."""
    from repro_torch.launch import train as launch

    res = {"free_disk_bytes_before": shutil.disk_usage(ckpt_dir).free}
    print("T: free disk before T3:", res["free_disk_bytes_before"],
          flush=True)
    argv = T3_ARGS + ["--ckpt-dir", str(ckpt_dir)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launch._run(launch.parse_args(argv + ["--steps", str(T3_STEPS)]))
    torch.cuda.synchronize()
    losses, secs = run.report.losses, run.report.step_seconds
    check(len(losses) == T3_STEPS and all(map(math.isfinite, losses)),
          f"T3: losses {losses}")
    check(losses[-1] < losses[0], f"T3: loss did not fall: {losses}")
    s_step = statistics.median(secs[1:])
    t3 = {"seconds": time.perf_counter() - t0, "first_step_s": secs[0],
          **capture_info(run.step_fn),
          "plan_updates": run.plan_updates,
          "remat": run.plan.remat, "microbatch": run.plan.microbatch,
          "n_params": sum(p.numel() for p in run.state.params.parameters()),
          "losses": losses, "step_seconds": secs,
          "s_per_step_median_2_6": s_step, "tokens_per_s": T3_BATCH * T3_SEQ / s_step,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "checkpoint_saves": run.ckpt.saves}
    print("T3:", json.dumps(t3), flush=True)
    t3["J"] = train_capture_entry("T", run.step_fn, run.step_fn, run.state,
                                  run.batch_fn(T3_STEPS))
    print_capture("T", {"launcher step": t3["J"]})
    del run
    gc.collect()
    torch.cuda.empty_cache()
    t3["device_bytes_reserved_after_free"] = torch.cuda.memory_reserved()

    t0 = time.perf_counter()
    again = launch._run(launch.parse_args(
        argv + ["--steps", str(T4_STEPS), "--resume"]))
    check(again.start_step == 4, f"T4: resumed from {again.start_step}")
    replay = again.report.losses[:2]
    for got, want in zip(replay, losses[4:6], strict=True):
        check(abs(got - want) <= 1e-4 * abs(want),
              f"T4: replayed loss {got}, T3's {want}")
    t4 = {"seconds": time.perf_counter() - t0,
          "restore_s": again.restore_s, "losses": again.report.losses,
          "replayed": replay, "t3_steps_4_5": losses[4:6],
          "checkpoint_saves": again.ckpt.saves}
    print("T4:", json.dumps(t4), flush=True)
    del again
    gc.collect()
    torch.cuda.empty_cache()
    return {"T3": t3, "T4": t4}


def phase_train(dev) -> dict:
    """Phase T; the checkpoints live under ``build/`` and are deleted
    after, whatever happens."""
    t0 = time.perf_counter()
    out = {"T1": train_flash_backward(dev)}
    print("T1:", json.dumps(out["T1"]), flush=True)
    out["T2"] = train_step_card_vs_cpu(dev)
    print("T2:", json.dumps(out["T2"]), flush=True)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="train-", dir=build.BUILD_DIR))
    try:
        out.update(train_launcher(dev, ckpt_dir))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase T: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase C2: a plan chosen by the compiled-artifact cost model
# ---------------------------------------------------------------------------

#: C2: Qwen3-0.6B's train step at full width and depth in f32 over one
#: sequence of 4096 tokens (``reduced``: the reference's global batch of
#: 256 over its 256-chip pod16x16 is one sequence a chip); the reference
#: example's GA 6 x 2 from seed 0, and 3 real steps of a plan
C2_SHAPE = dataclasses.replace(TRAIN_4K, global_batch=1)
C2_GA = (6, 2)
C2_STEPS = 3


def c2_real_steps(dev, model, init: dict, plan, roof: dict,
                  live_bytes: float, j_label: str = None) -> dict:
    """``C2_STEPS`` captured train steps (``jit_step``: the first an eager
    step and the capture, the rest replays) of ``plan`` on the card from
    the weights ``init`` (host copies), fresh AdamW moments, at a constant
    lr: each step's host seconds (synchronized) must reach the plan's
    FLOPs' time (``roof["compute_s"]``); the peak device memory is printed
    beside the cost model's ``live_bytes``; with ``j_label``, phase J's
    entry of the step."""
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime.train import (TrainState, jit_step,
                                           make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = model.param_shapes().to_empty(device=dev)
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(init[k])
    state = TrainState(params, adamw_init(params), None)
    step = jit_step(make_train_step(model, plan, OptimizerConfig(),
                                    lambda s: torch.full((), T_LR,
                                                         device=dev)))
    batch = model.demo_batch(torch.Generator().manual_seed(SEED + 1),
                             C2_SHAPE.global_batch, C2_SHAPE.seq_len,
                             device=dev)
    secs, losses = [], []
    for _ in range(C2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - held
    j = None
    if j_label is not None:
        j = train_capture_entry(j_label, step, step, state, batch)
        print_capture(j_label, {"C2 step": j})
    capture = capture_info(step)
    del state, params, step, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    check(all(map(math.isfinite, losses)), f"C2: losses {losses}")
    for t in secs:
        check(t >= roof["compute_s"],
              f"C2: a step took {t} s, below the FLOPs' time "
              f"{roof['compute_s']} s")
    s_step = statistics.median(secs[1:])
    return {"step_seconds": secs, "s_per_step_median_2_3": s_step,
            **capture, "J": j,
            "losses": losses, "step_s_model": roof["step_s"],
            "compute_s_model": roof["compute_s"],
            "memory_s_model": roof["memory_s"],
            "measured_over_step_s": s_step / roof["step_s"],
            "peak_device_bytes": peak, "live_bytes_model": live_bytes,
            "peak_over_live": peak / live_bytes}


def phase_cost_plan(dev) -> dict:
    """Phase C2: ``Offloader.plan`` of Qwen3-0.6B's config through the
    module frontend's ``lower_fn``: each chromosome's ExecPlan lowers the
    train step (``launch.dryrun.lower_cell``: fake tensors on the card,
    two and three layers traced and extrapolated to 28) and is scored by
    its roofline (``CostModelFitness``), ∞ where it does not fit the
    card's memory.  Every chromosome's terms are printed; then the
    winner, and the all-reference baseline where it differs and fits,
    run ``C2_STEPS`` real steps each."""
    from repro_torch.core.frontends import module_frontend as mfe
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models.plan import ExecPlan

    check(not torch.backends.cuda.matmul.allow_tf32, "C2: TF32 is on")
    t_start = time.perf_counter()
    cfg = get_config("qwen3_0_6b")
    budget = torch.cuda.get_device_properties(dev).total_memory
    mflops = rl.model_flops_train(cfg.param_count(active_only=True),
                                  C2_SHAPE.tokens)
    lower_s, lowered = [], {}

    def lower_fn(plan):
        t0 = time.perf_counter()
        lowered[plan] = lower_cell(cfg, C2_SHAPE, plan)[0]
        lower_s.append(time.perf_counter() - t0)
        return lowered[plan]

    scratch = Path(tempfile.mkdtemp(prefix="plan-C2-", dir=build.BUILD_DIR))
    try:
        pop, gens = C2_GA
        res = Offloader(OffloadConfig(
            device=str(dev),
            ga=GAConfig(population=pop, generations=gens, seed=SEED,
                        cache_dir=str(scratch)),
            log=lambda m: print("  plan C2:", m, flush=True),
            options={"lower_fn": lower_fn, "model_flops": mflops,
                     "hbm_budget": budget,
                     "base_plan": ExecPlan(compute_dtype="float32")})
        ).plan(cfg)
        plan_s = time.perf_counter() - t_start
        records = MeasurementCache(str(scratch),
                                   _journal_fingerprint(scratch)).load()
    finally:
        shutil.rmtree(scratch)
    base = res.details["base_plan"]
    knobs = ("attn_impl", "norm_impl", "mlp_impl", "qkv_fused", "loss_impl",
             "remat", "gather_mode")

    def plan_of(bits):
        return mfe.plan_from_coding(res.graph, res.coding, bits, base)

    def described(bits) -> dict:
        return {k: getattr(plan_of(bits), k) for k in knobs}

    chromosomes = []
    for bits, ev in sorted(records.items()):
        # the journal keeps scalars: the terms come from the artifact
        roof = rl.analyze(lowered[plan_of(bits)].compile(),
                          model_flops_global=mflops).summary() \
            if plan_of(bits) in lowered else {}
        row = {"bits": "".join(map(str, bits)), "plan": described(bits),
               "valid": ev.valid, "time_s": ev.time_s,
               "compute_ms": roof.get("compute_s", float("nan")) * 1e3,
               "memory_ms": roof.get("memory_s", float("nan")) * 1e3,
               "step_ms": roof.get("step_s", float("nan")) * 1e3,
               "dominant": roof.get("dominant"),
               "live_gb": ev.detail.get("live_bytes", float("nan")) / 1e9,
               "fits": ev.detail.get("live_bytes", float("inf")) <= budget,
               "error": ev.detail.get("error")}
        chromosomes.append(row)
        print("C2 chromosome:", json.dumps(row), flush=True)
    check(res.best.valid and res.verification["mode"] == "measured",
          f"C2: no plan fits: {res.best.detail}")
    baseline_plan = mfe.plan_from_coding(res.graph, res.coding,
                                         res.baseline.bits, base)
    out = {"sites": [s.region for s in res.coding.sites],
           "claimed": list(res.block.claimed_regions),
           "hbm_budget_bytes": budget, "model_flops": mflops,
           "measurements": len(records), "lowerings": len(lower_s),
           "lower_s": sum(lower_s), "plan_s": plan_s,
           "winner": {"bits": "".join(map(str, res.best.bits)),
                      "plan": described(res.best.bits),
                      "roofline": res.best.detail["roofline"],
                      "live_bytes": res.best.detail["live_bytes"]},
           "baseline": {"bits": "".join(map(str, res.baseline.bits)),
                        "plan": described(res.baseline.bits),
                        "time_s": res.baseline.time_s,
                        "detail": res.baseline.detail},
           "speedup_model": res.speedup}
    print("C2 plan:", json.dumps(out), flush=True)

    model = build_model(cfg)
    init = dict(model.init(torch.Generator().manual_seed(SEED),
                           device="cpu").named_parameters())
    runs = [("winner", res.best, res.artifact)]
    if res.baseline.bits != res.best.bits and res.baseline.valid:
        runs.append(("baseline", res.baseline, baseline_plan))
    out["real"] = {}
    for name, ev, plan in runs:
        out["real"][name] = c2_real_steps(
            dev, model, init, plan, ev.detail["roofline"],
            ev.detail["live_bytes"], "C2" if name == "winner" else None)
        print(f"C2 real steps, {name}:", json.dumps(out["real"][name]),
              flush=True)
    if len(runs) == 1:
        print("C2: the baseline is the winner's chromosome; its steps are "
              "the winner's", flush=True)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase C2: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase C3: train steps through a scan, costed and run
# ---------------------------------------------------------------------------

#: C3: RecurrentGemma-2B (the RG-LRU ``assoc`` scan) and RWKV-6-3B (the WKV
#: ``chunked`` scan) under their production plans in f32 over 2 x 4096
#: tokens in the plans' 2 microbatches: the dry run's train_4k records at
#: full depth on one card, and with ``--only C`` on ``pod16x16`` too (cut
#: from the full run for its time) (C3a), and 3 real steps at
#: ``PATH_LAYERS``' depth, traced in the dry run alike (C3b)
C3_ARCHS = ("recurrentgemma_2b", "rwkv6_3b")
C3_MESHES = ("h100x1", "pod16x16")
#: the work a mesh record's ranks do together per token over the one-card
#: record's, FLOPs x devices / 6 N D on ``pod16x16`` over it on one card:
#: the sites whose heads ``model`` does not divide (10 and 40 over 16) run
#: whole on each rank, as the reference's do
#: (``tests/test_torch_mesh_parity.py`` holds each site's share to the
#: reference's).  Read from the CPU traces of both records (torch 2.13)
#: before the card run; a record may exceed it by the oracle's 5%
C3_MESH_WORK = {"recurrentgemma_2b": 2.490, "rwkv6_3b": 2.198}
C3_MESH_TOL = 1.05
C3_SHAPE = dataclasses.replace(TRAIN_4K, global_batch=2)
C3_STEPS = 3


def c3_plan(arch: str):
    from repro_torch.launch.plans import production_plan

    return production_plan(get_config(arch), TRAIN_4K).replace(
        compute_dtype="float32")


def c3_start(out_dir: Path, meshes: tuple) -> dict:
    """C3's children, started beside the GPU phases at the lowest CPU
    priority: for each model this script with ``--c3-trace`` (the one-card
    record, then C3b's trace) and, for each other mesh of ``meshes``, the
    dry run there (a fake world of its ranks)."""
    procs = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for arch in C3_ARCHS:
        for mesh in meshes:
            cmd = (["nice", "-n", "19", sys.executable,
                    str(ROOT / "chip_smoke.py"), "--c3-trace", arch,
                    str(out_dir)] if mesh == "h100x1"
                   else ["nice", "-n", "19", sys.executable, "-m",
                         "repro_torch.launch.dryrun", "--arch", arch,
                         "--shape", "train_4k", "--mesh", mesh, "--out",
                         str(out_dir)])
            log = open(out_dir / f"{arch}__{mesh}.log", "w")
            procs[arch, mesh] = (subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env), log,
                time.perf_counter())
    return procs


def c3_trace_child(arch: str, out_dir: Path) -> int:
    """``--c3-trace ARCH OUT``: the dry run's train_4k record of ``arch``
    on one card (full depth, the production plan, one sequence a
    microbatch), then C3b's configuration traced (``PATH_LAYERS``' depth,
    f32, ``C3_SHAPE``), its roofline and ``live_bytes`` written to
    ``OUT/ARCH__C3b.json``."""
    from repro_torch.launch.dryrun import lower_cell, run_cell

    torch.set_num_threads(1)           # a trace: one core beside the card's
    run_cell(arch, "train_4k", out_dir=out_dir)
    t0 = time.perf_counter()
    low, n_dev, mf = lower_cell(path_config(arch), C3_SHAPE, c3_plan(arch))
    lower_s = time.perf_counter() - t0
    compiled = low.compile()
    mem = compiled.memory_analysis()
    roof = rl.analyze(compiled, n_devices=n_dev, model_flops_global=mf)
    live = (mem.argument_size_in_bytes + mem.output_size_in_bytes
            + mem.temp_size_in_bytes + mem.generated_code_size_in_bytes)
    (out_dir / f"{arch}__C3b.json").write_text(json.dumps({
        "roofline": roof.summary(), "live_bytes": live,
        "lower_s": lower_s}))
    return 0


def c3_finish(procs: dict, out_dir: Path) -> dict:
    """C3a's records, checked: status ok, per-device FLOPs x devices at
    least the model's 6 N D, and on the mesh every collective group a
    divisor of its size with a 16-rank one, and the ranks' work per token
    at most the one-card record's times ``C3_MESH_WORK`` (and its 5%)."""
    out = {}
    # the one-card records first: the mesh records' work is read against
    # them
    for (arch, mesh), (proc, log, t0) in sorted(
            procs.items(), key=lambda kv: kv[0][1] != "h100x1"):
        rc = proc.wait(timeout=900)
        log.close()
        wall = time.perf_counter() - t0
        path = out_dir / f"{arch}__train_4k__{mesh}__production.json"
        check(rc == 0 and path.exists(),
              f"C3a {arch} {mesh}: exited {rc}: "
              f"{(out_dir / f'{arch}__{mesh}.log').read_text()[-3000:]}")
        rec = json.loads(path.read_text())
        check(rec["status"] == "ok", f"C3a {arch} {mesh}: {rec.get('error')}")
        n = rec["n_devices"]
        cfg = get_config(arch)
        tokens = int(rec["reduced"].split("-> ")[1].split()[0]) \
            * TRAIN_4K.seq_len
        roof = rec["roofline"]
        ratio = roof["flops"] * n / rl.model_flops_train(
            cfg.param_count(active_only=True), tokens)
        check(ratio >= 1.0, f"C3a {arch} {mesh}: FLOPs x {n} is {ratio} "
                            f"of 6 N D")
        row = {"status": rec["status"],
               "live_bytes": rec["memory"]["live_bytes"],
               "fits_80gb": rec["memory"]["fits_80gb"],
               "compute_ms": roof["compute_s"] * 1e3,
               "memory_ms": roof["memory_s"] * 1e3,
               "collective_ms": roof["collective_s"] * 1e3,
               "flops_over_6nd": ratio, "lower_s": rec["lower_s"],
               "compile_s": rec["compile_s"], "child_wall_s": wall,
               "reduced": rec["reduced"]}
        if mesh != "h100x1":
            groups = {int(k.split("@g")[1]) for k in rec["collectives"]}
            check(16 in groups and all(n % g == 0 for g in groups),
                  f"C3a {arch} {mesh}: collective groups {sorted(groups)}")
            row["collectives"] = rec["collectives"]
            row["param_bytes"] = rec["memory"]["param_bytes"]
            one = out[f"{arch} h100x1"]["flops_over_6nd"]
            row["work_over_one_card"] = ratio / one
            check(ratio <= one * C3_MESH_WORK[arch] * C3_MESH_TOL,
                  f"C3a {arch} {mesh}: the ranks' work is {ratio / one} "
                  f"of the one-card record's, over the expected "
                  f"{C3_MESH_WORK[arch]}")
        out[f"{arch} {mesh}"] = row
        print(f"C3a {arch} {mesh}:", json.dumps(row), flush=True)
    return out


def c3_real_steps(dev, arch: str, traced: dict) -> dict:
    """``C3_STEPS`` captured train steps (``jit_step``: the first an eager
    step and the capture, the rest replays) of ``arch`` at
    ``PATH_LAYERS``' depth under its production plan in f32 over
    ``C3_SHAPE``, from weights drawn on the card (seed 0) at a constant
    lr: each step's host seconds (synchronized) and the device time of a
    replay (phase J's entry of the step, profiled) must reach the traced
    program's FLOPs' time; the losses must be finite; the peak device
    memory is printed beside the trace's ``live_bytes``."""
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.runtime.train import (TrainState, jit_step,
                                           make_train_step)

    check(not torch.backends.cuda.matmul.allow_tf32, "C3b: TF32 is on")
    free_models()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = build_model(path_config(arch))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    state = TrainState(params, adamw_init(params), None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = c3_plan(arch)
    step = jit_step(make_train_step(model, plan, OptimizerConfig(),
                                    lambda s: torch.full((), T_LR,
                                                         device=dev)))
    batch = model.demo_batch(torch.Generator().manual_seed(SEED + 1),
                             C3_SHAPE.global_batch, C3_SHAPE.seq_len,
                             device=dev)
    secs, losses = [], []
    for i in range(C3_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - held
    j = train_capture_entry(f"C3b {arch}", step, step, state, batch)
    print_capture(f"C3b {arch}", {"step": j})
    device_s = j["captured"]["device_ms"] / 1e3
    capture = capture_info(step)
    del state, params, step, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    roof = traced["roofline"]
    check(all(map(math.isfinite, losses)), f"C3b {arch}: losses {losses}")
    for t in secs + [device_s]:
        check(t >= roof["compute_s"],
              f"C3b {arch}: {t} s, below the FLOPs' time "
              f"{roof['compute_s']} s")
    s_step = statistics.median(secs[1:])
    out = {"layers": model.cfg.n_layers, "plan": {
               k: getattr(plan, k) for k in ("rglru_impl", "wkv_impl",
                                             "remat", "microbatch",
                                             "attn_impl", "loss_impl")},
           "init_s": init_s, "step_seconds": secs, **capture,
           "s_per_step_median_2_3": s_step, "losses": losses,
           "device_s_replay": device_s,
           "device_idle_share_replay": j["captured"]["device_idle_share"],
           "device_launches_replay": j["captured"]["device_launches"],
           "compute_s_model": roof["compute_s"],
           "memory_s_model": roof["memory_s"], "step_s_model": roof["step_s"],
           "device_over_compute": device_s / roof["compute_s"],
           "peak_device_bytes": peak, "live_bytes_model": traced["live_bytes"],
           "peak_over_live": peak / traced["live_bytes"],
           "lower_s": traced["lower_s"],
           "reduced": f"{model.cfg.n_layers} of {get_config(arch).n_layers} "
                      f"layers (PATH_LAYERS); global batch 256 -> 2"}
    print(f"C3b {arch}:", json.dumps(out), flush=True)
    return out


def phase_scan_train(dev, procs: dict, out_dir: Path) -> dict:
    """Phase C3 (after C2): C3b's real steps of each model, then C3a's
    records (C3's children were started by :func:`c3_start` beside the GPU
    phases before it)."""
    t_start = time.perf_counter()
    out = {"C3b": {}}
    for arch in C3_ARCHS:
        rc = procs[arch, "h100x1"][0].wait(timeout=900)
        check(rc == 0, f"C3 {arch}: the trace child exited {rc}: "
              f"{(out_dir / f'{arch}__h100x1.log').read_text()[-3000:]}")
        traced = json.loads((out_dir / f"{arch}__C3b.json").read_text())
        out["C3b"][arch] = c3_real_steps(dev, arch, traced)
    out["C3a"] = c3_finish(procs, out_dir)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase C3: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase P: numeric Python programs through the python_ast frontend
# ---------------------------------------------------------------------------

#: the differential suite's numeric-Python workloads
#: (``tests/test_frontend_differential.py``: ATTN_SRC, RMS_SRC, REC_SRC,
#: BLOCK_SRC) and the ``app`` of ``examples/python_offload_demo.py``, copied
#: here because both files import the JAX package
P_ATTN_SRC = """
def attn_app(q, k, v, n, d, scale):
    out = np.zeros((n, d))
    for i in range(n):
        m = -1e30
        for j in range(i + 1):
            s = 0.0
            for t in range(d):
                s = s + q[i][t] * k[j][t]
            s = s * scale
            if s > m:
                m = s
        z = 0.0
        for j in range(i + 1):
            e = 0.0
            for t in range(d):
                e = e + q[i][t] * k[j][t]
            z = z + np.exp(e * scale - m)
        for t in range(d):
            acc = 0.0
            for j in range(i + 1):
                e = 0.0
                for u in range(d):
                    e = e + q[i][u] * k[j][u]
                acc = acc + np.exp(e * scale - m) / z * v[j][t]
            out[i][t] = acc
    return out
"""
P_RMS_SRC = """
def rms_app(x, scale, n, d):
    out = np.zeros((n, d))
    for i in range(n):
        ss = 0.0
        for t in range(d):
            ss = ss + x[i][t] * x[i][t]
        inv = 1.0 / np.sqrt(ss / d + 1e-06)
        for t in range(d):
            out[i][t] = x[i][t] * inv * (1.0 + scale[t])
    return out
"""
P_REC_SRC = """
def rec_app(a, b, h, n, d):
    out = np.zeros((n, d))
    for t in range(n):
        for c in range(d):
            h[c] = np.exp(a[t][c]) * h[c] + b[t][c]
            out[t][c] = h[c]
    return out
"""
P_BLOCK_SRC = """
def attn_stack(x, scale, wq, wk, wv):
    S = x.shape[0]
    D = x.shape[1]
    xn = np.zeros_like(x)
    q = np.zeros_like(x)
    k = np.zeros_like(x)
    v = np.zeros_like(x)
    out = np.zeros_like(x)
    for i in range(S):
        ss = 0.0
        for j in range(D):
            ss += x[i, j] * x[i, j]
        r = 1.0 / math.sqrt(ss / D + 1e-06)
        for j in range(D):
            xn[i, j] = x[i, j] * r * (1.0 + scale[j])
    for i in range(S):
        for j in range(D):
            sq = 0.0
            sk = 0.0
            sv = 0.0
            for t in range(D):
                sq += xn[i, t] * wq[t, j]
                sk += xn[i, t] * wk[t, j]
                sv += xn[i, t] * wv[t, j]
            q[i, j] = sq
            k[i, j] = sk
            v[i, j] = sv
    for i in range(S):
        m = -1e30
        for j in range(i + 1):
            s = 0.0
            for t in range(D):
                s += q[i, t] * k[j, t]
            s = s / math.sqrt(D)
            if s > m:
                m = s
        z = 0.0
        for j in range(i + 1):
            s = 0.0
            for t in range(D):
                s += q[i, t] * k[j, t]
            w = math.exp(s / math.sqrt(D) - m)
            z += w
            for t in range(D):
                out[i, t] += w * v[j, t]
        for t in range(D):
            out[i, t] = out[i, t] / z
    return out
"""
P_DEMO_SRC = """
def app(a, b, x, sig_re, sig_im, n, m, k, iters, fftn):
    c = np.zeros((n, m))
    for i in range(n):                      # naive O(n^3) matmul
        for j in range(m):
            acc = 0.0
            for t in range(k):
                acc = acc + a[i, t] * b[t, j]
            c[i, j] = acc
    out_re = np.zeros((fftn,))
    out_im = np.zeros((fftn,))
    for kk in range(fftn):                  # naive O(n^2) DFT
        sr = 0.0
        si = 0.0
        for t in range(fftn):
            ang = -2.0 * math.pi * kk * t / fftn
            sr = sr + sig_re[t] * math.cos(ang) - sig_im[t] * math.sin(ang)
            si = si + sig_re[t] * math.sin(ang) + sig_im[t] * math.cos(ang)
        out_re[kk] = sr
        out_im[kk] = si
    y = np.zeros((n,))
    for it in range(iters):                 # iterative vector update
        y = y + np.tanh(c @ x) * 0.1
    s = 0.0
    for i in range(n):                      # small scalar reduction
        s = s + y[i] * y[i]
    return c, y, s, out_re, out_im
"""

#: phase P's widths are published ones (qwen3_0_6b's head_dim and d_model,
#: recurrentgemma_2b's RG-LRU width); the sequence length / rows are the
#: scale, cut because CPython interprets the reference program
#: (attention costs O(n^2 d^2) interpreted)
P_SCALE = {"attention": 4, "rmsnorm": 64, "recurrence": 64}
#: halved in PR 30 (from 8, 128 and 128) for the script's time
P_REDUCED = {
    "attention": "sequence 2048 -> 4 (CPython interprets O(n^2 d^2))",
    "rmsnorm": "rows 4096 -> 64 (CPython interprets every element)",
    "recurrence": "steps 2048 -> 64 (CPython interprets every element)"}
#: the suite's sizes for BLOCK_SRC, the demo's own for its app
P_BLOCK_S, P_BLOCK_D = 16, 8
P_DEMO_CONSTS = {"n": 24, "m": 24, "k": 24, "iters": 50, "fftn": 64}
#: the kernel the ``gpu_kernel`` variant of each workload's site launches
P_KERNEL = {"attention": "flash_attention", "rmsnorm": "rmsnorm",
            "recurrence": "rglru_scan"}
P_GA = (4, 2)
#: the kernels each path runs (phase P: its three workloads')
PATH_KERNELS = {**{label: p[3] for label, p in PATHS.items()},
                "P": tuple(P_KERNEL.values()), "K": ("flash_attention",
                                                     "rmsnorm"),
                "V": PATHS["Q"][3], "D": PATHS["Q"][3]}


def p_workloads() -> dict:
    """Each workload's (source, consts, inputs), drawn with numpy from
    seed 0 in float64 as the suite draws them, at the widths of the
    configs (``P_SCALE`` rows); the recurrence from a nonzero state."""
    cfg, rg = get_config("qwen3_0_6b"), get_config("recurrentgemma_2b")
    hd, dm, dr = cfg.resolved_head_dim, cfg.d_model, rg.d_rnn_resolved
    rng = np.random.default_rng(SEED)
    n = P_SCALE["attention"]
    attn = dict(q=rng.standard_normal((n, hd)), k=rng.standard_normal((n, hd)),
                v=rng.standard_normal((n, hd)))
    n = P_SCALE["rmsnorm"]
    rms = dict(x=rng.standard_normal((n, dm)),
               scale=rng.standard_normal(dm) * 0.1)
    n = P_SCALE["recurrence"]
    rec = dict(a=-np.abs(rng.standard_normal((n, dr))) * 0.2,
               b=rng.standard_normal((n, dr)) * 0.5,
               h=rng.standard_normal(dr) * 0.5)
    return {
        "attention": (P_ATTN_SRC, {"n": P_SCALE["attention"], "d": hd,
                                   "scale": 1.0 / math.sqrt(hd)}, attn),
        "rmsnorm": (P_RMS_SRC, {"n": P_SCALE["rmsnorm"], "d": dm}, rms),
        "recurrence": (P_REC_SRC, {"n": P_SCALE["recurrence"], "d": dr}, rec),
    }


def _p_spans(trace_path: Path) -> dict:
    spans, _ = read_trace(str(trace_path))
    return {s["name"]: s["dur_s"] for s in spans}


def p_forced(graph, coding) -> tuple:
    """``gpu_kernel`` on every variant site (the loop nests whose pattern
    has registry variants), the interpreter everywhere else."""
    return tuple(2 if graph.by_name(s.region).meta.get("pattern")
                 and not s.members else 0 for s in coding.sites)


def p_transfers(art, graph, inputs) -> dict:
    """One run's H2D/D2H counts and bytes beside the transfer planner's
    prediction for the same implementation map."""
    ex = art.executor()
    ex.run(**inputs)
    torch.cuda.synchronize()
    plan = plan_transfers(graph, art.impl, hoist=art.hoist_transfers)
    return {"measured": dataclasses.asdict(ex.stats),
            "planned": {"h2d": sorted(t.var for t in plan.transfers
                                      if t.direction == "h2d"),
                        "d2h": sorted(t.var for t in plan.transfers
                                      if t.direction == "d2h"),
                        "estimated_count": plan.estimated_count(graph)}}


def p_plan(label, src, consts, inputs, dev, scratch: Path, ga=P_GA,
           repeats=1):
    """``Offloader.prepare`` then ``Offloader.search`` (``plan`` is
    exactly that) on the source string, traced for the seconds of the
    feasibility check (``prepare.build_graph``: one interpreted run and
    each loop's check) and the calibration (``prepare.make_fitness``: one
    interpreted run, the timed all-interpreted baseline, the variant
    binding and the library-block measurements)."""
    trace = scratch / f"trace-{label}.jsonl"
    config = OffloadConfig(
        device=str(dev), repeats=repeats, trace=str(trace),
        ga=GAConfig(population=ga[0], generations=ga[1], seed=SEED),
        options={"consts": consts},
        log=lambda s: print(f"  plan P {label}:", s, flush=True))
    offloader = Offloader(config)
    t0 = time.perf_counter()
    ctx = offloader.prepare(src, inputs)
    res = offloader.search(ctx)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    spans = _p_spans(trace)
    graph, bundle = ctx.graph, ctx.bundle
    summary = {
        "interpreted_s": res.baseline.time_s,
        "feasibility_check_s": spans.get("prepare.build_graph"),
        "calibration_s": spans.get("prepare.make_fitness"),
        "search_s": spans.get("plan.search"), "plan_s": plan_s,
        "loops": {r.name: ("offloadable" if r.offloadable else
                           r.meta.get("offload_error", "not offloadable"))
                  for r in graph.loops()},
        "variant_menus": {r: sorted(m) for r, m in
                          bundle.context["variant_sites"].items()},
        "variant_fallbacks": bundle.context["variant_fallbacks"],
        "block_sites": {b: {"menu": sorted(e["menu"]),
                            "members": list(e["members"])}
                        for b, e in bundle.context["block_sites"].items()},
        "library_blocks": sorted(r for r, e in
                                 bundle.context["lib_calls"].items()
                                 if "lib" in e),
        "gene_length": res.coding.length,
        "alphabet": list(res.coding.destinations),
        "winner_bits": "".join(map(str, res.best.bits)),
        "winner_destinations": res.destinations,
        "winner_s": res.best.time_s, "speedup": res.speedup,
        "verified": res.verification["verified"],
        "measurements": res.ga.evaluations}
    check(res.verification["verified"],
          f"phase P {label}: the winning plan did not verify")
    return offloader, ctx, res, summary


def p_launched(fn) -> tuple:
    """Run ``fn`` once: its result, the kernels it launched and their
    launches by flash path, RMSNorm variant and RG-LRU route (differences
    of the wrappers' counts, which phase P's total keeps)."""
    before = ops.launch_counts(), sub_counts()
    out = fn()
    torch.cuda.synchronize()
    launches, by = counts_since(before)
    by = {name: {k: n for k, n in split.items() if n}
          for name, split in by.items()}
    return out, {k: n for k, n in launches.items() if n}, \
        {k: v for k, v in by.items() if v}


def p_reference(ctx) -> dict:
    """The interpreted program's outputs (CPython + numpy, float64), from
    the frontend's calibration run."""
    return ctx.bundle.context["reference"]


def phase_python(dev, scratch: Path) -> dict:
    """Phase P: ``Offloader`` over plain numeric Python source on the card
    (the python_ast frontend).  Each workload is planned (GA 4 x 2 over
    the interpreter and the variant menu), then its forced chromosome —
    ``gpu_kernel`` on the matched loop nest — must bind ``cuda``, launch
    its kernel once a run, and verify; its device launches and idle share
    and its transfers beside the planner's prediction are printed.  Then
    ``BLOCK_SRC`` (the ``attention_stack`` block, whose variants launch no
    hand kernel) and the demo ``app`` (the matmul and DFT library
    adapters, and the eager offloaded generic loops)."""
    out = {"reduced": P_REDUCED, "workloads": {}}
    for label, (src, consts, inputs) in p_workloads().items():
        t0 = time.perf_counter()
        offloader, ctx, res, summary = p_plan(label, src, consts, inputs,
                                              dev, scratch)
        forced = p_forced(ctx.graph, ctx.coding)
        check(sum(forced) == 2, f"phase P {label}: expected one variant "
                                f"site, found {forced}")
        art = offloader.apply(ctx, forced)
        check(set(art.report.substituted.values()) == {"cuda"},
              f"phase P {label}: the forced chromosome bound "
              f"{art.report.substituted} ({art.report.fallbacks})")
        got, launches, by = p_launched(lambda: art.run(**inputs))
        check(launches == {P_KERNEL[label]: 1},
              f"phase P {label}: one run of the forced chromosome launched "
              f"{launches}, not {{{P_KERNEL[label]!r}: 1}}")
        reference = p_reference(ctx)
        fv = verify(reference, got, rtol=1e-2, atol=1e-2)
        check(fv.ok, f"phase P {label}: the forced chromosome does not "
                     f"verify: {fv}")
        summary["forced"] = {
            "bits": "".join(map(str, forced)),
            "substituted": art.report.substituted,
            "launches": launches, "by_path_variant_route": by,
            "max_abs": fv.max_abs, "max_rel": fv.max_rel,
            "transfers": p_transfers(art, ctx.graph, inputs),
            "where_time_goes": where_time_goes(
                lambda: art.run(**inputs), (), 3)}
        summary["phase_s"] = time.perf_counter() - t0
        print(f"phase P {label}:", json.dumps(summary), flush=True)
        out["workloads"][label] = summary

    # BLOCK_SRC at the suite's size: the block gene's two variants
    rng = np.random.default_rng(SEED)
    s, d = P_BLOCK_S, P_BLOCK_D
    inputs = dict(x=rng.standard_normal((s, d)),
                  scale=rng.standard_normal(d) * 0.1,
                  wq=rng.standard_normal((d, d)) / math.sqrt(d),
                  wk=rng.standard_normal((d, d)) / math.sqrt(d),
                  wv=rng.standard_normal((d, d)) / math.sqrt(d))
    offloader, ctx, res, summary = p_plan("block", P_BLOCK_SRC, {}, inputs,
                                          dev, scratch)
    block = next(s_ for s_ in ctx.coding.sites if s_.members)
    reference = p_reference(ctx)
    summary["block_variants"] = {}
    for gene in (1, 2):
        bits = tuple(gene if s_ is block else 0 for s_ in ctx.coding.sites)
        art = offloader.apply(ctx, bits)
        got, launches, _ = p_launched(lambda: art.run(**inputs))
        fv = verify(reference, got, rtol=1e-2, atol=1e-2)
        variant = art.report.substituted.get(block.region)
        check(variant is not None and fv.ok and not launches,
              f"phase P block: gene {gene} bound {variant}, verified "
              f"{fv.ok}, launched {launches}")
        summary["block_variants"][variant] = {"max_abs": fv.max_abs,
                                              "launches": launches}
    print("phase P block:", json.dumps(summary), flush=True)
    out["block"] = summary

    # the demo app at its own sizes: the matmul and fft library adapters
    rng = np.random.default_rng(SEED)
    c = P_DEMO_CONSTS
    inputs = dict(a=rng.random((c["n"], c["k"])), b=rng.random((c["k"], c["m"])),
                  x=rng.random(c["m"]), sig_re=rng.random(c["fftn"]),
                  sig_im=rng.random(c["fftn"]))
    offloader, ctx, res, summary = p_plan("demo", P_DEMO_SRC, c, inputs, dev,
                                          scratch)
    libs = {bo.pattern for bo in res.block.offloads
            if bo.region in summary["library_blocks"]}
    check({"matmul", "fft"} <= {bo.pattern for bo in res.block.offloads}
          and libs and libs <= {"matmul", "fft"},
          f"phase P demo: matched {[bo.pattern for bo in res.block.offloads]}"
          f", library blocks kept {sorted(libs)}")
    summary["block_time_s"] = ctx.bundle.context["block_time_s"]
    # the offloaded generic loops: every top-level loop that passed the
    # feasibility check runs as its rewritten function on the card, captured
    # (the matmul nest and the DFT included); phase J holds the run against
    # the eager port (one launch a scalar op)
    loops = {r.name: "jit" for r in ctx.graph.loops()
             if r.offloadable and r.parent is None}
    art = PyOffloadArtifact(ctx.target, loops, {}, device=dev)
    fv = verify(p_reference(ctx), art.run(**inputs), rtol=1e-2,
                atol=1e-2)
    j = capture_entry(
        "P demo", lambda inp: art.run(**inp), (inputs,),
        ({k: v * 0.5 for k, v in inputs.items()},), 1,
        lambda: [p for cf in ctx.target._compiled_cache.values()
                 for p in cf.programs.values()], replays=len(loops))
    summary["offloaded_loops"] = {
        "loops": sorted(loops), "verified": fv.ok, "max_abs": fv.max_abs,
        "timed": "captured CUDA graphs (replays)",
        "where_time_goes": _time_entry(j["captured"]),
        "eager": _time_entry(j["eager"])}
    check(fv.ok, f"phase P demo: the offloaded loops do not verify: {fv}")
    print("phase P demo:", json.dumps(summary), flush=True)
    print_capture("P demo", {"offloaded loops": j})
    out["demo"] = summary
    return out


# ---------------------------------------------------------------------------
# phase K: function-block genes in the export frontend, at published widths
# ---------------------------------------------------------------------------

#: K1: Qwen3-0.6B's d_model and head_dim, a 2048-token single-head stack;
#: K2: OLMoE-1B-7B's MoE (d 2048, 64 experts top-8, expert width 1024)
#: over 4096 tokens, in the record's dense one-hot form
K1_S = 2048
K2_T = 4096
K_GA = (6, 2)


class CausalAttention(torch.nn.Module):
    """Causal single-head attention over (S, dh) q, k, v: the attention
    core as a submodule (its attribute ``attention`` is what the
    ``softmax_attention`` and ``attention_stack`` records match by name)."""

    def forward(self, q, k, v):
        s = q @ k.T / math.sqrt(q.shape[-1])
        mask = torch.tril(torch.ones(q.shape[0], k.shape[0],
                                     dtype=torch.bool, device=q.device))
        return torch.softmax(torch.where(mask, s, -1e30), dim=-1) @ v


class AttentionStack(torch.nn.Module):
    """K1's program: RMSNorm (a submodule), the q/k/v projections, causal
    single-head attention (a submodule), the output projection and the
    residual, over an (S, d) residual stream."""

    def __init__(self, d, dh, gen, dev):
        super().__init__()
        self.norm = RMSNorm(d, device=dev)
        with torch.no_grad():
            self.norm.weight.copy_(torch.randn(d, generator=gen) * 0.1)

        def w(fan_in, fan_out):
            return torch.nn.Parameter((torch.randn(fan_in, fan_out,
                                                   generator=gen)
                                       / math.sqrt(fan_in)).to(dev))
        self.wq, self.wk, self.wv, self.wo = (w(d, dh), w(d, dh), w(d, dh),
                                              w(dh, d))
        self.attention = CausalAttention()

    def forward(self, x):
        xn = self.norm(x)
        o = self.attention(xn @ self.wq, xn @ self.wk, xn @ self.wv)
        return x + o @ self.wo


class TopKRouter(torch.nn.Module):
    """Softmax top-k router returning the (T, E) combined gate matrix:
    zero outside each token's k experts, gates renormalized."""

    def __init__(self, weight, top_k):
        super().__init__()
        self.weight = torch.nn.Parameter(weight)
        self.top_k = top_k

    def forward(self, x):
        probs = torch.softmax(x @ self.weight, dim=-1)
        gates, idx = torch.topk(probs, self.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        onehot = (idx[..., None] == torch.arange(
            self.weight.shape[1], device=x.device)).float()
        return torch.einsum("tk,tke->te", gates, onehot)


class DenseExperts(torch.nn.Module):
    """Every token through every expert's SwiGLU FFN, combined by the gate
    matrix (the dense one-hot form: (T, E, F) intermediates)."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (
            torch.nn.Parameter(w) for w in (w_gate, w_up, w_down))

    def forward(self, x, combine):
        g = torch.einsum("td,edf->tef", x, self.w_gate)
        u = torch.einsum("td,edf->tef", x, self.w_up)
        y = torch.einsum("tef,efd->ted", F.silu(g) * u, self.w_down)
        return torch.einsum("ted,te->td", y, combine)


class MoEDispatch(torch.nn.Module):
    """K2's program: the ``moe_dispatch`` record's dense one-hot MoE, the
    router and the experts as submodules."""

    def __init__(self, cfg, gen, dev):
        super().__init__()
        e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert

        def w(*shape, fan_in):
            return (torch.randn(*shape, generator=gen)
                    / math.sqrt(fan_in)).to(dev)
        self.router = TopKRouter(w(d, e, fan_in=d), cfg.moe.top_k)
        self.experts = DenseExperts(w(e, d, f, fan_in=d), w(e, d, f, fan_in=d),
                                    w(e, f, d, fan_in=f))

    def forward(self, x):
        return self.experts(x, self.router(x))


def k_programs(dev) -> dict:
    """K1 and K2 at published widths, weights and inputs from seed 0."""
    qwen, olmoe = get_config("qwen3_0_6b"), get_config("olmoe_1b_7b")
    gen = torch.Generator().manual_seed(SEED)
    k1 = AttentionStack(qwen.d_model, qwen.resolved_head_dim, gen, dev)
    x1 = torch.randn(K1_S, qwen.d_model, generator=gen).to(dev)
    gen = torch.Generator().manual_seed(SEED)
    k2 = MoEDispatch(olmoe, gen, dev)
    x2 = torch.randn(K2_T, olmoe.d_model, generator=gen).to(dev)
    return {"K1": (k1, (x1,)), "K2": (k2, (x2,))}


def k_plan(label, model, args, scratch: Path, block_sites: bool,
           seed_forced: bool = False):
    """One arm of phase K: ``Offloader.plan``'s two halves (export
    frontend, f32, seed 0, GA 6 x 2, 1 repeat) with block sites on (the
    default) or off; with ``seed_forced`` the search starts from the
    forced all-kernel chromosome too, so that it launches every kernel the
    program binds.  Returns the result, the planning wall time and the
    launches of the plan (:func:`counts_since`)."""
    arm = "block" if block_sites else "loop"
    cache = scratch / f"{label}-{arm}"
    options = {"example_args": args}
    if not block_sites:
        options["block_sites"] = False
    config = OffloadConfig(
        device=str(args[0].device),
        ga=GAConfig(population=K_GA[0], generations=K_GA[1],
                                   seed=SEED, cache_dir=str(cache)),
        repeats=1, options=options,
        log=lambda m: print(f"  plan {label} {arm}:", m, flush=True))
    before = ops.launch_counts(), sub_counts()
    t0 = time.perf_counter()
    offloader = Offloader(config)
    ctx = offloader.prepare(model)
    seeds = [forced_chromosome(ctx.graph, ctx.coding)] if seed_forced else []
    res = offloader.search(ctx, extra_seeds=seeds)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    searched = counts_since(before)
    check(res.verification["verified"],
          f"phase K {label} {arm}: the winning plan did not verify")
    return res, plan_s, searched


def k_chosen(res) -> dict:
    """The winner's implementation at each gene site (``ref`` where none
    was substituted)."""
    sub = res.artifact.report.substituted
    return {s.region: sub.get(s.region, "ref") for s in res.coding.sites}


def k_time(fn, args, flush) -> float:
    """A forward's device time (median of 5, CUDA events, L2 flushed)."""
    with torch.no_grad():
        return time_ms(lambda: fn(*args), flush, repeats=5)


def block_regions(graph) -> list:
    """The graph's function-block (``fnblock_*``) regions."""
    return [r for r in graph.regions if r.meta.get("block_members")]


def phase_blocks(dev, scratch: Path) -> dict:
    """Phase K: the reference's ``bench_block_offload`` comparison at
    published widths.  Each program is planned twice through
    ``Offloader.plan``, with block sites on and with
    ``options={"block_sites": False}``.  K1 (the attention stack) must get
    exactly one ``fnblock_*`` region binding ``block_chunked`` and
    ``block_fused``, each verifying; the loop arm's forced chromosome must
    launch the RMSNorm and flash kernels once each and verify.  K2 (the MoE
    dispatch) must get one ``fnblock_*`` region whose ``block_scatter``
    binds and verifies.  Each arm's winner, its forward time and the forced
    chromosomes' times are printed.  K1's searches start from the forced
    chromosome too.  Returns the launches, and their splits, of the four
    plans alone: the checks and timings around them are read as
    differences of the counts and left out."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out, searched = {}, []
    programs = k_programs(dev)

    # --- K1: the attention stack --------------------------------------
    model, args = programs.pop("K1")
    with torch.no_grad():
        reference = model(*args)
    res, plan_s, counts = k_plan("K1", model, args, scratch, True, True)
    searched.append(counts)
    blocks = block_regions(res.graph)
    check(len(blocks) == 1 and blocks[0].meta["pattern"] == "attention_stack",
          f"phase K1: expected one attention_stack fnblock region, found "
          f"{[(b.name, b.meta['pattern']) for b in blocks]}")
    fb = blocks[0]
    engine = res.details["engine"]
    k1 = {"block_arm": {"plan_s": plan_s, "fnblock": fb.name,
                        "members": list(fb.meta["block_members"]),
                        "window_nodes": len(fb.meta["nodes"]),
                        "winner": k_chosen(res),
                        "best_bits": "".join(map(str, res.best.bits)),
                        "best_s": res.best.time_s,
                        "baseline_s": res.baseline.time_s,
                        "speedup": res.speedup,
                        "overlap_est_saved_s": res.ga.overlap_est_saved_s,
                        "overlap_disabled": res.ga.overlap_disabled,
                        "search_launches": counts[0],
                        "variants": {}}}
    for variant in ("block_chunked", "block_fused"):
        v, chosen = engine.verify_block(fb.name, variant)
        sub = engine.substitute({fb.name: variant})
        with torch.no_grad():
            got, launched, _ = p_launched(lambda: sub(*args))
        fv = verify(reference, got, rtol=1e-2, atol=1e-2)
        check(chosen == variant and v.ok and fv.ok
              and sub.report.substituted == {fb.name: variant},
              f"phase K1: {variant} bound {chosen}, verified block {v}, "
              f"program {fv}, substituted {sub.report.substituted}")
        k1["block_arm"]["variants"][variant] = {
            "block_max_abs": v.max_abs, "max_abs": fv.max_abs,
            "launches": launched, "ms": k_time(sub, args, flush)}
    k1["block_arm"]["all_ref_ms"] = k_time(engine.substitute({}), args,
                                           flush)
    k1["block_arm"]["winner_ms"] = k_time(res.artifact, args, flush)
    del res, engine

    res, plan_s, counts = k_plan("K1", model, args, scratch, False, True)
    searched.append(counts)
    check(not block_regions(res.graph), "phase K1 loop arm: a block region")
    engine = res.details["engine"]
    forced = forced_chromosome(res.graph, res.coding)
    sub = engine.substitute(res.coding.decode(forced))
    with torch.no_grad():
        got, launched, _ = p_launched(lambda: sub(*args))
    fv = verify(reference, got, rtol=1e-2, atol=1e-2)
    check(launched == {"flash_attention": 1, "rmsnorm": 1} and fv.ok,
          f"phase K1 loop arm: the forced chromosome launched {launched}, "
          f"verified {fv}")
    k1["loop_arm"] = {"plan_s": plan_s, "winner": k_chosen(res),
                      "best_bits": "".join(map(str, res.best.bits)),
                      "best_s": res.best.time_s,
                      "baseline_s": res.baseline.time_s,
                      "speedup": res.speedup,
                      "overlap_est_saved_s": res.ga.overlap_est_saved_s,
                      "overlap_disabled": res.ga.overlap_disabled,
                      "search_launches": counts[0],
                      "forced": {"bits": "".join(map(str, forced)),
                                 "substituted": sub.report.substituted,
                                 "launches": launched,
                                 "max_abs": fv.max_abs,
                                 "ms": k_time(sub, args, flush)},
                      "winner_ms": k_time(res.artifact, args, flush)}
    print("phase K1:", json.dumps(k1), flush=True)
    out["K1"] = k1
    del res, engine, sub, model, args, reference
    gc.collect()
    torch.cuda.empty_cache()

    # --- K2: the MoE dispatch -----------------------------------------
    model, args = programs.pop("K2")
    with torch.no_grad():
        reference = model(*args)
    k2 = {}
    for block_sites in (True, False):
        arm = "block_arm" if block_sites else "loop_arm"
        torch.cuda.reset_peak_memory_stats()
        res, plan_s, counts = k_plan("K2", model, args, scratch,
                                     block_sites)
        searched.append(counts)
        engine = res.details["engine"]
        blocks = block_regions(res.graph)
        entry = {"plan_s": plan_s, "winner": k_chosen(res),
                 "best_bits": "".join(map(str, res.best.bits)),
                 "best_s": res.best.time_s,
                 "baseline_s": res.baseline.time_s,
                 "overlap_est_saved_s": res.ga.overlap_est_saved_s,
                 "overlap_disabled": res.ga.overlap_disabled,
                 "search_launches": counts[0],
                 "dense_ms": k_time(engine.substitute({}), args, flush)}
        if block_sites:
            check(len(blocks) == 1
                  and blocks[0].meta["pattern"] == "moe_dispatch",
                  f"phase K2: expected one moe_dispatch fnblock region, "
                  f"found {[(b.name, b.meta['pattern']) for b in blocks]}")
            fb = blocks[0]
            v, chosen = engine.verify_block(fb.name, "block_scatter")
            sub = engine.substitute({fb.name: "block_scatter"})
            with torch.no_grad():
                fv = verify(reference, sub(*args), rtol=1e-2, atol=1e-2)
            check(chosen == "block_scatter" and v.ok and fv.ok,
                  f"phase K2: block_scatter bound {chosen}, verified block "
                  f"{v}, program {fv}")
            entry.update(fnblock=fb.name,
                         members=list(fb.meta["block_members"]),
                         block_scatter={"block_max_abs": v.max_abs,
                                        "max_abs": fv.max_abs,
                                        "ms": k_time(sub, args, flush)},
                         picked=entry["winner"][fb.name])
            del sub
        else:
            check(not blocks, "phase K2 loop arm: a block region")
        entry["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        k2[arm] = entry
        del res, engine
        gc.collect()
        torch.cuda.empty_cache()
    print("phase K2:", json.dumps(k2), flush=True)
    out["K2"] = k2
    launches = {k: sum(c[0][k] for c in searched) for k in searched[0][0]}
    splits = {name: {k: sum(c[1][name].get(k, 0) for c in searched)
                     for k in {k for c in searched for k in c[1][name]}}
              for name in searched[0][1]}
    return launches, splits


class DeterministicTiming:
    """A measured fitness whose ``prepare`` is the real one (substitute,
    warm-up run on the card, verify) and whose ``measure`` returns a time
    that is a fixed function of the chromosome: two searches that differ
    only in how their prepares are scheduled then follow the same GA
    trajectory, so the overlap phase's effect on the plan can be compared
    exactly (a wall-clock time differs from run to run)."""

    def __init__(self, fitness):
        self.fitness = fitness
        self.measured: list = []
        self.failures: dict = {}   # bits -> the failed prepare's detail

    def prepare(self, bits):
        return self.fitness.prepare(bits)

    def measure(self, prepared):
        from repro_torch.core.ga import Evaluation

        self.measured.append(prepared.bits)
        if prepared.failure is not None:
            self.failures["".join(map(str, prepared.bits))] = \
                prepared.failure.detail
            return prepared.failure
        bits = prepared.bits
        return Evaluation(bits, 1.0 - sum((i % 3 + 1) * 0.01 * int(v)
                                          for i, v in enumerate(bits)),
                          True, {})

    def __call__(self, bits):
        return self.measure(self.prepare(bits))


def phase_overlap(dev, scratch: Path) -> dict:
    """Path Q planned twice, its prepares serial (``compile_workers=0``)
    and overlapped on 4 threads, each chromosome's time a fixed function
    of its bits (:class:`DeterministicTiming`) so the two searches must
    agree: the same best bits, the same set of measured chromosomes and
    the same failed prepares (each with its error).  Their planning wall
    times and the overlap phase's own estimate are printed."""
    target, args = path_q(dev)
    out = {}
    for workers in (0, 4):
        ga = GAConfig(population=PATHS["Q"][1][0],
                      generations=PATHS["Q"][1][1], seed=SEED,
                      compile_workers=workers,
                      cache_dir=str(scratch / f"Q-cw{workers}"))
        offloader = Offloader(OffloadConfig(
            device=str(dev), ga=ga, repeats=1,
            options={"example_args": args}))
        ctx = offloader.prepare(target)
        fitness = DeterministicTiming(ctx.bundle.fitness_factory(ctx.coding))
        ctx.config.fitness_fn = fitness
        t0 = time.perf_counter()
        res = offloader.search(ctx)
        torch.cuda.synchronize()
        out[workers] = {"plan_s": time.perf_counter() - t0,
                        "best_bits": "".join(map(str, res.best.bits)),
                        "measured": sorted("".join(map(str, b))
                                           for b in fitness.measured),
                        "n_measured": len(fitness.measured),
                        "failures": fitness.failures,
                        "compile_overlap_saved_s":
                            res.ga.compile_overlap_saved_s,
                        "overlap_est_saved_s": res.ga.overlap_est_saved_s,
                        "overlap_disabled": res.ga.overlap_disabled}
    check(out[0]["best_bits"] == out[4]["best_bits"]
          and out[0]["measured"] == out[4]["measured"]
          and out[0]["failures"] == out[4]["failures"],
          f"path Q: the overlapped search differs from the serial one: "
          f"{out}")
    print("path Q, serial against overlapped prepares:", json.dumps(out),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase V: the planning service
# ---------------------------------------------------------------------------

#: paths planned through the planning service (``PlanService.plan``) in
#: place of ``Offloader.plan``; the store is kept for phase V
SERVICE_PATHS = {"M"}
#: phase V1: the client threads that submit path Q's program at once
V_CLIENTS = 4
#: path M's winner output, saved for phase V2's child to compare with
M_WINNER_OUT = "m_winner_out.pt"


def same_output(a, b) -> bool:
    """Every leaf of ``a`` bit-equal to its leaf of ``b``."""
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def kernels_bound(artifact) -> dict:
    """The kernel launches one forward of a substituted program makes: one
    a site that its report binds to ``cuda``."""
    return dict(collections.Counter(
        PATTERN_KERNEL[c.pattern] for c in artifact.report.choices
        if c.chosen == "cuda"))


def search_work() -> tuple:
    """The process's GA generations and measurements so far (the metrics
    registry's counters): a warm load adds to neither."""
    snap = obs_metrics.snapshot()
    return tuple(sum(s["value"] for s in snap.get(name, {}).get("series", ()))
                 for name in ("ga.generations", "eval.measurements"))


def v1_lifecycle(dev, scratch: Path) -> dict:
    """Phase V1: the planning service's lifecycle on path Q's program (one
    full-width Qwen3-0.6B block, bf16, GA 8 x 4 from seed 0, 3 timing
    repeats), traced (phase V4):

    1. ``V_CLIENTS`` threads submit it at once: one search, the others
       coalesced, none raises (each submit exports the program on its
       thread, under the trace lock);
    2. a further submit is a live hit;
    3. the endpoint's output verifies against the unsubstituted block (the
       verifier's 1e-2) and launches flash and RMSNorm, once a bound site;
    4. a new service on the same directory warm-loads (no GA generation, no
       measurement) and its output is bit-equal to the cold artifact's;
    5. the stored record, tampered to a foreign env, re-measures (origin
       ``env-remeasure``, its persistent journal hits printed), and the
       next restart warm-loads again;
    6. ``refine_once`` (1 generation) runs while two client threads call
       the endpoint: every output is bit-equal to the output of the plan
       deployed before or after it; if it swapped, ``rollback`` restores
       the previous bits and output as a new head version;
    7. ``select_operating_point("latency")`` keeps the single-objective
       plan; 8. ``evict_stale(0)`` spares the deployed fingerprint."""
    block, args = path_q(dev)
    with torch.no_grad():
        reference = block(*args)
    store, trace = scratch / "store-q", scratch / "service_trace.jsonl"
    pop, gens = PATHS["Q"][1]
    config = OffloadConfig(device=str(dev), trace=str(trace),
                           ga=GAConfig(population=pop, generations=gens,
                                       seed=SEED),
                           options={"example_args": args})
    svc_cfg = ServiceConfig(refine_generations=1)

    def service():
        return PlanService(str(store), config=config, service=svc_cfg)

    out: dict = {}
    with obs_trace.maybe_tracing(str(trace)):
        # 1-3: concurrent cold submits, a live hit, the endpoint
        svc = service()
        barrier = threading.Barrier(V_CLIENTS)
        futs, errors = [None] * V_CLIENTS, []

        def submit(i):
            try:
                barrier.wait(timeout=120)
                futs[i] = svc.submit(block)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(V_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not errors and not any(t.is_alive() for t in threads),
              f"phase V1: concurrent submits failed: {errors}")
        plans = [f.result(timeout=600) for f in futs]
        out["cold_plan_s"] = time.perf_counter() - t0
        cold = plans[0]
        check(svc.stats.searches == 1
              and svc.stats.coalesced == V_CLIENTS - 1
              and all(p is cold for p in plans),
              f"phase V1: {V_CLIENTS} concurrent submits gave "
              f"{svc.stats.as_dict()}")
        fp = cold.fingerprint
        check(svc.plan(block) is cold and svc.stats.live_hits == 1,
              f"phase V1: the fifth submit was not a live hit: "
              f"{svc.stats.as_dict()}")
        out["cold"] = {"stats": svc.stats.as_dict(),
                       "bits": "".join(map(str, cold.record.bits)),
                       "best_s": cold.record.best_time_s,
                       "speedup": cold.record.speedup,
                       "measurements": cold.search.ga.evaluations}
        call = svc.endpoint(fp)
        before = (ops.launch_counts(), sub_counts())
        cold_out = call(*args)
        torch.cuda.synchronize()
        launched = {k: n for k, n in counts_since(before)[0].items() if n}
        v = verify(reference, cold_out, rtol=1e-2, atol=1e-2)
        check(v.ok, f"phase V1: the endpoint's output differs from the "
                    f"block: {v}")
        check(launched == kernels_bound(cold.artifact)
              and {"flash_attention", "rmsnorm"} <= set(launched),
              f"phase V1: one endpoint call launched {launched}; its plan "
              f"binds {kernels_bound(cold.artifact)}")
        out["endpoint"] = {"max_abs": v.max_abs, "launches": launched}
        svc.close()

        # 4: a restart warm-loads
        work = search_work()
        t0 = time.perf_counter()
        with service() as svc:
            warm = svc.plan(block)
        out["warm_plan_s"] = time.perf_counter() - t0
        check(warm.warm and svc.stats.warm_loads == 1
              and svc.stats.searches == 0 and search_work() == work,
              f"phase V1: the restart did not warm-load: "
              f"{svc.stats.as_dict()}, GA work {work} -> {search_work()}")
        check(same_output(warm(*args), cold_out),
              "phase V1: the warm-loaded artifact's output is not the cold "
              "artifact's")

        # 5: a record from a foreign env re-measures
        plans_store = PlanStore(str(store))
        rec = plans_store.load(fp)
        plans_store.put(dataclasses.replace(
            rec, env=dict(rec.env, device_kind="tpu-v99", device_count=4096)))
        t0 = time.perf_counter()
        with service() as svc:
            again = svc.plan(block)
        check(not again.warm and svc.stats.env_mismatches == 1
              and svc.stats.searches == 1
              and again.record.meta["origin"] == "env-remeasure",
              f"phase V1: a foreign env did not re-measure: "
              f"{svc.stats.as_dict()} {again.record.meta}")
        out["env_remeasure"] = {
            "plan_s": time.perf_counter() - t0,
            "bits": "".join(map(str, again.record.bits)),
            "best_s": again.record.best_time_s,
            "measurements": again.search.ga.evaluations,
            "persistent_hits": again.search.ga.persistent_hits}

        # 6-8: the restarted service refines under load, rolls back,
        # keeps its operating point and spares its plan from eviction
        with service() as svc:
            deployed = svc.plan(block)
            check(deployed.warm and svc.stats.env_mismatches == 0,
                  f"phase V1: the restart after the re-measure did not "
                  f"warm-load: {svc.stats.as_dict()}")
            call = svc.endpoint(fp)
            pre_out = call(*args)
            others, errors, stop = [], [], threading.Event()
            calls = [0, 0]

            def client(i):
                try:
                    while not stop.is_set():
                        o = call(*args)
                        calls[i] += 1
                        if same_output(o, pre_out) or any(
                                same_output(o, x) for x in others):
                            continue
                        others.append(o)
                        check(len(others) <= 2, "phase V1: outputs of more "
                              "than two plans under refinement")
                except BaseException as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))

            clients = [threading.Thread(target=client, args=(i,))
                       for i in range(2)]
            for t in clients:
                t.start()
            t0 = time.perf_counter()
            try:
                swapped = svc.refine_once(fp)
            finally:
                stop.set()
                for t in clients:
                    t.join(timeout=120)
            refine_s = time.perf_counter() - t0
            check(not errors and not any(t.is_alive() for t in clients),
                  f"phase V1: a client failed under refinement: {errors}")
            post = svc.current(fp)
            post_out = post(*args)
            check(all(same_output(o, post_out) for o in others),
                  "phase V1: a client's output under refinement is neither "
                  "plan's (a torn output)")
            head = svc.store.load(fp).version
            out["refine"] = {"swapped": swapped, "refine_s": refine_s,
                             "client_calls": calls,
                             "deployed_best_s": deployed.record.best_time_s,
                             "cold_best_s": cold.record.best_time_s,
                             "head_version": head}
            if swapped:
                res = post.search
                out["refine"].update(
                    winner_s=res.best.time_s,
                    winner_bits="".join(map(str, res.best.bits)),
                    measurements=res.ga.evaluations,
                    persistent_hits=res.ga.persistent_hits)
                back = svc.rollback(fp)
                check(back.record.bits == deployed.record.bits
                      and same_output(svc.endpoint(fp)(*args), pre_out)
                      and svc.store.load(fp).version == head + 1,
                      "phase V1: rollback did not restore the previous plan")
            else:
                check(same_output(post_out, pre_out),
                      "phase V1: no swap, yet the plan's output changed")
            check(svc.select_operating_point(fp, "latency")
                  is svc.current(fp), "phase V1: the latency operating "
                  "point of a single-objective plan moved it")
            evicted = svc.evict_stale(0)
            check(fp not in evicted and svc.store.load(fp) is not None,
                  f"phase V1: evict_stale(0) evicted the deployed plan")
            out["final_stats"] = svc.stats.as_dict()
    out["trace"] = v4_report(trace)
    return out


def v4_report(trace: Path) -> dict:
    """Phase V4: ``repro_torch.launch.obsreport`` renders phase V1's
    trace; its ``service.admit`` spans must include a cold search, a warm
    load and the re-measure."""
    spans, metrics = read_trace(str(trace))
    text = obsreport.render(spans, metrics)
    print("phase V4, obsreport of phase V1's trace:", flush=True)
    print(text, flush=True)
    admits = collections.Counter(s["attrs"].get("path") for s in spans
                                 if s["name"] == "service.admit")
    check({"cold-search", "warm-load", "env-remeasure"} <= set(admits),
          f"phase V4: service.admit spans by path: {dict(admits)}")
    by_id = {s["id"]: s for s in spans}

    def search_of(span):
        while span is not None and span["name"] != "plan.search":
            span = by_id.get(span.get("parent"))
        return span

    # each search (cold, re-measure, refinement): its winner and the wall
    # of its fresh timed measurements (the refinement's under two clients)
    searches = {s["id"]: {"best_time_s": s["attrs"].get("best_time_s"),
                          "evaluations": s["attrs"].get("evaluations"),
                          "measure_ms": []}
                for s in sorted(spans, key=lambda s: s["t0"])
                if s["name"] == "plan.search"}
    for s in spans:
        if s["name"] == "eval.measure":
            owner = search_of(s)
            if owner is not None:
                searches[owner["id"]]["measure_ms"].append(s["dur_s"] * 1e3)
    for entry in searches.values():
        ms = entry.pop("measure_ms")
        entry["fresh_measurements"] = len(ms)
        entry["measure_ms_median"] = statistics.median(ms) if ms else None
    return {"spans": len(spans), "service_admit": dict(admits),
            "lines": text.count("\n") + 1,
            "searches": list(searches.values())}


def v2_warm_child(store: Path) -> dict:
    """Phase V2: a fresh process (this script with ``--warm-child``)
    builds the whole Qwen3-0.6B in f32 from path M's seed and plans path
    M's program through a ``PlanService`` on path M's store: the plan must
    be a warm load (no search, no measurement), its forward bit-equal to
    path M's winner and launch each kernel once a bound site."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--warm-child",
         str(store)], capture_output=True, text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  child: {line}", flush=True)
    check(proc.returncode == 0 and lines,
          f"phase V2: the child exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    rep = json.loads(lines[-1])
    rep["child_wall_s"] = wall_s
    print("phase V2:", json.dumps(rep), flush=True)
    check(rep["warm"] and rep["stats"]["searches"] == 0
          and rep["stats"]["warm_loads"] == 1 and rep["search_work"] == [0, 0],
          f"phase V2: the child did not warm-load: {rep}")
    check(rep["rebuilt_s"] == 0.0, "phase V2: the child rebuilt the kernels")
    check(rep["launches"] == rep["bound"] and rep["bound"],
          f"phase V2: the child's forward launched {rep['launches']}, its "
          f"plan binds {rep['bound']}")
    check(rep["bit_equal"], f"phase V2: the child's output differs from "
                            f"path M's winner: {rep['max_abs_diff']}")
    return rep


def warm_child(store: Path, dev) -> int:
    """The child of phase V2 (``--warm-child STORE``); its last line is
    its own JSON report, not the contract line."""
    t_main = time.perf_counter()
    rep: dict = {"imports_s": t_main - _IMPORT_T0}
    t0 = time.perf_counter()
    rep["rebuilt_s"] = build.build_all()
    for name in PATH_KERNELS["M"]:
        build.library(name)
    rep["kernel_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    target, args = path_m(dev)
    torch.cuda.synchronize()
    rep["model_s"] = time.perf_counter() - t0
    trace = store / "child_trace.jsonl"
    config = OffloadConfig(device=str(dev), trace=str(trace),
                           options={"example_args": args})
    t0 = time.perf_counter()
    with PlanService(str(store), config=config) as svc:
        plan = svc.plan(target)
    rep["plan_s"] = time.perf_counter() - t0
    spans, _ = read_trace(str(trace))
    for name in ("plan.prepare", "plan.apply"):
        rep[name.split(".")[1] + "_s"] = sum(s["dur_s"] for s in spans
                                             if s["name"] == name)
    rep.update(warm=plan.warm, stats=svc.stats.as_dict(),
               search_work=list(search_work()),
               fingerprint=plan.fingerprint,
               bits="".join(map(str, plan.record.bits)))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = plan(*args)
    torch.cuda.synchronize()
    rep["first_forward_s"] = time.perf_counter() - t0
    rep["launches"] = {k: n for k, n in ops.launch_counts().items() if n}
    rep["bound"] = kernels_bound(plan.artifact)
    want = torch.load(store / M_WINNER_OUT)
    got = [t.cpu() for t in pytree.tree_leaves(got)]
    rep["bit_equal"] = len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    rep["max_abs_diff"] = max(
        ((a.double() - b.double()).abs().max().item()
         for a, b in zip(got, want) if a.shape == b.shape
         and a.is_floating_point()), default=None)
    rep["child_s"] = time.perf_counter() - _IMPORT_T0
    print(json.dumps(rep), flush=True)
    return 0


def serve_from_store(model, params, prompts, new_tokens: int, store: Path,
                     reference_tokens) -> dict:
    """Phase V3, in serve M: ``PlanService.plan`` of the Qwen3-0.6B config
    (the module frontend's static-cost bundle, GA 4 x 1 from seed 0)
    stores an ``exec_plan`` payload; ``Server.from_store`` on serve M's
    model serves its requests with the same tokens as a server built on
    that plan; then ``swap_plan`` alternates that plan and
    ``REFERENCE_PLAN`` while a client thread generates, and every
    generation's tokens are one of the two plans' tokens."""
    t0 = time.perf_counter()
    with PlanService(str(store), config=OffloadConfig(
            ga=GAConfig(population=4, generations=1, seed=SEED))) as svc:
        plan = svc.plan(get_config("qwen3_0_6b"))
    out = {"plan_s": time.perf_counter() - t0}
    check(isinstance(plan.artifact, ExecPlan)
          and "exec_plan" in plan.record.payload,
          f"phase V3: the config's plan is {type(plan.artifact).__name__}")
    server = Server.from_store(model, params, PlanStore(str(store)),
                               plan.fingerprint)
    check(server.plan == plan.artifact, "phase V3: from_store's plan differs")
    server.generate(prompts, 1)                 # warm-up: the captures
    server.generate(prompts, new_tokens)

    def timed(max_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = server.generate(prompts, max_new)
        return toks, time.perf_counter() - t0

    _, prefill_s = timed(1)
    stored, total_s = timed(new_tokens)
    direct = Server(model, params, plan.artifact).generate(prompts,
                                                           new_tokens)
    check((stored == direct).all(), "phase V3: Server.from_store's tokens "
                                    "differ from a server on the plan")
    out.update(plan="".join(map(str, plan.record.bits)),
               exec_plan=plan.record.payload["exec_plan"],
               prefill_ms=prefill_s * 1e3, generate_ms=total_s * 1e3,
               decode_ms_per_token=(total_s - prefill_s) / (new_tokens - 1)
               * 1e3,
               same_tokens_as_reference_plan=bool(
                   (stored == reference_tokens).all()))
    expected = [stored, reference_tokens]
    errors, stop, gens = [], threading.Event(), [0]

    def client():
        try:
            while not stop.is_set():
                toks = server.generate(prompts, new_tokens)
                gens[0] += 1
                check(any((toks == e).all() for e in expected),
                      "phase V3: a generation under swap_plan gave neither "
                      "plan's tokens")
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    thread = threading.Thread(target=client)
    thread.start()
    try:
        for i in range(4):
            server.swap_plan(plan.artifact if i % 2 == 0 else REFERENCE_PLAN)
            time.sleep(0.25)
        server.swap_plan(plan.artifact)
    finally:
        stop.set()
        thread.join(timeout=300)
    check(not errors and not thread.is_alive(),
          f"phase V3: generate under swap_plan failed: {errors}")
    check((server.generate(prompts, new_tokens) == stored).all(),
          "phase V3: the last swap did not serve the stored plan")
    out["generations_under_swaps"] = gens[0]
    out["seconds"] = time.perf_counter() - t0
    return out


def m_on_callers_thread(dev) -> dict:
    """Path M's plan as before the service (``Offloader.plan`` on this
    thread, the same GA, seed and repeats, a fresh journal): ``--only V``
    runs it beside path M's plan through the service, on one host."""
    target, args = path_m(dev)
    scratch = Path(tempfile.mkdtemp(prefix="plan-M-caller-",
                                    dir=build.BUILD_DIR))
    try:
        pop, gens = PATHS["M"][1]
        t0 = time.perf_counter()
        res = Offloader(OffloadConfig(
            device=str(dev), repeats=PATH_REPEATS["M"],
            ga=GAConfig(population=pop, generations=gens, seed=SEED,
                        cache_dir=str(scratch)),
            options={"example_args": args})).plan(target)
        torch.cuda.synchronize()
        out = {"plan_s": time.perf_counter() - t0, "speedup": res.speedup,
               "measurements": res.ga.evaluations,
               "s_per_chromosome": res.ga.eval_wall_s
               / max(res.ga.evaluations, 1),
               "best_bits": "".join(map(str, res.best.bits))}
    finally:
        shutil.rmtree(scratch)
    print("path M on the caller's thread (Offloader.plan):", json.dumps(out),
          flush=True)
    return out


def phase_service(dev, scratch: Path, m_store: Path) -> dict:
    """Phase V: V1 (with V4, its trace report), then V2 (V3 runs in serve
    M)."""
    t0 = time.perf_counter()
    v1 = v1_lifecycle(dev, scratch)
    v1["seconds"] = time.perf_counter() - t0
    print("phase V1:", json.dumps(v1), flush=True)
    t0 = time.perf_counter()
    v2 = v2_warm_child(m_store)
    v2["seconds"] = time.perf_counter() - t0
    return {"V1": v1, "V2": v2}


def where_time_goes(fn, args, iters: int, warmup: int = None) -> dict:
    """One forward of ``fn``: host wall time (synchronized, no profiler)
    beside the time ``torch.profiler`` records for the device's own
    activities (kernels, copies, memsets; the profiler traces the device
    only: host operator rows would count their kernels twice, and tracing
    them costs minutes on a program of ~220k launches), the device's idle
    share, and the kernels that take the most time.  ``event_ms`` is the
    device's span of one forward by CUDA events, each forward enqueued
    behind a ~5 ms GPU spin so that the host is ahead and the span holds no
    host gaps (median of ``iters``); it does not depend on the profiler
    seeing the kernels.  ``warmup`` calls first (default: up to 3)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(min(3, iters + 1) if warmup is None else warmup):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    spans = []
    for _ in range(iters):
        torch.cuda._sleep(10_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    event_ms = statistics.median(spans)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    # a graph replay's kernels can be missing from the trace while its
    # copies are there: a trace that holds no kernel did not see the
    # program, and its device time is None, as an empty trace's is
    saw_kernels = any(not e.key.startswith(("Memcpy", "Memset"))
                      for e in events)
    device_ms = sum(e.self_device_time_total for e in events) / iters / 1e3 \
        if saw_kernels else 0.0
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "event_ms": event_ms,
            "device_ms": device_ms or None,
            "device_idle_share": 1 - device_ms / wall_ms if device_ms else None,
            "device_launches": sum(e.count for e in events) // iters,
            "top_kernels_ms": [[e.key[:60], e.self_device_time_total / iters / 1e3]
                               for e in top]}


# ---------------------------------------------------------------------------
# phase J: the programs the port captures as CUDA graphs (the reference's
# jax.jit sites), each against the eager port
# ---------------------------------------------------------------------------

#: the card's name and power limit (``nvidia-smi``), beside every phase J
#: line
CARD = {"name_power_limit": None}


def host_submissions(fn, args, programs) -> tuple:
    """One call of ``fn``: the host's submissions to the card (the CUDA
    API rows of ``torch.profiler``, ``cuda*`` and ``cu*``, that launch a
    kernel or a graph, or copy or set memory, by name), and the replays
    the ``programs()`` made (their own counts)."""
    from torch.profiler import ProfilerActivity, profile

    before = sum(p.replays for p in programs())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return _submissions(prof), sum(p.replays for p in programs()) - before


def _submissions(prof) -> dict:
    """The host's submissions to the card a profile holds: its CUDA API
    events (``cuda*``, ``cu*``) that launch a kernel or a graph, or copy or
    set memory, counted by name from the raw events."""
    return dict(collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("cu")
        and any(w in e.name() for w in ("Launch", "Memcpy", "Memset"))))


def first_difference(got, want):
    """None where every leaf of ``got`` equals ``want``'s bit for bit;
    else the first leaf that differs, its shape and the largest absolute
    difference."""
    lg, lw = pytree.tree_leaves(got), pytree.tree_leaves(want)
    if len(lg) != len(lw):
        return {"leaves": [len(lg), len(lw)]}
    for i, (g, w) in enumerate(zip(lg, lw)):
        g = torch.as_tensor(np.asarray(g)) if not isinstance(
            g, torch.Tensor) else g.detach().cpu()
        w = torch.as_tensor(np.asarray(w)) if not isinstance(
            w, torch.Tensor) else w.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            return {"leaf": i, "shapes": [list(g.shape), list(w.shape)]}
        if not torch.equal(g, w):
            return {"leaf": i, "shape": list(g.shape),
                    "max_abs": (g.double() - w.double()).abs().max().item()}
    return None


def _time_entry(t: dict) -> dict:
    return {k: t[k] for k in ("wall_ms", "event_ms", "device_ms",
                              "device_idle_share", "device_launches")}


def capture_entry(what: str, fn, args, new_args, iters: int, programs,
                  replays: int = 1, eager_iters: int = 1) -> dict:
    """Phase J for one program ``fn`` (a captured callable): its eager
    port run (``disable_capture``) against its first call (eager on a side
    stream, then the capture) and a replay, bit for bit; a replay after
    the inputs change (``new_args``) against the eager run on them; host
    submissions of one replayed call (``replays`` graph launches); wall
    and device time and the idle share, eager and captured; the capture's
    seconds (``programs()``: the :class:`DeviceProgram` objects)."""
    with torch.no_grad():
        with disable_capture():
            want, want_new = fn(*args), fn(*new_args)
            eager = where_time_goes(fn, args, eager_iters, warmup=0)
        t0 = time.perf_counter()
        first = fn(*args)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        replay = fn(*args)
        got_new = fn(*new_args)
        torch.cuda.synchronize()
        check(first_difference(want_new, want) is not None,
              f"phase J {what}: the new inputs gave the old output")
        for name, a, b in (("a replay", replay, want),
                           ("a replay on new inputs", got_new, want_new)):
            v = verify(b, a, rtol=1e-2, atol=1e-2)
            check(v.ok, f"phase J {what}: {name} differs from the eager "
                        f"port: {v}")
        check(first_difference(got_new, replay) is not None,
              f"phase J {what}: a replay on new inputs gave the old output")
        captured = where_time_goes(fn, args, iters)
        subs, n = host_submissions(fn, args, programs)
    progs = programs()
    check(progs and all(p.captured for p in progs),
          f"phase J {what}: nothing was captured")
    check(n == replays, f"phase J {what}: one call made {n} replays, not "
                        f"{replays} ({subs})")
    return {"bit_equal": first_difference(replay, want) is None,
            "differs": first_difference(replay, want),
            "first_call_differs": first_difference(first, want),
            "new_inputs_bit_equal": first_difference(got_new, want_new)
            is None,
            "host_submissions_per_call": subs, "replays_per_call": n,
            "eager": eager, "captured": captured, "first_call_s": first_s,
            "warmup_s": sum(p.warmup_s for p in progs),
            "capture_s": sum(p.capture_s for p in progs),
            "graphs": len(progs)}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (on the (1, 1) mesh, the whole), a plain
    tensor itself."""
    return getattr(t, "_local_tensor", t)


def _train_leaves(state) -> dict:
    """{path: tensor} of a train state: its parameters, moments, step
    count and error-feedback residuals."""
    out = {f"params/{k}": p for k, p in state.params.named_parameters()}
    out["opt/step"] = state.opt.step
    for n in ("mu", "nu"):
        out.update({f"opt/{n}/{k}": t for k, t in getattr(state.opt,
                                                          n).items()})
    if state.comp is not None:
        out.update({f"comp/{k}": t for k, t in state.comp.error.items()})
    return out


def capture_info(captured) -> dict:
    """The warm-up and capture seconds and the replays of a captured
    train step's one program."""
    (prog,) = captured.programs.values()
    return {"warmup_s": prog.warmup_s, "capture_s": prog.capture_s,
            "replays": prog.replays}


def _stash(leaves: dict, spare: int) -> dict:
    """Each leaf's value (a DTensor's local shard) copied where it fits: on
    the card while its free memory exceeds the copy by ``spare`` bytes,
    else in host memory (slower to move back)."""
    need = sum(_local(t).numel() * t.element_size() for t in leaves.values())
    where = "cuda" if torch.cuda.mem_get_info()[0] > need + spare else "cpu"
    return {k: _local(t).detach().to(where, copy=True)
            for k, t in leaves.items()}


def _train_difference(got: dict, want: dict):
    """None where every leaf of ``got`` (path -> tensor on the card) equals
    ``want``'s bit for bit; else how many differ, the first, its shape and
    the largest absolute difference among them."""
    bad = []
    for k, w in want.items():
        g = _local(got[k]).detach()
        w = w.to(g.device)
        if not torch.equal(g, w):
            bad.append((k, (g.double() - w.double()).abs().max().item()))
    if not bad:
        return None
    return {"leaves": len(bad), "first": bad[0][0],
            "shape": list(got[bad[0][0]].shape),
            "max_abs": max(d for _, d in bad)}


def _wall_ms(fn) -> tuple:
    """One call of ``fn``: its result and its host wall ms, synchronized
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _profiled_ms(fn, host: bool = False) -> tuple:
    """One call of ``fn`` under the profiler: its result, its host wall ms,
    the device's own activities' ms and count (summed from the raw
    events: a train step has ~82k) and, with ``host``, the host's
    submissions to the card (:func:`_submissions`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        out, wall = _wall_ms(fn)
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return out, wall, sum(e.duration_ns() for e in dev) / 1e6, len(dev), \
        _submissions(prof) if host else {}


def train_capture_entry(what: str, fn, captured, state, batch) -> dict:
    """Phase J for a train step ``fn`` (``state, batch -> (state,
    metrics)``) whose captured program ``captured`` (a ``jit_step``) the
    steps before captured on ``state``.  From one snapshot of ``state``,
    restored into the state's own tensors before each run, on the same
    batch: an eager step (``disable_capture``), profiled (the device's
    activities only: its wall time is the profiled run's), its result
    kept; a replay, timed; a replay, profiled with the host's submissions.
    The first replay is held to the eager step bit for bit; where it
    differs, a second eager step says whether two eager steps differ too
    (``eager_twice``: the step's own atomics, not the capture), and a
    replay that differs where they agree fails.  Wall and device time and
    the idle share, eager and captured, and the capture's seconds;
    ``state`` is left as the snapshot was.  The snapshot and the kept
    result sit on the card where it has room for them beside the graph's
    pool and an eager step's transients, else in host memory."""
    t_start = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves = _train_leaves(state)
    state_bytes = sum(_local(t).numel() * t.element_size()
                      for t in leaves.values())
    # room for the kept result and an eager step's transients (about two
    # states' worth on these steps) besides the snapshot
    snap = _stash(leaves, 4 * state_bytes)

    def restore():
        with torch.no_grad():
            for k, t in _train_leaves(state).items():
                _local(t).copy_(snap[k])

    def one() -> dict:
        st, m = fn(state, batch)
        return {**{f"metrics/{k}": v.clone() for k, v in m.items()},
                **_train_leaves(st)}

    with disable_capture():
        got, eager_ms, eager_dev, eager_n, _ = _profiled_ms(one)
        eager_peak = torch.cuda.max_memory_allocated() - held
        want = _stash(got, eager_peak)
    restore()
    got, cap_ms = _wall_ms(one)
    differs = _train_difference(got, want)
    eager_twice = None
    if differs is not None:
        restore()
        with disable_capture():
            eager_twice = _train_difference(one(), want)
    restore()
    progs = list(captured.programs.values())
    before = sum(p.replays for p in progs)
    _, _, cap_dev, cap_n, subs = _profiled_ms(lambda: fn(state, batch),
                                              host=True)
    n = sum(p.replays for p in progs) - before
    restore()
    on_card = next(iter(snap.values())).device.type == "cuda"
    del got, snap, want
    gc.collect()
    check(progs and all(p.captured for p in progs),
          f"phase J {what}: nothing was captured")
    check(n == 1, f"phase J {what}: one step made {n} replays ({subs})")
    check(differs is None or eager_twice is not None,
          f"phase J {what}: a replay differs from the eager step where two "
          f"eager steps agree: {differs}")
    return {"bit_equal": differs is None, "differs": differs,
            "eager_twice_differs": eager_twice,
            "host_submissions_per_call": subs, "replays_per_call": n,
            "eager": {"wall_ms": eager_ms, "device_ms": eager_dev,
                      "device_idle_share": 1 - eager_dev / eager_ms,
                      "device_launches": eager_n},
            "captured": {"wall_ms": cap_ms, "device_ms": cap_dev,
                         "device_idle_share": 1 - cap_dev / cap_ms,
                         "device_launches": cap_n},
            "warmup_s": sum(p.warmup_s for p in progs),
            "capture_s": sum(p.capture_s for p in progs),
            "graphs": len(progs), "snapshot_on_card": on_card,
            "device_bytes_held": held,
            "device_bytes_peak": torch.cuda.max_memory_allocated(),
            "entry_s": time.perf_counter() - t_start}


def print_capture(label: str, entries: dict) -> None:
    print(f"phase J {label}:", json.dumps({"card": CARD["name_power_limit"],
                                           **entries}), flush=True)


def new_inputs(args: tuple) -> tuple:
    """Other inputs of the same shapes: floats halved, token ids rolled."""
    return tuple(a * 0.5 if a.is_floating_point() else a.roll(1, -1)
                 for a in args)


def decode_capture_entry(bound, prompts, prompt_len: int) -> dict:
    """Phase J for a served model's decode step: from a prefill of the
    prompts (room for 64 more tokens), the eager step against the captured
    step's first call (eager, then the capture), and the next step (a
    replay, the state donated and written in place) against the eager next
    step; then where one step's time goes, eager (the same step repeated,
    as the serve line took it before the capture) and captured
    (consecutive steps on the donated state)."""
    with torch.no_grad():
        _, state = bound.prefill(prompts, prompt_len + 64)
        base = pytree.tree_map(lambda t: t.clone(), state)

        def fresh():
            return pytree.tree_map(lambda t: t.clone(), base)

        last = prompts["tokens"][:, -1:]
        with disable_capture():
            want, want_st = bound.decode(last, fresh())
            nxt = torch.argmax(want[:, -1], -1, keepdim=True).to(torch.int32)
            want2, _ = bound.decode(nxt, want_st)
            st = fresh()
            eager = where_time_goes(lambda: bound.decode(last, st), (), 5)
        t0 = time.perf_counter()
        got, cst = bound.decode(last, fresh())
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got2, cst = bound.decode(nxt, cst)
        torch.cuda.synchronize()
        for name, a, b in (("the first step", got, want),
                           ("a replay of the next step", got2, want2)):
            v = verify(b, a, rtol=1e-2, atol=1e-2)
            check(v.ok, f"phase J decode: {name} differs from the eager "
                        f"step: {v}")
        check(first_difference(got2, got) is not None,
              "phase J decode: the next step's replay gave the first "
              "step's logits")
        captured = where_time_goes(lambda: bound.decode(last, cst), (), 5)
        subs, n = host_submissions(
            lambda: bound.decode(last, cst), (),
            lambda: list(bound._decode.programs.values()))
    progs = list(bound._decode.programs.values())
    check(n == 1, f"phase J decode: one step made {n} replays ({subs})")
    return {"bit_equal": first_difference(got2, want2) is None,
            "differs": first_difference(got2, want2),
            "first_call_differs": first_difference(got, want),
            "host_submissions_per_call": subs, "replays_per_call": n,
            "eager": eager, "captured": captured, "first_call_s": first_s,
            "capture_s": sum(p.capture_s for p in progs),
            "graphs": len(progs)}


def short_kernel_names(mangled: list) -> list:
    """``rmsnorm_rows_kernel<__nv_bfloat16, __nv_bfloat16, 128>`` for each
    mangled kernel name (demangled by the CUDA toolkit's ``cu++filt`` or
    by ``c++filt``; left as they are where neither is found)."""
    cuda_filt = Path(build.nvcc()).parent / "cu++filt"
    tool = str(cuda_filt) if cuda_filt.exists() else shutil.which("c++filt")
    if tool is None:
        return list(mangled)
    out = subprocess.run([tool], input="\n".join(mangled), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    names = []
    for name in out:
        for noise in ("(anonymous namespace)::", "<unnamed>::", "(int)",
                      "(bool)"):
            name = name.replace(noise, "")
        name = name[len("void "):] if name.startswith("void ") else name
        depth = 0                      # cut the parameter list
        for i, ch in enumerate(name):
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                name = name[:i]
                break
        names.append(name)
    return names


def _journal_fingerprint(scratch: Path) -> str:
    journals = sorted(scratch.glob("measurements_*.jsonl"))
    check(len(journals) == 1, f"expected one measurement journal, got "
                              f"{[p.name for p in journals]}")
    return journals[0].stem[len("measurements_"):]


# ---------------------------------------------------------------------------
# phase D: sharding and the mesh
# ---------------------------------------------------------------------------

#: D1: the whole Qwen3-0.6B in f32, one sequence of 2048 tokens, the
#: OFFLOAD_PLAN (chunked attention) at a constant lr
D1_SEQ, D1_STEPS, D1_LR = 2048, 2, 1e-3
#: D2: the GA over Q's block with the mesh gene in the alphabet
D2_GA = (4, 2)
D2_MESH = "mesh:data:1:batch"
#: D3: the production meshes, each traced in a child process
D3_MESHES = ("pod16x16", "pod2x16x16")


def d3_start(out_dir: Path) -> dict:
    """D3's children, started together before D1: ``launch.dryrun`` of
    Qwen3-0.6B's train_4k on each production mesh (a fake world of 256
    or 512 ranks, fake tensors on the card's device type)."""
    procs = {}
    for mesh in D3_MESHES:
        log = open(out_dir / f"{mesh}.log", "w")
        procs[mesh] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3_0_6b", "--shape", "train_4k", "--mesh", mesh, "--out",
             str(out_dir)], stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}),
            log, time.perf_counter())
    return procs


def d3_finish(procs: dict, out_dir: Path) -> dict:
    """D3's records, checked: status ok, every group an axis of the mesh
    (a divisor of its size), a 16-rank group on both, a 2-rank (``pod``)
    one on the multi-pod mesh, and per-device FLOPs x devices at least the
    model's 6 N D."""
    n_active = get_config("qwen3_0_6b").param_count(active_only=True)
    out = {}
    for mesh, (proc, log, t0) in procs.items():
        rc = proc.wait(timeout=600)
        log.close()
        wall = time.perf_counter() - t0
        path = out_dir / f"qwen3_0_6b__train_4k__{mesh}__production.json"
        check(rc == 0 and path.exists(),
              f"D3 {mesh}: dryrun exited {rc}: "
              f"{(out_dir / (mesh + '.log')).read_text()[-3000:]}")
        rec = json.loads(path.read_text())
        check(rec["status"] == "ok", f"D3 {mesh}: {rec.get('error')}")
        n = rec["n_devices"]
        groups = {int(k.split("@g")[1]) for k in rec["collectives"]}
        check(groups and all(n % g == 0 for g in groups),
              f"D3 {mesh}: collective groups {sorted(groups)} of {n}")
        check(16 in groups, f"D3 {mesh}: no 16-rank collective: "
                            f"{rec['collectives']}")
        check((2 in groups) == (mesh == "pod2x16x16"),
              f"D3 {mesh}: 2-rank collectives {sorted(groups)}")
        tokens = int(rec["reduced"].split("-> ")[1].split()[0]) * 4096
        roof = rec["roofline"]
        ratio = roof["flops"] * n / rl.model_flops_train(n_active, tokens)
        check(ratio >= 1.0, f"D3 {mesh}: per-device FLOPs x {n} is "
                            f"{ratio} of 6 N D")
        out[mesh] = {
            "live_bytes": rec["memory"]["live_bytes"],
            "param_bytes": rec["memory"]["param_bytes"],
            "fits_80gb": rec["memory"]["fits_80gb"],
            "collectives": rec["collectives"],
            "compute_ms": roof["compute_s"] * 1e3,
            "memory_ms": roof["memory_s"] * 1e3,
            "collective_ms": roof["collective_s"] * 1e3,
            "flops_over_6nd": ratio, "lower_s": rec["lower_s"],
            "compile_s": rec["compile_s"], "child_wall_s": wall,
            "reduced": rec["reduced"], "link_bw_note": rec["link_bw_note"]}
        print(f"D3 {mesh}:", json.dumps(out[mesh]), flush=True)
    return out


def _train_steps(step, state, batch, label: str) -> tuple:
    """``D1_STEPS`` steps, each timed; the last profiled for its device
    launches (kernels whose name says NCCL counted apart)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    losses, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(D1_STEPS):
        last = i == D1_STEPS - 1
        prof = profile(activities=[ProfilerActivity.CUDA]) if last \
            else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof:
            state, metrics = step(state, batch)
            loss = metrics["loss"]
            loss = loss.full_tensor() if hasattr(loss, "full_tensor") \
                else loss
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count]
    nccl = {e.key[:60]: e.count for e in events if "nccl" in e.key.lower()}
    res = {"losses": losses, "step_s": secs,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "device_launches": sum(e.count for e in events),
           "nccl_launches": nccl}
    print(f"D1 {label}:", json.dumps(res), flush=True)
    return state, res


def d1_host_mesh_train(dev) -> dict:
    """D1: ``make_host_mesh()`` (NCCL at world size 1, a (1, 1) mesh); the
    whole Qwen3-0.6B (28 layers, f32, random weights from seed 0) for 2
    steps of ``jit_train_step`` (captured: the first an eager step and the
    capture, the second a replay) against 2 eager steps of
    ``make_train_step`` from the same init: losses and every updated
    parameter within 1e-5; phase J's entry of the sharded step; then
    ``reshard`` of the step-2 checkpoint onto the same mesh, bit-equal."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.fault_tolerance import reshard
    from repro_torch.runtime.train import (init_train_state, jit_train_step,
                                           make_train_step, state_shardings)

    mesh = make_host_mesh()
    check(list(mesh.shape) == [1, 1] and dist.get_world_size() == 1,
          f"D1: host mesh {mesh}")
    res = {"mesh": [list(mesh.shape), list(mesh.mesh_dim_names)],
           "backend": str(dist.get_backend())}
    cfg = get_config("qwen3_0_6b")
    model = build_model(cfg)
    plan = OFFLOAD_PLAN.replace(compute_dtype="float32")
    batch = model.demo_batch(torch.Generator().manual_seed(1), 1, D1_SEQ,
                             device=dev)
    lr = lambda s: D1_LR                                      # noqa: E731
    rules = shd.make_rules(mesh)
    plain = init_train_state(model, torch.Generator().manual_seed(SEED),
                             device=dev)
    plain, res["plain"] = _train_steps(
        make_train_step(model, plan, OptimizerConfig(), lr), plain, batch,
        "make_train_step")
    # the plain run's parameters wait on the host, so that each run's peak
    # is its own
    want = {n: p.detach().cpu() for n, p in plain.params.named_parameters()}
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    sharded = init_train_state(model, torch.Generator().manual_seed(SEED),
                               device=dev)
    shardings = state_shardings(sharded, rules, cfg)
    sharded_step = jit_train_step(model, plan, OptimizerConfig(), lr, rules,
                                  shardings)
    sharded, res["sharded"] = _train_steps(sharded_step, sharded, batch,
                                           "jit_train_step")
    for a, b in zip(res["plain"]["losses"], res["sharded"]["losses"]):
        check(abs(a - b) <= 1e-5, f"D1: losses {res['plain']['losses']} "
                                  f"against {res['sharded']['losses']}")
    worst = max((want[n] - q.detach().full_tensor().cpu()).abs().max()
                .item() for n, q in sharded.params.named_parameters())
    check(worst <= 1e-5, f"D1: parameters differ by {worst}")
    res["max_param_diff"] = worst
    del want
    res["sharded"].update(capture_info(sharded_step.jitted))
    res["J"] = train_capture_entry("D1", sharded_step, sharded_step.jitted,
                                   sharded, batch)
    print_capture("D1", {"jit_train_step": res["J"]})
    del sharded_step
    ckpt_dir = Path(tempfile.mkdtemp(prefix="reshard-", dir=build.BUILD_DIR))
    try:
        ckpt = CheckpointManager(str(ckpt_dir), async_save=False)
        t0 = time.perf_counter()
        ckpt.save(D1_STEPS, sharded, blocking=True)
        res["save_s"] = time.perf_counter() - t0
        want = {n: p.detach().full_tensor().clone()
                for n, p in sharded.params.named_parameters()}
        want_mu = {n: v.full_tensor().clone()
                   for n, v in sharded.opt.mu.items()}
        t0 = time.perf_counter()
        _, back = reshard(ckpt, sharded, shardings)
        res["reshard_s"] = time.perf_counter() - t0
        same = all(torch.equal(p.detach().full_tensor(), want[n])
                   for n, p in back.params.named_parameters()) and all(
            torch.equal(v.full_tensor(), want_mu[n])
            for n, v in back.opt.mu.items())
        check(same, "D1: the resharded checkpoint is not bit-equal")
        res["reshard_bit_equal"] = same
        res["checkpoint_bytes"] = ckpt.saves[-1].get("bytes")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del sharded, back, want, want_mu
    gc.collect()
    torch.cuda.empty_cache()
    return res


def d2_mesh_destination(dev, scratch: Path) -> dict:
    """D2: Q's block (bf16) with one RMSNorm site on ``mesh:data:1:batch``
    and the attention and the other RMSNorm sites on ``cuda``: the site
    runs through ``local_map`` over 1 x data, flash and RMSNorm launch once
    a site, and the program verifies; ``Offloader.plan`` with the mesh gene
    in the alphabet (GA 4 x 2, seed 0) verifies its winner, and a
    ``PlanStore`` round trip of a plan holding a mesh gene rehydrates
    bit-equal; ``mesh:data:8:batch`` falls back with its reason."""
    import dataclasses as dc

    from repro_torch.core.frontends.registry import decoded_pattern
    from repro_torch.core.genes import VARIANT_ALPHABET
    from repro_torch.service import record_from_result

    block, args = path_q(dev)
    alphabet = VARIANT_ALPHABET + (D2_MESH,)
    cfg = OffloadConfig(
        destinations=alphabet, repeats=1,
        ga=GAConfig(population=D2_GA[0], generations=D2_GA[1], seed=SEED,
                    cache_dir=str(scratch)),
        options={"example_args": args})
    off = Offloader(cfg)
    ctx = off.prepare(block)
    coding, graph = ctx.coding, ctx.graph
    engine = ctx.bundle.context["engine"]
    check(ctx.bundle.mesh_executed, "D2: the export bundle does not "
                                    "execute mesh genes")
    bits = list(forced_chromosome(graph, coding))
    norms = [i for i, s in enumerate(coding.sites)
             if graph.by_name(s.region).meta.get("pattern") == "rmsnorm"]
    mesh_at = norms[0]
    bits[mesh_at] = alphabet.index(D2_MESH)
    bits = tuple(bits)
    region = coding.sites[mesh_at].region
    sub = engine.substitute(decoded_pattern(coding, bits, {}),
                            destinations=coding.destinations_of(bits))
    choice = next(c for c in sub.report.choices if c.region == region)
    check(choice.chosen == D2_MESH and "local_map over 1xdata" in choice.why,
          f"D2: the mesh site chose {choice.chosen}: {choice.why}")
    ops.reset_launch_counts()
    with torch.no_grad():
        out = sub(*args)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["flash_attention"] == 1
          and launches["rmsnorm"] == len(norms) - 1,
          f"D2: one forward launched {launches}, not flash once and "
          f"RMSNorm {len(norms) - 1} times")
    v = engine.verify(sub)
    check(v.ok, f"D2: the forced mesh program does not verify: {v}")
    res = {"mesh_site": region, "why": choice.why,
           "launches": {k: n for k, n in launches.items() if n},
           "forced_verify": {"max_abs": v.max_abs, "max_rel": v.max_rel}}
    print("D2 forced:", json.dumps(res), flush=True)
    t0 = time.perf_counter()
    plan_res = off.search(ctx)
    res["ga_s"] = time.perf_counter() - t0
    check(plan_res.verification["verified"], "D2: the GA's winner does not "
                                             "verify")
    res["winner"] = dict(plan_res.destinations)
    res["winner_mesh_genes"] = sum(d.startswith("mesh:")
                                   for d in plan_res.destinations.values())
    store = PlanStore(str(scratch / "store"))
    rec = dc.replace(record_from_result(plan_res, ctx.fingerprint),
                     bits=bits)
    store.put(rec)
    loaded = store.load(ctx.fingerprint)
    check(list(loaded.mesh_destinations()) == [region],
          f"D2: stored mesh genes {loaded.mesh_destinations()}")
    art = store.rehydrate(loaded, block, config=cfg)
    with torch.no_grad():
        again = art(*args)
    check(all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(again), pytree.tree_leaves(out))),
        "D2: the rehydrated mesh plan is not bit-equal")
    res["store_round_trip_bit_equal"] = True
    far = engine.substitute({region: "ref"},
                            destinations={region: "mesh:data:8:batch"})
    why8 = next(c for c in far.report.choices if c.region == region).why
    check("unavailable" in why8 and "modeled cost" in why8,
          f"D2: mesh:data:8:batch at {region}: {why8}")
    res["why_8"] = why8
    print("D2:", json.dumps(res), flush=True)
    return res


def phase_mesh(dev, scratch: Path) -> dict:
    """Phase D: D3's children start first and trace while D1 and D2 run on
    the card; their records are read last."""
    t0 = time.perf_counter()
    procs = d3_start(scratch)
    try:
        out = {"D1": d1_host_mesh_train(dev)}
        print("D1:", json.dumps({k: v for k, v in out["D1"].items()
                                 if k not in ("plain", "sharded", "J")}),
              flush=True)
        done_d1 = time.perf_counter() - t0
        out["D2"] = d2_mesh_destination(dev, scratch)
        done_d2 = time.perf_counter() - t0
        out["D3"] = d3_finish(procs, scratch)
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase D: {out['seconds']:.1f} s (D1 {done_d1:.1f} s, D2 "
          f"{done_d2 - done_d1:.1f} s, D3 waited "
          f"{out['seconds'] - done_d2:.1f} s more)", flush=True)
    return out


def main(argv: list) -> int:
    """The full run with no arguments.  ``--only K`` runs the build and
    phase K alone; ``--only Z`` the build and paths L, B, A, G and N with
    their serving (and its phase J entries); ``--only V`` runs the build,
    path M (through the planning service, then on this thread for
    comparison), serve M (with V3) and phase V; ``--only D`` the build and
    phase D; ``--only C`` the build, phase C2 and phase C3 (its children
    started first); the last line of each says so (``phase K alone: ok``,
    ...), not the full run's contract line.  ``--warm-child STORE`` is phase V2's child, ``--c3-trace ARCH
    OUT`` one of phase C3's."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--warm-child":
        return warm_child(Path(argv[1]), torch.device("cuda", 0))
    if len(argv) == 3 and argv[0] == "--c3-trace":
        return c3_trace_child(argv[1], Path(argv[2]))
    check(argv in ([], ["--only", "K"], ["--only", "V"], ["--only", "D"],
                   ["--only", "C"], ["--only", "Z"]),
          "usage: chip_smoke.py [--only K|V|D|C|Z]")
    only = argv[1] if argv else None
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    m_store = Path(tempfile.mkdtemp(prefix="plan-store-M-",
                                    dir=build.BUILD_DIR))
    c3_dir = Path(tempfile.mkdtemp(prefix="dryrun-C3-", dir=build.BUILD_DIR))
    children = []
    try:
        return run_all(only, m_store, c3_dir, children)
    finally:
        # a phase that failed leaves C3's children tracing: stop them
        # before their directory goes
        for proc, log in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(m_store, ignore_errors=True)
        shutil.rmtree(c3_dir, ignore_errors=True)


def run_all(only, m_store: Path, c3_dir: Path, children: list) -> int:
    """The phases of :func:`main`; path M's plan store is ``m_store``,
    phase C3's children write under ``c3_dir`` and are listed in
    ``children`` as (process, log) for :func:`main` to stop."""
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD["name_power_limit"] = smi.stdout.strip().splitlines()[0]
    print(CARD["name_power_limit"], flush=True)
    print(f"NVML board power: {nvml_power_w()} W (repro_torch.core."
          f"objectives.nvml_power_w)", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(build.SOURCES)})", flush=True)
    for name in build.SOURCES:
        raw = build.resource_usage(name)
        usage = dict(zip(short_kernel_names(list(raw)), raw.values()))
        print(f"resources {name}", json.dumps(usage), flush=True)
        if name in NO_SPILL:
            spills = {k: v for k, v in usage.items()
                      if v.get("spill_stores") or v.get("spill_loads")}
            check(not spills, f"{name}: kernels spill: {spills}")

    kernels = None
    if only is None:
        kernels = phase_kernels(dev)
        print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    by_path, plans = {}, {}
    sub_keys = {"flash_attention": "launches_by_kernel_path",
                "rmsnorm": "launches_by_variant",
                "rglru_scan": "launches_by_route"}

    def record(label, launches, counts):
        by_path[label] = launches
        if kernels is None:
            return
        for name in PATH_KERNELS[label]:
            if name in sub_keys:
                kernels[name].setdefault(sub_keys[name], {})[label] = \
                    counts[name]

    def run_path(label):
        scratch = Path(tempfile.mkdtemp(prefix=f"plan-{label}-",
                                        dir=build.BUILD_DIR))
        store = m_store if label in SERVICE_PATHS else None
        try:
            launches, by_kernel, plans[label] = phase_path(label, dev,
                                                           scratch, store)
            record(label, launches, by_kernel)
        finally:
            shutil.rmtree(scratch)
        done(f"path {label}")

    def run_phase(label, fn, counts_its_plans=False):
        """A phase driven with the launch counters set to 0 just before it
        and read just after, or, ``counts_its_plans``, the launches of its
        plans as it returns them; each of its kernels must have launched."""
        scratch = Path(tempfile.mkdtemp(prefix=f"plan-{label}-",
                                        dir=build.BUILD_DIR))
        ops.reset_launch_counts()
        try:
            planned = fn(dev, scratch)
        finally:
            shutil.rmtree(scratch)
        launches, counts = planned if counts_its_plans else \
            (ops.launch_counts(), sub_counts())
        for name in PATH_KERNELS[label]:
            check(launches[name] > 0,
                  f"phase {label}: the {name} kernel was never launched")
        check_sub_counts(label, "its plans", counts, launches,
                         PATH_KERNELS[label])
        record(label, launches, counts)
        print(f"phase {label} launches:", json.dumps(launches),
              json.dumps(counts), flush=True)
        done(f"phase {label}")

    def done(what):
        print(f"{what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    v_s = {}

    def run_v():
        t0 = time.perf_counter()
        run_phase("V", functools.partial(phase_service, m_store=m_store))
        v_s["V1, V2"] = time.perf_counter() - t0
        print(f"phase V: {sum(v_s.values()):.1f} s (V1 and V2 "
              f"{v_s['V1, V2']:.1f} s, V3 {v_s['V3']:.1f} s)", flush=True)

    def run_zoo():
        """Paths L, B, A, G and N, each alone on the card, then served (SL,
        SB, SA, SG, SN; their decode steps in phase J), the Server casting
        the f32 draw to its plan's bf16 once."""
        for label, arch in ZOO.items():
            free_models()
            run_path(label)
            serve_phase(dev, label, lambda d, _, a=arch: _model_f32(d, a),
                        SERVE_NEW_H, False)
            done(f"serve {label}")
        free_models()

    def serve_m():
        out = serve_phase(dev, "M", qwen3_model, SERVE_NEW, True,
                          store=m_store)
        v_s["V3"] = out["V3"]["seconds"]
        done("serve M")

    if only == "K":
        run_phase("K", phase_blocks, counts_its_plans=True)
        print("phase K alone: ok", flush=True)
        return 0
    if only == "D":
        run_phase("D", phase_mesh)
        print("phase D alone: ok", flush=True)
        return 0
    if only == "C":
        c3_procs = c3_start(c3_dir, C3_MESHES)
        children.extend((p, log) for p, log, _ in c3_procs.values())
        phase_cost_plan(dev)
        done("phase C2")
        phase_scan_train(dev, c3_procs, c3_dir)
        print("phase C alone: ok", flush=True)
        return 0
    if only == "Z":
        run_zoo()
        print("phase Z alone: ok", flush=True)
        return 0
    if only == "V":
        run_path("M")
        m_on_callers_thread(dev)
        serve_m()
        run_v()
        print("phase V alone: ok", flush=True)
        return 0
    # numeric Python source through the python_ast frontend
    run_phase("P", phase_python)
    # function-block genes at published widths
    run_phase("K", phase_blocks, counts_its_plans=True)
    run_path("Q")
    # path Q's prepares serial against overlapped
    scratch = Path(tempfile.mkdtemp(prefix="plan-QO-", dir=build.BUILD_DIR))
    try:
        phase_overlap(dev, scratch)
    finally:
        shutil.rmtree(scratch)
    done("path Q, serial against overlapped prepares")
    for label in ("R", "W", "M", "H"):
        run_path(label)
    for label, make_model, n_sites in (
            ("M", qwen3_model, len(PATH_M_SITES)),
            ("H", recurrentgemma_model, len(PATH_H_SITES))):
        bf16_diagnostic(dev, label, make_model, n_sites)
        done(f"bf16 diagnostic {label}")
    serve_m()
    serve_phase(dev, "H", recurrentgemma_model, SERVE_NEW_H, False)
    done("serve H")
    # the planning service: Q's lifecycle, M's plan warm-loaded in a fresh
    # process
    run_v()
    # the whole OLMoE, then the whole RWKV-6: each alone on the card; the
    # Server casts the f32 draw to its plan's bf16 once
    free_models()
    run_path("E")
    moe_dense_forward(dev)
    done("path E under dense_onehot")
    serve_phase(dev, "E", lambda d, _: _model_f32(d, "olmoe_1b_7b"),
                SERVE_NEW_H, False)
    done("serve E")
    free_models()
    run_path("F")
    serve_phase(dev, "F", lambda d, _: _model_f32(d, "rwkv6_3b"),
                SERVE_NEW_H, False)
    done("serve F")
    free_models()
    # the whole Whisper-small: its prefill planned, its bf16 diagnostic,
    # and serving (path SW), the Server casting the f32 draw once
    run_path("X")
    bf16_diagnostic(dev, "X", whisper_model,
                    sum(v == "cuda" for _, v in PATH_X_SITES), causal_sites)
    done("bf16 diagnostic X")
    serve_phase(dev, "X", lambda d, _: whisper_model(d, torch.float32),
                SERVE_NEW, True, prompt_len=SERVE_PROMPT_X)
    done("serve X")
    # the zoo configs no other path runs: LLaVA-NeXT-Mistral-7B,
    # Qwen1.5-4B, Llama-4 Scout, Gemma-7B and TinyLlama-1.1B
    run_zoo()
    # phase C3's dry-run children trace beside phases T and C2
    c3_procs = c3_start(c3_dir, ("h100x1",))
    children.extend((p, log) for p, log, _ in c3_procs.values())
    phase_train(dev)
    done("phase T")
    c2 = phase_cost_plan(dev)
    done("phase C2")
    c3 = phase_scan_train(dev, c3_procs, c3_dir)
    done("phase C3")
    # sharding and the mesh: a (1, 1) host mesh, an executed mesh gene,
    # the production meshes traced
    run_phase("D", phase_mesh)
    c1_s = sum(r["analyze_s"] for p in plans.values()
               for r in p.get("roofline", {}).values())
    print(f"phase C: {c1_s + c2['seconds'] + c3['seconds']:.1f} s (C1 "
          f"{c1_s:.1f} s: the graph walks of "
          f"{sum(len(p.get('roofline', {})) for p in plans.values())} "
          f"programs; C2 {c2['seconds']:.1f} s; C3 {c3['seconds']:.1f} s)",
          flush=True)
    # each path's planning: wall time, the function-block genes that bind,
    # and what the overlap phase did
    print("planning by path:", json.dumps(plans), flush=True)
    for name, entry in kernels.items():
        per_path = {label: counts[name] for label, counts in by_path.items()
                    if name in PATH_KERNELS[label]}
        entry["launches"] = sum(per_path.values())
        entry["launches_by_path"] = per_path
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
