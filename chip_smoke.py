"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

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
   and a few edge cases), with its time (CUDA events, median
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
   and on path R every RG-LRU launch the ``tma`` route.

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
     seed 0 in the reference's distributions) built with ``build_model``,
     its prefill of (2, 2048) tokens -> (last-token logits, decode state)
     planned through a lambda over ``Model.prefill`` in f32, GA 8 x 4: 28
     ``softmax_attention`` + 113 ``rmsnorm`` sites (ln1, q-norm, k-norm and
     ln2 of each layer, and the final norm); one forward of the forced
     all-kernel plan must launch flash 28 times and RMSNorm 113 times.
     Then the same model in bf16: the forced all-kernel bf16 prefill against
     the bf16 reference, each output leaf's error printed (a diagnostic:
     nothing is asserted on it); and ``Server.generate`` in bf16 under
     ``OFFLOAD_PLAN``: 4 requests of 512 prompt tokens and 32 greedy new
     tokens, twice (identical tokens), then under ``REFERENCE_PLAN`` after
     ``swap_plan`` (the tokens of a server built on that plan), with the
     prefill time, the decode time per token and tokens/s;
   - H: the whole RecurrentGemma-2B (26 layers at full width in the
     pattern rglru, rglru, local attention; random weights from seed 0 in
     the reference's distributions) built with ``build_model``, its
     prefill of (2, 2048) tokens -- S = the local window, so the local
     attention is exactly causal -- planned like M in f32 (the ``step``
     scan: one scan site a recurrent sublayer), GA 4 x 2 (cut from 6 x 3
     for the run's time): 18 ``linear_recurrence`` + 8
     ``softmax_attention`` + 53 ``rmsnorm`` sites;
     one forward of the forced all-kernel plan must launch RG-LRU 18 times
     (all ``tma``), flash 8 times (all ``scalar``) and RMSNorm 53 times
     (all ``d2560_l32``).  The all-reference program (~220k launches) is
     profiled for one forward.  Then the bf16 diagnostic of the forced
     all-kernel prefill, and ``Server.generate`` in bf16 under
     ``OFFLOAD_PLAN`` (the ``assoc`` scan in prefill; RG-LRU states and ring
     caches in decode): 4 requests of 512 prompt tokens and 16 greedy new
     tokens, twice (identical tokens), with the launches of a decode step;
   - E: the whole OLMoE-1B-7B (16 layers at full width, 64 experts top-8 of
     width 1024, MHA with QK-norm; random weights from seed 0), alone on the
     card, its prefill of (2, 2048) tokens planned in f32 under the
     ``scatter_ep`` MoE, GA 6 x 3 seeded with the forced all-kernel
     chromosome: exactly 16 ``softmax_attention`` + 65 ``rmsnorm`` sites
     (no router, expert or MoE region binds); one forward of the forced
     plan must launch flash 16 times (all ``scalar``) and RMSNorm 65 times
     (33 ``generic_l32``, 32 ``d128_l32``); no chromosome may fail with an
     error; the all-reference prefill run twice gives the same bits.  The
     forced plan verifies (outcome a), or (outcome b) a routing diagnostic
     finds a (layer, token) whose top-k set the kernels' rounding changed
     while the layer-0 K and V stay within 1e-4 of the reference's; either
     is printed with the per-layer K/V errors.  Then one all-reference
     forward under ``dense_onehot`` (time only), and ``Server.generate``
     in bf16 under ``OFFLOAD_PLAN`` (16 new tokens);
   - F: the whole RWKV-6-3B (32 layers at full width, 40 heads of 64),
     alone on the card: its f32 prefill of (2, 2048) tokens once under the
     ``step`` WKV form and once ``chunked`` (they must agree under the
     verifier's rule), then the ``chunked`` prefill planned with GA 4 x 2,
     seeded like E: only the final norm binds (``d2560_l32``); the 65
     LayerNorm regions (x, scale, bias) and the 32 multi-head WKV scans
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
     tokens, twice (identical tokens), then after ``swap_plan``.

   On every path the verifier runs as the fitness runs it (the reference
   kept on the card, each pair compared there in f64; ``verify_s``) and as
   the parent commit ran it (the reference as f64 host arrays, the
   candidate copied over; ``verify_host_s``), and the path's peak device
   memory is printed;
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
   - T4: ``_run`` again with ``--resume --steps 8``: it restores step 4
     and its replayed steps 4 and 5 must match T3's losses within 1e-4
     relative; the checkpoints are deleted after;

5. a ``{"kernels": [...]}`` line (each RMSNorm and RG-LRU entry carries its
   per-shape rows beside the path sums), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Needs a CUDA device; without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import copy
import ctypes
import functools
import gc
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch._dynamo  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch._higher_order_ops.scan import scan  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.evaluator import MeasurementCache  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
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
from repro_torch.runtime.serve import Server  # noqa: E402

#: H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them,
#: HBM3 bandwidth.  Bounds below are against these, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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
SEED = 0
REPEATS = 25
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


def bound_ms(n_bytes: float, flops: float, peak_flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / peak_flops
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
    n_bytes = 2 * n * d * x.element_size() + d * s.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4.0 * n * d,
                                                PEAK_F32_FLOPS)
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
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4.0 * b * hq * d * pairs
    n_bytes = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * q.element_size()
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, flops, peak)
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
    n = b * s * d
    n_bytes = 3 * n * 4 + (b * d * 4 if h0 else 0)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 3.0 * n,
                                                PEAK_F32_FLOPS)
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
    n = b * s * h * d
    # the step form: about 4 f32 operations per state entry per step
    row["bound_ms"], row["bound_by"] = bound_ms(
        5 * n * 4 + h * d * 4, 4.0 * n * d, PEAK_F32_FLOPS)
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
    rg = get_config("recurrentgemma_2b")
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

    # path H's 53 calls per prefill, in f32: ln1 and ln2 of each of 26
    # sublayers and the final norm over the last token's rows
    path_h_norms = [(tokens, rg.d_model)] * (2 * rg.n_layers) \
        + [(BATCH, rg.d_model)]
    norms_h = {}
    for n, d in sorted(set(path_h_norms)):
        norms_h[(n, d)] = rmsnorm_case(dev, n, d, f32, 1e-5, flush, gen)
        print("rmsnorm  ", json.dumps(norms_h[(n, d)]), flush=True)
    # path E's 65 calls per prefill, in f32: ln1, q-norm, k-norm (16 kv
    # heads: as many rows as the q-norm) and ln2 of each of 16 layers, and
    # the final norm; d_model 2048 takes the generic loop.  Path F's one
    # call is path H's final norm, (2, 2560)
    olmoe = get_config("olmoe_1b_7b")
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
                                     for r in x_non_causal]})
    rglru_entry = _entry("rglru_scan", path_rglru,
                         replaces="src/repro/kernels/rglru_scan.py:55",
                         path_h={"calls_per_prefill": 2 * (rg.n_layers // 3)
                                 + rg.n_layers % 3,
                                 "note": "the prefill's calls run path R's "
                                         "row (h0 = 0, time-major)",
                                 "h0_row": {k: path_h_rglru_h0[k] for k in (
                                     "shape", "route", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by")}},
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
    """The whole Qwen3-0.6B (28 layers, full width), weights drawn from
    seed 0 in the reference's distributions on a CPU generator, then moved
    to the card in ``dtype``; tokens uniform in [0, vocab) from the same
    generator, batch 2 x 2048."""
    cfg = get_config("qwen3_0_6b")
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg)
    params = model.init(gen, dtype=dtype, device=dev)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen)
    return model, params, tokens.to(dev)


def path_m(dev):
    model, params, tokens = qwen3_model(dev, PATH_M_DTYPE)
    plan = REFERENCE_PLAN.replace(compute_dtype=str(PATH_M_DTYPE)[6:])
    return (lambda tok: model.prefill(params, {"tokens": tok}, plan),
            (tokens,))


@functools.lru_cache(maxsize=1)
def _model_f32(dev, arch: str):
    """The whole ``arch`` at its published widths, weights drawn from seed
    0 in the reference's distributions on a CPU generator and moved to the
    card in f32 as drawn (the host holds one tensor at a time); tokens
    uniform in [0, vocab) from the same generator, batch 2 x 2048.  Kept
    on the card until another model is asked for or ``free_models``."""
    cfg = get_config(arch)
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(gen, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"{arch}: {sum(w.numel() for w in params.parameters())} "
          f"parameters drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen)
    return model, params, tokens.to(dev)


def recurrentgemma_model(dev, dtype):
    """The whole RecurrentGemma-2B (26 layers, full width), weights drawn
    from seed 0 in the reference's distributions on a CPU generator, then
    moved to the card; tokens uniform in [0, vocab) from the same
    generator, batch 2 x 2048 (= the local window).  The f32 draw is made
    once and kept on the card; another ``dtype`` is that draw cast as
    ``Model.init`` casts it (every weight but the RG-LRU's ``lam``)."""
    model, params, tokens = _model_f32(dev, "recurrentgemma_2b")
    if dtype != torch.float32:
        memo = {id(w): torch.nn.Parameter(w.detach().to(dtype))
                for name, w in params.named_parameters()
                if not name.endswith(".lam")}
        params = copy.deepcopy(params, memo)
    return model, params, tokens


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
    """Drop the full-depth model kept on the card, so the next path's peak
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

#: sites of path H: 18 recurrences, 8 local attentions, two norms a
#: sublayer and the final norm
PATH_H_SITES = ([("linear_recurrence", "cuda")] * 18
                + [("softmax_attention", "cuda")] * 8
                + [("rmsnorm", "cuda")] * (2 * 26 + 1))

#: sites of path E: attention and four norms a layer, and the final norm;
#: no router, expert or MoE region
PATH_E_SITES = ([("softmax_attention", "cuda")] * 16
                + [("rmsnorm", "cuda")] * (4 * 16 + 1))
#: sites of path F: the final norm binds; the embedding's and each
#: layer's two LayerNorms (x, scale, bias) and the 32 multi-head WKV scans
#: match and are refused
PATH_F_SITES = ([("rmsnorm", "cuda")] + [("rmsnorm", "ref")] * (1 + 2 * 32)
                + [("wkv_recurrence", "ref")] * 32)
#: sites of path X: 62 norms and 12 causal self-attentions on the
#: kernels, the 12 encoder and 12 cross-attentions on ``ref``
PATH_X_SITES = [(p, v) for _, p, v in whisper_sites(WHISPER)]
#: paths whose matched sites the export must find in this program order
PATH_SITE_ORDER = {"X": [(m, p) for m, p, _ in whisper_sites(WHISPER)]}

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
}
#: paths with top-k routing: the reference must repeat bit for bit, and
#: the forced plan verifies or a routing diagnostic explains why not
ROUTED = {"E"}
#: paths whose search is seeded with the forced chromosome
#: (``Offloader.search``'s ``extra_seeds``), and on which no chromosome at
#: all may fail with an error
SEEDED = {"E", "F", "X"}


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
                 "X": {"generic_l32"}}
#: RMSNorm launches by variant of one forward of the forced plan, where
#: a path pins them: path E's ln1, ln2 and final norm at d 2048 take the
#: generic loop, its q- and k-norms the d = 128 instance; path X's 62
#: norms at d 768 all take the generic loop
PATH_VARIANT_COUNTS = {"E": {"generic_l32": 33, "d128_l32": 32},
                       "X": {"generic_l32": len(x_norm_calls(WHISPER))}}
PATH_ROUTES = {"R": {"tma"}, "H": {"tma"}}
#: the flash path each path's launches take (paths M, H, E and X in f32,
#: path H at head dim 256: ``scalar``)
PATH_FLASH = {"Q": "wgmma", "M": "scalar", "H": "scalar", "E": "scalar",
              "X": "scalar"}


def sub_counts() -> dict:
    """Each kernel's launches by flash path, RMSNorm variant, RG-LRU route."""
    return {"flash_attention": dict(ops.flash_attention.launches_by_path),
            "rmsnorm": dict(ops.rmsnorm.launches_by_variant),
            "rglru_scan": dict(ops.rglru_scan.launches_by_route)}


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
    every other site on ``ref``."""
    bits = []
    for s in coding.sites:
        region = graph.by_name(s.region)
        if not region.meta.get("pattern"):
            bits.append(0)
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
             if r.meta.get("pattern")]
    want = PATH_SITE_ORDER[label]
    first = next((i for i, (f, w) in enumerate(itertools.zip_longest(
        found, want)) if f != w), None)
    if first is not None:
        check(False, f"path {label}: the export found {len(found)} matched "
                     f"sites ({dict(collections.Counter(p for _, p in found))})"
                     f", not the {len(want)} expected in program order; site "
                     f"{first}: found {found[first:first + 1]}, expected "
                     f"{want[first:first + 1]}")


def phase_path(label, dev, scratch: Path) -> tuple:
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
    config = OffloadConfig(device=str(dev), ga=ga, repeats=3,
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

    engine = res.details["engine"]
    matched = {s.region: res.graph.by_name(s.region).meta.get("pattern")
               for s in res.coding.sites}
    check_site_order(label, res.graph, res.coding)
    forced_bits = forced_chromosome(res.graph, res.coding, site_variant)
    t0 = time.perf_counter()
    forced = engine.substitute(res.coding.decode(forced_bits))
    substitute_s = time.perf_counter() - t0
    chosen = [(c.pattern, c.chosen) for c in forced.report.choices
              if c.pattern]
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
        "speedup": res.speedup, "best_s": res.best.time_s,
        "baseline_s": res.baseline.time_s,
        "best_bits": "".join(map(str, res.best.bits)),
        "chosen": per_site,
        "measurements": res.ga.evaluations,
        "s_per_chromosome": res.ga.eval_wall_s / max(res.ga.evaluations, 1),
        "plan_s": plan_s, "verify_failures": verify_fails,
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
    for name, fn in (("baseline (all ref)", unsubstituted),
                     ("plan winner", res.artifact), ("all kernels", forced)):
        print(f"where the time goes, path {label}, {name}:",
              json.dumps(where_time_goes(fn, args, iters)), flush=True)
    print(f"path {label} device memory: {resident_gb:.2f} GB held when the "
          f"program is made, {planned_gb:.2f} GB after planning, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return launches, {k: search_counts[k] for k in kernels
                      if k in search_counts}


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


def routing_flips(model, params, tokens) -> dict:
    """Each layer's top-k experts for every token of path E's eager
    prefill, once as it is and once with the forced plan's kernels swapped
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
                model.prefill(params, {"tokens": tokens}, PATH_E_PLAN)
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
    model, params, tokens = _model_f32(dev, "olmoe_1b_7b")
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
           **routing_flips(model, params, tokens)}
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


def rwkv_forms(dev) -> dict:
    """Path F's prefill once under the ``step`` WKV form (the reference's
    oracle: a scan of 2048 steps a layer) and once under ``chunked``: the
    wall time of each, and the verifier's rule between them."""
    model, params, tokens = _model_f32(dev, "rwkv6_3b")
    outs, out = {}, {}
    for form in ("step", "chunked"):
        plan = PATH_F_PLAN.replace(wkv_impl=form)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            outs[form] = model.prefill(params, {"tokens": tokens}, plan)
        torch.cuda.synchronize()
        out[f"{form}_wall_s"] = time.perf_counter() - t0
    v = verify(outs["step"], outs["chunked"], rtol=1e-2, atol=1e-2)
    out.update(verified=v.ok, max_abs=v.max_abs, max_rel=v.max_rel)
    print("path F, step against chunked:", json.dumps(out), flush=True)
    check(v.ok, f"path F: the chunked prefill differs from the step one: {v}")
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


def serve_phase(dev, label: str, make_model, new_tokens: int,
                swap: bool, prompt_len: int = SERVE_PROMPT) -> dict:
    """``Server.generate`` on path ``label``'s model in bf16 under
    ``OFFLOAD_PLAN`` (``make_model`` gives its weights in bf16, or in f32
    for the ``Server`` to cast once, keeping the leaves the reference reads
    in f32): 4 requests of ``prompt_len`` prompt tokens (and the model's
    other inputs, an enc-dec model's frames, drawn as ``Model.demo_batch``
    draws them), ``new_tokens`` greedy new tokens.  Two calls give identical tokens; with ``swap``,
    after ``swap_plan(REFERENCE_PLAN)`` the next call gives the tokens of a
    server built on that plan.  Times: a prefill (``max_new = 1``: prefill
    and one sample), the whole call, and the decode time per token between
    them; and where one decode step's time goes (its device launches)."""
    model, params, _ = make_model(dev, torch.bfloat16)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(SEED + 1)
    prompts = {"tokens": torch.randint(
        0, cfg.vocab, (SERVE_BATCH, prompt_len), generator=gen).to(dev)}
    prompts.update((k, v) for k, v in model.demo_batch(
        gen, SERVE_BATCH, prompt_len, device=dev).items()
        if k not in ("tokens", "labels"))
    server = Server(model, params, OFFLOAD_PLAN)
    server.generate(prompts, 2)                 # warm-up

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
           "new_tokens": new_tokens, "dtype": "bfloat16",
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
    # one decode step at the last position of these requests' caches
    # (repeating it rewrites the same cache slot; a hybrid model's RG-LRU
    # state is read, not written), where its time goes
    bound = server._bound
    with torch.no_grad():
        _, state = bound.prefill(prompts, prompt_len + new_tokens)
        last = prompts["tokens"][:, -1:]
        step = where_time_goes(lambda: bound.decode(last, state), (), 5)
    out[f"decode_step_{'reference' if swap else 'offload'}_plan"] = step
    print(f"serve, path {label}:", json.dumps(out), flush=True)
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
T3_STEPS, T4_STEPS = 6, 8


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
    8``, which restores step 4 and replays steps 4 and 5."""
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
    t3 = {"seconds": time.perf_counter() - t0,
          "plan_updates": run.plan_updates,
          "remat": run.plan.remat, "microbatch": run.plan.microbatch,
          "n_params": sum(p.numel() for p in run.state.params.parameters()),
          "losses": losses, "step_seconds": secs,
          "s_per_step_median_2_6": s_step, "tokens_per_s": T3_BATCH * T3_SEQ / s_step,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "checkpoint_saves": run.ckpt.saves}
    print("T3:", json.dumps(t3), flush=True)
    batch = run.batch_fn(T3_STEPS)
    t3["one_step"] = where_time_goes(
        lambda: run.step_fn(run.state, batch), (), 1)
    print("T3 one step:", json.dumps(t3["one_step"]), flush=True)
    del run, batch
    gc.collect()
    torch.cuda.empty_cache()

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


def where_time_goes(fn, args, iters: int) -> dict:
    """One forward of ``fn``: host wall time (synchronized, no profiler)
    beside the time ``torch.profiler`` records for the device's own
    activities (kernels, copies, memsets; the profiler traces the device
    only: host operator rows would count their kernels twice, and tracing
    them costs minutes on a program of ~220k launches), the device's idle
    share, and the kernels that take the most time.  ``event_ms`` is the
    device's span of one forward by CUDA events, each forward enqueued
    behind a ~5 ms GPU spin so that the host is ahead and the span holds no
    host gaps (median of ``iters``); it does not depend on the profiler
    seeing the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(min(3, iters + 1)):
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
    device_ms = sum(e.self_device_time_total for e in events) / iters / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "event_ms": event_ms,
            "device_ms": device_ms or None,
            "device_idle_share": 1 - device_ms / wall_ms if device_ms else None,
            "device_launches": sum(e.count for e in events) // iters,
            "top_kernels_ms": [[e.key[:60], e.self_device_time_total / iters / 1e3]
                               for e in top]}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
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

    kernels = phase_kernels(dev)
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    by_path = {}
    sub_keys = {"flash_attention": "launches_by_kernel_path",
                "rmsnorm": "launches_by_variant",
                "rglru_scan": "launches_by_route"}

    def run_path(label):
        scratch = Path(tempfile.mkdtemp(prefix=f"plan-{label}-",
                                        dir=build.BUILD_DIR))
        try:
            by_path[label], by_kernel = phase_path(label, dev, scratch)
            for name, counts in by_kernel.items():
                if name in sub_keys:
                    kernels[name].setdefault(sub_keys[name], {})[label] = \
                        counts
        finally:
            shutil.rmtree(scratch)
        done(f"path {label}")

    def done(what):
        print(f"{what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    for label in ("Q", "R", "W", "M", "H"):
        run_path(label)
    for label, make_model, n_sites in (
            ("M", qwen3_model, len(PATH_M_SITES)),
            ("H", recurrentgemma_model, len(PATH_H_SITES))):
        bf16_diagnostic(dev, label, make_model, n_sites)
        done(f"bf16 diagnostic {label}")
    for label, make_model, new_tokens, swap in (
            ("M", qwen3_model, SERVE_NEW, True),
            ("H", recurrentgemma_model, SERVE_NEW_H, False)):
        serve_phase(dev, label, make_model, new_tokens, swap)
        done(f"serve {label}")
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
    rwkv_forms(dev)
    done("path F, step and chunked")
    run_path("F")
    serve_phase(dev, "F", lambda d, _: _model_f32(d, "rwkv6_3b"),
                SERVE_NEW_H, False)
    done("serve F")
    # the whole Whisper-small: its prefill planned, its bf16 diagnostic,
    # and serving (path SW), the Server casting the f32 draw once
    free_models()
    run_path("X")
    bf16_diagnostic(dev, "X", whisper_model,
                    sum(v == "cuda" for _, v in PATH_X_SITES), causal_sites)
    done("bf16 diagnostic X")
    serve_phase(dev, "X", lambda d, _: whisper_model(d, torch.float32),
                SERVE_NEW, True, prompt_len=SERVE_PROMPT_X)
    done("serve X")
    free_models()
    phase_train(dev)
    done("phase T")
    for name, entry in kernels.items():
        per_path = {label: counts[name] for label, counts in by_path.items()
                    if name in PATHS[label][3]}
        entry["launches"] = sum(per_path.values())
        entry["launches_by_path"] = per_path
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
