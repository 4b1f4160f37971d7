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
   paths' shapes (and a few edge cases), with its time (CUDA events, median
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
   matched site and match the unsubstituted program; no chromosome that
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
4. a ``{"kernels": [...]}`` line (each RMSNorm and RG-LRU entry carries its
   per-shape rows beside the path sums), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Needs a CUDA device; without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
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
#: path M's serving requests: 4 prompts of 512 tokens, 32 new tokens each
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 32
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

    path_flash = flash_case(dev, BATCH, SEQ, SEQ, nq, nkv, hd, True, bf16,
                            2e-2, 1e-2, flush, gen)
    print("flash    ", json.dumps(path_flash), flush=True)
    path_m_flash = flash_case(dev, BATCH, SEQ, SEQ, nq, nkv, hd, True, f32,
                              2e-5, 1e-4, flush, gen)
    print("flash    ", json.dumps(path_m_flash), flush=True)
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
    rglru_rows = [path_rglru]
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
        shapes=[{k: norms[nd][k] for k in row_keys}
                for nd in sorted(norms)])
    flash_entry = _entry("flash_attention", path_flash,
                         replaces="src/repro/kernels/flash_attention.py:73",
                         shape=path_flash["shape"], path=path_flash["path"],
                         design=path_flash["design"],
                         block_rel_err=path_flash["block_rel_err"],
                         host_us=path_flash["host_us"],
                         path_m={"calls_per_prefill": cfg.n_layers,
                                 **{k: path_m_flash[k] for k in (
                                     "shape", "dtype", "path", "design",
                                     "max_abs_err", "block_rel_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}})
    rglru_entry = _entry("rglru_scan", path_rglru,
                         replaces="src/repro/kernels/rglru_scan.py:55",
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


#: path M plans the prefill in f32: in bf16 one rounding flip of a
#: normalized key (|k| up to ~4, a bf16 step of 0.0156 there) fails the
#: verifier's 1e-2 (see the bf16 diagnostic)
PATH_M_DTYPE = torch.float32
#: sites of path M: attention and four norms a layer, and the final norm
PATH_M_SITES = ([("softmax_attention", "cuda")] * 28
                + [("rmsnorm", "cuda")] * (4 * 28 + 1))

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
}


#: the kernel each pattern's ``cuda`` variant launches
PATTERN_KERNEL = {"softmax_attention": "flash_attention",
                  "rmsnorm": "rmsnorm", "linear_recurrence": "rglru_scan",
                  "wkv_recurrence": "wkv6"}

#: the RMSNorm variants each path's widths select (path Q: d_model 1024 and
#: the q/k-norms' head_dim 128; path R: d_model 2560, all bf16), and the
#: RG-LRU route path R's time-major views take
PATH_VARIANTS = {"Q": {"d1024_l32", "d128_l16"}, "R": {"d2560_l32"},
                 "M": {"d1024_l32", "d128_l32"}}
PATH_ROUTES = {"R": {"tma"}}
#: the flash path each path's launches take (path M in f32: ``scalar``)
PATH_FLASH = {"Q": "wgmma", "M": "scalar"}


def phase_path(label, dev, scratch: Path) -> tuple:
    make, (pop, gens), expected, kernels, iters = PATHS[label]
    target, args = make(dev)
    with torch.no_grad():
        reference = target(*args)
    torch.cuda.synchronize()
    first = pytree.tree_leaves(reference)[0]
    print(f"path {label} output: {len(pytree.tree_leaves(reference))} "
          f"tensor(s), the first {tuple(first.shape)} max |y| "
          f"{first.float().abs().max().item():.4f}", flush=True)

    ga = GAConfig(population=pop, generations=gens, seed=SEED,
                  cache_dir=str(scratch))
    config = OffloadConfig(device=str(dev), ga=ga, repeats=3,
                           options={"example_args": args},
                           log=lambda s: print(f"  plan {label}:", s,
                                               flush=True))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = Offloader(config).plan(target)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    flash_paths = dict(ops.flash_attention.launches_by_path)
    sub_counts = {"flash_attention": flash_paths,
                  "rmsnorm": dict(ops.rmsnorm.launches_by_variant),
                  "rglru_scan": dict(ops.rglru_scan.launches_by_route)}
    print(f"path {label} launches:", json.dumps(launches),
          "flash by kernel path:", json.dumps(flash_paths),
          "rmsnorm by variant:", json.dumps(sub_counts["rmsnorm"]),
          "rglru by route:", json.dumps(sub_counts["rglru_scan"]),
          flush=True)
    for name in kernels:
        check(launches[name] > 0,
              f"path {label}: the {name} kernel was never launched by the "
              f"search")
    if "flash_attention" in kernels:
        want = PATH_FLASH[label]
        check(flash_paths[want] == launches["flash_attention"],
              f"path {label}: flash launches went through {flash_paths}, "
              f"not all through the {want} path")
    for name, want in (("rmsnorm", PATH_VARIANTS.get(label)),
                       ("rglru_scan", PATH_ROUTES.get(label))):
        if name not in kernels:
            continue
        got = {k for k, n in sub_counts[name].items() if n}
        check(got == want and sum(sub_counts[name].values())
              == launches[name],
              f"path {label}: {name} launches went through "
              f"{sub_counts[name]}, not {sorted(want)}")

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
    forced_bits = tuple(2 if matched[s.region] else 0
                        for s in res.coding.sites)
    t0 = time.perf_counter()
    forced = engine.substitute(res.coding.decode(forced_bits))
    substitute_s = time.perf_counter() - t0
    chosen = [(c.pattern, c.chosen) for c in forced.report.choices
              if c.pattern]
    check(sorted(chosen) == sorted(expected),
          f"path {label}: forced all-kernel plan did not bind the kernels: "
          f"{chosen} ({forced.report.fallbacks})")
    before = ops.launch_counts()
    forced_out = forced(*args)
    torch.cuda.synchronize()
    forced_launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                       if n != before[k]}
    want = {name: sum(1 for p, _ in expected if PATTERN_KERNEL[p] == name)
            for name in kernels}
    check(forced_launches == want,
          f"path {label}: one forward of the forced all-kernel plan launched "
          f"{forced_launches}, not {want}")
    # the verifier as the fitness runs it: the reference already on the
    # host in f64, the candidate converted and compared
    reference64 = pytree.tree_map(
        lambda x: x.detach().to("cpu", torch.float64).numpy(), reference)
    t0 = time.perf_counter()
    fv = verify(reference64, forced_out, rtol=1e-2, atol=1e-2)
    verify_s = time.perf_counter() - t0
    del reference64
    print(f"path {label} forced all-kernel plan: {len(chosen)} sites bound, "
          f"max_abs {fv.max_abs} max_rel {fv.max_rel}, one forward "
          f"launched {json.dumps(forced_launches)}", flush=True)
    check(fv.ok, f"path {label}: forced all-kernel plan differs from the "
                 f"program: {fv}")

    # every measured chromosome, from the search's measurement journal
    records = MeasurementCache(str(scratch),
                               _journal_fingerprint(scratch)).load()
    kernel_errors, verify_fails = [], {}
    for bits, ev in records.items():
        impl = res.coding.decode(bits)
        if "error" in ev.detail and any(
                engine.resolved_impl(r, i) == "cuda" for r, i in impl.items()):
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
        "artifact_max_abs": v.max_abs, "forced_max_abs": fv.max_abs,
        "forced_max_rel": fv.max_rel, "forced_launches": forced_launches,
        "substitute_s": substitute_s, "verify_s": verify_s,
        "graph_nodes": len(engine.gm.graph.nodes),
        "gene_length": res.coding.length,
        "launches": launches, "flash_launches_by_kernel_path": flash_paths,
        "rmsnorm_launches_by_variant": sub_counts["rmsnorm"],
        "rglru_launches_by_route": sub_counts["rglru_scan"]}
    print(f"path {label}:", json.dumps(summary), flush=True)
    unsubstituted = engine.substitute({})
    for name, fn in (("baseline (all ref)", unsubstituted),
                     ("plan winner", res.artifact), ("all kernels", forced)):
        print(f"where the time goes, path {label}, {name}:",
              json.dumps(where_time_goes(fn, args, iters)), flush=True)
    return launches, {k: sub_counts[k] for k in kernels if k in sub_counts}


def bf16_diagnostic(dev) -> dict:
    """Path M's forced all-kernel prefill in bf16 against the bf16
    reference: each output leaf's largest errors (logits, then the K and V
    caches of each layer).  Nothing is asserted on them."""
    model, params, tokens = qwen3_model(dev, torch.bfloat16)
    plan = REFERENCE_PLAN
    offloader = Offloader(OffloadConfig(
        device=str(dev), options={"example_args": (tokens,)}))
    ctx = offloader.prepare(
        lambda tok: model.prefill(params, {"tokens": tok}, plan))
    engine = ctx.bundle.context["engine"]
    forced_bits = tuple(
        2 if ctx.graph.by_name(site.region).meta.get("pattern") else 0
        for site in ctx.coding.sites)
    forced = engine.substitute(ctx.coding.decode(forced_bits))
    bound = sum(c.chosen == "cuda" for c in forced.report.choices)
    check(bound == len(PATH_M_SITES),
          f"bf16 diagnostic: {bound} sites bound to the kernels, not "
          f"{len(PATH_M_SITES)}")
    got = forced(tokens)
    torch.cuda.synchronize()
    want = engine.reference()
    logits, state = want
    names = ["logits"] + [f"{kv}{i}" for i in range(len(state["kv"]))
                          for kv in ("k", "v")] + ["cache_len"]
    leaves = zip(names, pytree.tree_leaves(want), pytree.tree_leaves(got))
    per_leaf = {}
    for name, r, c in leaves:
        lv = verify(r, c, rtol=1e-2, atol=1e-2)
        per_leaf[name] = {"max_abs": lv.max_abs, "max_rel": lv.max_rel,
                          "ok": lv.ok}
    whole = verify(want, got, rtol=1e-2, atol=1e-2)
    out = {"verified": whole.ok, "max_abs": whole.max_abs,
           "max_rel": whole.max_rel,
           "leaves_failing": sorted(n for n, lv in per_leaf.items()
                                    if not lv["ok"]),
           "per_leaf": per_leaf}
    print("bf16 diagnostic, path M forced all-kernel prefill:",
          json.dumps(out), flush=True)
    return out


def serve_phase(dev) -> dict:
    """``Server.generate`` on the whole Qwen3-0.6B in bf16 under
    ``OFFLOAD_PLAN``: 4 requests of 512 prompt tokens, 32 greedy new
    tokens.  Two calls give identical tokens; after ``swap_plan(
    REFERENCE_PLAN)`` the next call gives the tokens of a server built on
    that plan.  Times: a prefill (``max_new = 1``: prefill and one
    sample), the whole call, and the decode time per token between them."""
    model, params, _ = qwen3_model(dev, torch.bfloat16)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(SEED + 1)
    prompts = {"tokens": torch.randint(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=gen).to(dev)}
    server = Server(model, params, OFFLOAD_PLAN)
    server.generate(prompts, 2)                 # warm-up

    def timed(max_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = server.generate(prompts, max_new)
        return toks, time.perf_counter() - t0

    _, prefill_s = timed(1)
    first, total_s = timed(SERVE_NEW)
    second, _ = timed(SERVE_NEW)
    check(first.shape == (SERVE_BATCH, SERVE_NEW),
          f"serve: tokens of shape {first.shape}")
    check(bool(((first >= 0) & (first < cfg.vocab)).all()),
          "serve: a token outside the vocab")
    check((first == second).all(), "serve: two greedy calls differ")
    server.swap_plan(REFERENCE_PLAN)
    check(server.plan is REFERENCE_PLAN, "serve: swap_plan did not bind")
    swapped = server.generate(prompts, SERVE_NEW)
    fresh = Server(model, params, REFERENCE_PLAN).generate(prompts, SERVE_NEW)
    check((swapped == fresh).all(),
          "serve: the call after swap_plan did not run the new plan")
    decode_s = (total_s - prefill_s) / (SERVE_NEW - 1)
    # one decode step at the last position of these requests' caches
    # (repeating it rewrites the same cache slot), where its time goes
    bound = server._bound
    with torch.no_grad():
        _, state = bound.prefill(prompts, SERVE_PROMPT + SERVE_NEW)
        last = prompts["tokens"][:, -1:]
        step = where_time_goes(lambda: bound.decode(last, state), (), 5)
    out = {"requests": SERVE_BATCH, "prompt_tokens": SERVE_PROMPT,
           "new_tokens": SERVE_NEW, "dtype": "bfloat16",
           "prefill_ms": prefill_s * 1e3, "generate_ms": total_s * 1e3,
           "decode_ms_per_token": decode_s * 1e3,
           "tokens_per_s": SERVE_BATCH * SERVE_NEW / total_s,
           "decode_tokens_per_s": SERVE_BATCH / decode_s,
           "same_tokens_offload_and_reference_plan":
               bool((first == swapped).all()),
           "decode_step_reference_plan": step}
    print("serve, path M:", json.dumps(out), flush=True)
    return out


def where_time_goes(fn, args, iters: int) -> dict:
    """One forward of ``fn``: host wall time (synchronized, no profiler)
    beside the time ``torch.profiler`` records for the device's own
    activities (kernels, copies, memsets; CPU-side operator rows would count
    their kernels twice), the device's idle share, and the kernels that take
    the most time.  ``event_ms`` is the device's span of one forward by CUDA
    events, each forward enqueued behind a ~5 ms GPU spin so that the host
    is ahead and the span holds no host gaps (median of ``iters``); it does
    not depend on the profiler seeing the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    for label in PATHS:
        scratch = Path(tempfile.mkdtemp(prefix=f"plan-{label}-",
                                        dir=build.BUILD_DIR))
        try:
            by_path[label], sub_counts = phase_path(label, dev, scratch)
            for name, counts in sub_counts.items():
                if name in sub_keys:
                    kernels[name].setdefault(sub_keys[name], {})[label] = \
                        counts
        finally:
            shutil.rmtree(scratch)
        print(f"path {label} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    bf16_diagnostic(dev)
    print(f"bf16 diagnostic done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    serve_phase(dev)
    print(f"serve done at {time.perf_counter() - t_start:.1f} s", flush=True)
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
