"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, and the build of every hand-written kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, started together);
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes (and a few edge cases), with its time (CUDA events, median
   of 25 launches, L2 flushed before each), the plain version's time, the
   time of the one PyTorch call that computes the same function
   (``library_ms``, timed here only), and its bound on an H100 SXM;
3. the main path: ``Offloader.plan`` over one full-width Qwen3-0.6B dense
   block (d_model 1024, 16 q / 8 kv heads, head_dim 128, d_ff 3072) in bf16
   at batch 2 x 2048 tokens, GA population 8 x 4 generations, seed 0.  The
   kernels' launch counters are set to 0 just before it and read just
   after; the plan must verify, the forced all-kernel plan must bind the
   CUDA kernels at all 5 sites and match the unsubstituted block, and no
   chromosome that selects a kernel may have failed with an error; then,
   for the all-reference program, the plan's winner and the all-kernel
   program, where one forward's time goes (``torch.profiler``: device time,
   idle share, top kernels);
4. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Needs a CUDA device; without one it exits non-zero and prints no result.
"""
from __future__ import annotations

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

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.evaluator import MeasurementCache  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.core.verifier import verify  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.models.transformer import INIT_STD, DenseBlock  # noqa: E402

#: H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them,
#: HBM3 bandwidth.  Bounds below are against these, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

BATCH, SEQ = 2, 2048
SEED = 0
REPEATS = 25


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {what}")


def bound_ms(n_bytes: float, flops: float, peak_flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median over REPEATS calls, CUDA events around each, L2 flushed (a
    64 MiB write) before each.  A GPU-side spin (~0.5 ms) before the start
    event lets the host enqueue the whole call first, so the time is the
    device's and not the Python launch overhead's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPEATS):
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
            tol: float) -> float:
    """Max |got - want|; fails unless |got - want| <= tol + tol*|want|
    everywhere."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=tol, rtol=tol),
          f"{what}: max abs err {err} outside tolerance {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rmsnorm_case(dev, n, d, dtype, tol, flush, gen):
    x = torch.randn(n, d, generator=gen).to(dev, dtype)
    s = (torch.randn(d, generator=gen) * 0.1).to(dev, dtype)
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    err = compare(f"rmsnorm ({n},{d}) {dtype}", got, rmsnorm_plain(x, s), tol)
    w = 1.0 + s.float()
    row = {"shape": [n, d], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err,
           "ms": time_ms(lambda: ops.rmsnorm(x, s), flush),
           "plain_ms": time_ms(lambda: rmsnorm_plain(x, s), flush),
           "library_ms": time_ms(
               lambda: F.rms_norm(x, (d,), w.to(dtype), 1e-6), flush)}
    n_bytes = 2 * n * d * x.element_size() + d * s.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4.0 * n * d,
                                                PEAK_F32_FLOPS)
    return row


def flash_case(dev, b, sq, sk, hq, hkv, d, causal, dtype, tol, flush, gen):
    q = torch.randn(b, sq, hq, d, generator=gen).to(dev, dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen).to(dev, dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen).to(dev, dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal,
                                 scale=1.0 / math.sqrt(d))
    err = compare(f"flash ({b},{sq},{sk},{hq},{hkv},{d}) causal={causal} "
                  f"{dtype}", got, want, tol)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = {"shape": [b, sq, sk, hq, hkv, d], "causal": causal,
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
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
    return row


def phase_kernels(dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config("qwen3_0_6b")
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = BATCH * SEQ
    # the main path's four RMSNorm calls per block forward: ln1, q-norm,
    # k-norm, ln2
    path_norms = [(tokens, cfg.d_model), (tokens * nq, hd),
                  (tokens * nkv, hd), (tokens, cfg.d_model)]
    norms = {}
    for n, d in sorted(set(path_norms)):
        norms[(n, d)] = rmsnorm_case(dev, n, d, bf16, 2e-2, flush, gen)
        print("rmsnorm  ", json.dumps(norms[(n, d)]), flush=True)
    for n, d in [(tokens, cfg.d_model), (tokens * nq, hd)]:
        print("rmsnorm  ", json.dumps(
            rmsnorm_case(dev, n, d, f32, 1e-5, flush, gen)), flush=True)

    path_flash = flash_case(dev, BATCH, SEQ, SEQ, nq, nkv, hd, True, bf16,
                            2e-2, flush, gen)
    print("flash    ", json.dumps(path_flash), flush=True)
    for case in [(1, 512, 512, 8, 1, 128, True),      # MQA
                 (2, 1000, 1000, 4, 2, 128, True),    # ragged S=1000
                 (2, 512, 512, 4, 2, 64, False)]:     # non-causal
        print("flash    ", json.dumps(
            flash_case(dev, *case, f32, 2e-5, flush, gen)), flush=True)

    def total(key):
        return sum(norms[nd][key] for nd in path_norms)

    rms_entry = {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:23",
        "max_abs_err": max(norms[nd]["max_abs_err"] for nd in path_norms),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": "bytes",
        "library_ms": total("library_ms"),
        "per_block_forward": [list(nd) for nd in path_norms]}
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        **{k: path_flash[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}}
    return {"flash_attention": flash_entry, "rmsnorm": rms_entry}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def phase_main_path(dev, scratch: Path) -> dict:
    cfg = get_config("qwen3_0_6b")
    gen = torch.Generator().manual_seed(SEED)
    block = DenseBlock(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    # the residual stream entering the first block of a model whose
    # embeddings are drawn like its other weights, N(0, INIT_STD)
    x = (torch.randn(BATCH, SEQ, cfg.d_model, generator=gen)
         * INIT_STD).to(dev, torch.bfloat16)
    with torch.no_grad():
        reference = block(x)
    print(f"block output: max |y| {reference.float().abs().max().item():.4f}",
          flush=True)

    ga = GAConfig(population=8, generations=4, seed=SEED,
                  cache_dir=str(scratch))
    config = OffloadConfig(device=str(dev), ga=ga, repeats=3,
                           options={"example_args": (x,)},
                           log=lambda s: print("  plan:", s, flush=True))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = Offloader(config).plan(block)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    print("main path launches:", json.dumps(launches), flush=True)
    check(launches["flash_attention"] > 0,
          "the flash-attention kernel was never launched by the search")
    check(launches["rmsnorm"] > 0,
          "the rmsnorm kernel was never launched by the search")

    check(res.verification["verified"], "the winning plan did not verify")
    out = res.artifact(x)
    torch.cuda.synchronize()
    v = verify(reference, out, rtol=1e-2, atol=1e-2)
    check(out.device.type == "cuda" and v.ok,
          f"the plan's artifact differs from the block: {v}")

    engine = res.details["engine"]
    matched = {s.region: res.graph.by_name(s.region).meta.get("pattern")
               for s in res.coding.sites}
    forced_bits = tuple(2 if matched[s.region] else 0
                        for s in res.coding.sites)
    forced = engine.substitute(res.coding.decode(forced_bits))
    chosen = [(c.pattern, c.chosen) for c in forced.report.choices
              if c.pattern]
    check(sorted(chosen) == [("rmsnorm", "cuda")] * 4
          + [("softmax_attention", "cuda")],
          f"forced all-kernel plan did not bind the kernels: {chosen}")
    forced_out = forced(x)
    torch.cuda.synchronize()
    fv = verify(reference, forced_out, rtol=1e-2, atol=1e-2)
    check(fv.ok, f"forced all-kernel plan differs from the block: {fv}")

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
          f"chromosomes selecting a kernel failed: {kernel_errors}")
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
        "launches": launches}
    print("main path:", json.dumps(summary), flush=True)
    unsubstituted = engine.substitute({})
    for label, fn in (("baseline (all ref)", unsubstituted),
                      ("plan winner", res.artifact), ("all kernels", forced)):
        print(f"where the time goes, {label}:",
              json.dumps(where_time_goes(fn, x)), flush=True)
    return launches


def where_time_goes(fn, x, iters: int = 10) -> dict:
    """One forward of ``fn``: host wall time (synchronized, no profiler)
    beside the time ``torch.profiler`` records for the device's own
    activities (kernels, copies, memsets; CPU-side operator rows would count
    their kernels twice), the device's idle share, and the kernels that take
    the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(x)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / iters / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms or None,
            "device_idle_share": 1 - device_ms / wall_ms if device_ms else None,
            "device_launches": sum(e.count for e in events) // iters,
            "top_kernels_ms": [[e.key[:60], e.self_device_time_total / iters / 1e3]
                               for e in top]}


def _journal_fingerprint(scratch: Path) -> str:
    journals = sorted(scratch.glob("measurements_*.jsonl"))
    check(len(journals) == 1, f"expected one measurement journal, got "
                              f"{[p.name for p in journals]}")
    return journals[0].stem[len("measurements_"):]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    kernels = phase_kernels(dev)
    scratch = Path(tempfile.mkdtemp(prefix="plan-", dir=build.BUILD_DIR))
    try:
        launches = phase_main_path(dev, scratch)
    finally:
        shutil.rmtree(scratch)
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
