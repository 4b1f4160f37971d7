"""The paper's scenario, end to end and for real (the PyTorch port's twin
of ``examples/python_offload_demo.py``; imports only ``repro_torch``): take
a numeric Python program written for CPU, automatically offload it.

  1. parse with `ast` (paper §3.3.2), extract loops + variables,
  2. function-block pass: pattern DB matches the naive matmul and DFT via
     Deckard-style similarity and replaces them with device libraries,
  3. GA loop pass over the remaining loops, wall-clock fitness with
     PCAST-style result verification,
  4. transfer plan: batched uploads hoisted out of interpreted loops.

Each offloaded loop runs on ``cuda`` unless ``--device cpu`` is asked for.

  PYTHONPATH=src python examples/python_offload_demo_torch.py [--device cpu] [--population 2 --generations 1]
"""
import argparse

import numpy as np

from repro_torch.core.frontends.ast_frontend import PyProgram
from repro_torch.core.ga import GAConfig
from repro_torch.core.offload import OffloadConfig, Offloader

SRC = """
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--population", type=int, default=10)
    ap.add_argument("--generations", type=int, default=5)
    args = ap.parse_args()
    consts = {"n": 24, "m": 24, "k": 24, "iters": 50, "fftn": 64}
    rng = np.random.default_rng(0)
    inputs = dict(a=rng.random((24, 24)), b=rng.random((24, 24)),
                  x=rng.random(24), sig_re=rng.random(64), sig_im=rng.random(64))

    program = PyProgram(SRC, consts=consts)
    print(f"parsed: {len(program.graph.regions)} regions, "
          f"{len(program.graph.loops())} loops")

    cfg = OffloadConfig(
        frontend="python_ast", device=args.device,
        ga=GAConfig(population=args.population,
                    generations=args.generations, seed=0),
        log=lambda s: print("  " + s))
    res = Offloader(cfg).plan(program, inputs)
    # claimed function blocks carry a bound library call; variant-site menus
    # (regions still in the gene) show up in res.pattern instead
    lib_calls = {r for r, e in res.details.get("lib_calls", {}).items()
                 if isinstance(e, dict) and "lib" in e}
    block_time_s = res.details.get("block_time_s", res.baseline.time_s)

    print("\n--- function-block offload (pattern DB) ---")
    for b in res.block.offloads:
        kept = "KEPT" if b.region in lib_calls else "rejected-by-measurement"
        print(f"  {b.region}: {b.pattern} via {b.how} (sim={b.score:.3f}) "
              f"-> {b.replacement} [{kept}]")

    print("\n--- GA loop offload ---")
    for h in res.ga.history:
        print(f"  gen {h['generation']}: best={h['best_time_s']*1e3:.2f}ms "
              f"mean={h['mean_time_s']*1e3:.2f}ms invalid={h['n_invalid']}")

    print("\n--- final pattern ---")
    for region, impl in sorted(res.pattern.items()):
        print(f"  {region}: {impl}")
    print(f"\nbaseline (all interpreted): {res.baseline.time_s*1e3:8.2f} ms")
    print(f"blocks only:                {block_time_s*1e3:8.2f} ms")
    print(f"final plan:                 {res.best.time_s*1e3:8.2f} ms")
    print(f"SPEEDUP: {res.speedup:.1f}x   "
          f"(transfers hoisted: {res.transfer_plan.n_hoisted})")


if __name__ == "__main__":
    main()
