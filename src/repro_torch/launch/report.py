"""Port of ``repro/launch/report.py``: the dry-run table from the port's
records (``repro_torch.launch.dryrun``), one H100's 80 GB in the HBM
column where the reference has a TPU v5e chip's 16 GB.

  PYTHONPATH=src python -m repro_torch.launch.report [--plan production] [--mesh h100x1]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT, MESH


def load(out_dir=str(DEFAULT_OUT), plan="production"):
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir, f"*__{plan}.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_ms(s):
    return f"{s*1e3:.1f}"


def render(recs, mesh=MESH):
    rows = []
    hdr = ("| arch | shape | fits80G | compute ms | memory ms | coll ms | "
           "dominant | step ms | useful | roofline |")
    sep = "|" + "---|" * 10
    rows.append(hdr)
    rows.append(sep)
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted([r for r in recs if r["mesh"] == mesh],
                    key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | skip | — | — | — |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | ERR | | | | | | | |")
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{'Y' if r['memory']['fits_80gb'] else 'N'} | "
            f"{fmt_ms(ro['compute_s'])} | {fmt_ms(ro['memory_s'])} | "
            f"{fmt_ms(ro['collective_s'])} | {ro['dominant']} | "
            f"{fmt_ms(ro['step_s'])} | {ro['useful_flops_ratio']:.2f} | "
            f"{ro['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def summary(recs):
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skip"]
    err = [r for r in recs if r["status"] == "error"]
    by_dom = {}
    for r in ok:
        by_dom[r["roofline"]["dominant"]] = by_dom.get(r["roofline"]["dominant"], 0) + 1
    fit = sum(1 for r in ok if r["memory"]["fits_80gb"])
    return (f"cells ok={len(ok)} skip={len(skip)} err={len(err)}; "
            f"fits 80GB: {fit}/{len(ok)}; dominant: {by_dom}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", default="production")
    ap.add_argument("--mesh", default=MESH)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()
    recs = load(args.out, args.plan)
    print(summary(recs))
    print()
    print(render(recs, args.mesh))


if __name__ == "__main__":
    main()
