"""Port of ``repro/launch/obsreport.py`` (its output byte for byte).

Trace/metrics report: render a ``OffloadConfig.trace`` JSONL for humans.

  PYTHONPATH=src python -m repro_torch.launch.obsreport plan_trace.jsonl

Prints an indented span-tree timeline — one line per span with its offset
from the root, duration, share of the root's wall time and key attributes —
a coverage line per root (how much of the root's wall its direct children
account for), and the metrics snapshot the tracer appended on close.
Reads only the JSONL; nothing here touches torch or the planning stack.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Optional

from repro_torch.obs.trace import read_trace

__all__ = ["render", "render_metrics", "main"]

_NAME_COL = 46


def _short(value: Any, limit: int = 24) -> str:
    s = str(value)
    return s if len(s) <= limit else s[:limit - 1] + "…"


def _attr_str(span: dict, max_attrs: int = 4) -> str:
    attrs = span.get("attrs") or {}
    shown = list(attrs.items())[:max_attrs]
    out = " ".join(f"{k}={_short(v)}" for k, v in shown)
    if len(attrs) > max_attrs:
        out += f" (+{len(attrs) - max_attrs})"
    return out


def render(spans: list, metrics: Optional[dict] = None) -> str:
    """The report as one string (the CLI prints it; tests assert on it)."""
    lines: list[str] = []
    by_id = {s["id"]: s for s in spans}
    children: dict[int, list] = {}
    roots: list = []
    for s in spans:
        parent = s.get("parent")
        if parent is not None and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s["t0"])
    roots.sort(key=lambda s: s["t0"])

    trace_ids = sorted({s.get("trace", "?") for s in spans})
    lines.append(f"trace {', '.join(trace_ids) or '-'}  "
                 f"spans={len(spans)} roots={len(roots)}")

    def walk(span: dict, depth: int, root_t0: float, root_dur: float) -> None:
        name = "  " * depth + span["name"]
        offset_ms = (span["t0"] - root_t0) * 1e3
        dur_ms = span["dur_s"] * 1e3
        pct = 100.0 * span["dur_s"] / root_dur if root_dur > 0 else 0.0
        lines.append(f"{name:<{_NAME_COL}} +{offset_ms:9.2f}ms "
                     f"{dur_ms:10.2f}ms {pct:5.1f}%  {_attr_str(span)}")
        for child in children.get(span["id"], ()):
            walk(child, depth + 1, root_t0, root_dur)

    for root in roots:
        lines.append("")
        walk(root, 0, root["t0"], root["dur_s"])
        kids = children.get(root["id"], ())
        if kids and root["dur_s"] > 0:
            covered = sum(c["dur_s"] for c in kids)
            lines.append(
                f"coverage: {len(kids)} direct children "
                f"({', '.join(sorted({c['name'] for c in kids}))}) account "
                f"for {100.0 * covered / root['dur_s']:.1f}% of "
                f"{root['name']} wall")
    if metrics:
        lines.append("")
        lines.append(render_metrics(metrics))
    return "\n".join(lines)


def render_metrics(snapshot: dict) -> str:
    """The metrics snapshot, one line per series."""
    lines = ["metrics:"]
    for name in sorted(snapshot):
        fam = snapshot[name]
        for series in fam.get("series", ()):
            labels = series.get("labels") or {}
            tag = name + ("{" + ",".join(f"{k}={v}" for k, v in
                                         sorted(labels.items())) + "}"
                          if labels else "")
            if fam.get("kind") == "histogram":
                val = (f"count={series.get('count')} "
                       f"sum={series.get('sum', 0.0):.6g} "
                       f"mean={series.get('mean', 0.0):.6g}")
            else:
                val = f"{series.get('value', 0.0):.6g}"
            lines.append(f"  {tag:<52} {fam.get('kind', '?'):<10} {val}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="render an offload trace JSONL as a span-tree timeline")
    ap.add_argument("trace", help="trace file written via OffloadConfig.trace")
    ap.add_argument("--json", action="store_true",
                    help="dump the parsed spans + metrics as JSON instead")
    args = ap.parse_args(argv)
    spans, metrics = read_trace(args.trace)
    try:
        if args.json:
            print(json.dumps({"spans": spans, "metrics": metrics}, indent=1))
        else:
            print(render(spans, metrics))
    except BrokenPipeError:            # | head is a fine way to read a trace
        return 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
