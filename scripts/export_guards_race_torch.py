"""Call an exported program from several threads at once and count the
errors: ``torch.export``'s own ``ep.module()`` against the export frontend's
program, whose input guards run one call at a time.

    PYTHONPATH=src python scripts/export_guards_race_torch.py [--calls N]

torch 2.11 runs an exported program's guards inside one
``torch._dynamo.config`` patch that keeps its saved settings on the patch,
not on the thread, so a thread that enters it while another is inside fails
(``prior should be empty when entering ConfigPatch``).  The script shortens
the interpreter's thread switch interval so that the threads meet inside
the guards often; a torch whose patch is per-thread counts no error on
either program.  It prints one JSON line: the torch version and, for each
program, its guards module's type and its errors by message.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import threading

import torch

from repro_torch.core.frontends.export_frontend import build_graph

THREADS = 4


class _Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(8, 8, generator=gen))

    def forward(self, x):
        return torch.tanh(x @ self.w).sum(-1)


def hammer(fn, x, calls: int) -> dict:
    """``calls`` calls of ``fn(x)`` on each of ``THREADS`` threads: the
    errors by type and message."""
    errors: collections.Counter = collections.Counter()
    lock = threading.Lock()

    def run():
        for _ in range(calls):
            try:
                fn(x)
            except Exception as e:  # noqa: BLE001 — counted, not raised
                with lock:
                    errors[f"{type(e).__name__}: {str(e)[:80]}"] += 1

    threads = [threading.Thread(target=run) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(errors)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3000,
                    help="calls on each thread (default 3000)")
    args = ap.parse_args(argv)
    sys.setswitchinterval(1e-6)
    block = _Block()
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    out = {"torch": torch.__version__, "threads": THREADS,
           "calls_a_thread": args.calls}
    with torch.no_grad():
        for name, gm in (
                ("ep.module()", torch.export.export(block, (x,)).module()),
                ("export frontend", build_graph(block, x)
                 .meta["graph_module"])):
            out[name] = {
                "guards": type(getattr(gm, "_guards_fn", None)).__name__,
                "errors": hammer(gm, x, args.calls)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
