"""An exported program's input guards run one call at a time.

``torch.export`` puts the input guards of ``ep.module()`` in a ``_guards_fn``
submodule that every substitution of the program shares; torch 2.11 runs it
inside one ``torch._dynamo.config`` patch that is not safe to enter from two
threads at once, and the planner's overlapped prepares and a served
endpoint's clients call the program from several threads.  The export
frontend wraps the guards so that their calls are serialised."""
from __future__ import annotations

import threading
import time

import pytest
import torch

from repro_torch.core.frontends.export_frontend import (_SerialGuards,
                                                        build_graph)
from repro_torch.core.substitution import SubstitutionEngine

THREADS, CALLS = 4, 12


class _Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(8, 8, generator=gen))

    def forward(self, x):
        return torch.tanh(x @ self.w).sum(-1)


class _Probe(torch.nn.Module):
    """Guards that record how many calls are inside them at once."""

    def __init__(self, guards: torch.nn.Module):
        super().__init__()
        self.guards = guards
        self.lock = threading.Lock()
        self.active = self.most = self.calls = 0

    def forward(self, *args):
        with self.lock:
            self.active += 1
            self.calls += 1
            self.most = max(self.most, self.active)
        time.sleep(0.002)
        try:
            return self.guards(*args)
        finally:
            with self.lock:
                self.active -= 1


@pytest.fixture()
def program():
    block = _Block()
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    graph = build_graph(block, x)
    gm = graph.meta["graph_module"]
    if not hasattr(gm, "_guards_fn"):
        pytest.skip("this torch exports no guards module")
    return block, x, graph, gm


def _hammer(fn, x) -> list:
    outs, errors = [], []
    barrier = threading.Barrier(THREADS)

    def run():
        try:
            barrier.wait(timeout=30)
            for _ in range(CALLS):
                outs.append(fn(x))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(outs) == THREADS * CALLS
    return outs


@pytest.mark.parametrize("form", ["exported", "substituted"])
def test_guards_run_one_call_at_a_time(program, form):
    block, x, graph, gm = program
    assert isinstance(gm._guards_fn, _SerialGuards)
    probe = _Probe(gm._guards_fn.guards)
    gm._guards_fn.guards = probe
    if form == "exported":
        fn = gm
    else:
        engine = SubstitutionEngine(gm, (x,), graph)
        sub = engine.substitute({})
        # a substitution shares the program's (serialised) guards
        assert sub.gm._guards_fn is gm._guards_fn
        fn = sub
    with torch.no_grad():
        want = block(x)
        outs = _hammer(fn, x)
    assert probe.calls == THREADS * CALLS
    assert probe.most == 1
    for out in outs:
        torch.testing.assert_close(out, want, rtol=0, atol=0)
