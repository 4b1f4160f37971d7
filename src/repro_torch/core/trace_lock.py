"""One process-wide lock around PyTorch's program tracers (port only: the
reference's ``jax.make_jaxpr`` is thread-safe).

``torch.export.export`` and ``make_fx`` keep tracer state in module
globals, so two threads tracing at once fail: six threads each running
``torch.export.export`` fail with ``ProxyTorchDispatchMode slot already
occupied``, and six running ``make_fx`` with ``CURRENT_PATCHER is None in
finally block`` (torch 2.13).  Eager calls on other threads are not
affected.  The planning service runs ``Offloader.prepare`` on each
client's thread and its searches on pool threads, and both trace (the
export frontend, the pattern DB's vectors, and a ``scan``'s body or
joint graph, which ``make_fx`` traces for autograd and the cost
analyzer).  So every such trace in the port is taken under
:data:`TRACE_LOCK`, and any threaded caller is safe; a single-threaded
run takes it uncontended.  It is reentrant: a trace may call code that
traces.
"""
from __future__ import annotations

import threading

__all__ = ["TRACE_LOCK"]

TRACE_LOCK = threading.RLock()
