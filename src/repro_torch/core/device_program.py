"""The port's counterpart of ``jax.jit`` for the programs it serves and
times: capture once as a CUDA graph on the card, then replay.

No module of the reference is its twin.  It stands where the reference
compiles:

  * ``repro/core/substitution.py:61`` ``SubstitutedCallable.__call__``
    (each chromosome's substituted program, which the GA times and the
    planner serves);
  * ``repro/core/frontends/jaxpr_frontend.py:398`` (the measured plan's
    runner);
  * ``repro/core/frontends/ast_frontend.py:399`` (an offloaded Python
    loop);
  * ``repro/runtime/serve.py:51`` and ``:59`` (the decode step, its state
    donated, and prefill once per cache capacity).

A replay runs the kernels the eager call runs, with the same arguments,
so its outputs are the eager call's; what goes is the host's dispatch of
each op.  Where the reference's compiled function is cached (per
program, per loop, per cache capacity), :class:`CapturedFunction` keeps
one :class:`DeviceProgram` per call signature (the shapes, dtypes and
devices of the tensor leaves, the values of the others), as ``jax.jit``
retraces per abstract signature.  On the CPU a call is the plain call,
as every port entry point is when the caller asks for ``device="cpu"``;
so is a call inside :func:`disable_capture` (``jax.disable_jit``).

Capture (:class:`DeviceProgram`):

  * the inputs' tensor leaves are copied into static buffers (a donated
    argument's leaves are taken as they are, as ``donate_argnums`` gives
    the reference's decode step its state);
  * the first call runs eagerly on a side stream, on the caller's own
    arguments (a donated argument's values move once), and its outputs are
    that call's result (``first_output``), as the reference's first call
    returns what it compiled and ran.  It is the warm-up: it also builds
    the CUDA kernels on first use (:mod:`repro_torch.kernels.build`), so
    no build is captured, and the wrappers count its launches as they
    count any eager launch;
  * the capture runs on that side stream (a pooled graph's on its pool's
    stream) with ``capture_error_mode="thread_local"``, under
    :data:`CAPTURE_LOCK`:
    another thread's eager work and syncs on its own stream go on, and
    no two captures overlap.  ``CUDAGraph.capture_begin`` is called
    directly: ``torch.cuda.graph``'s ``__enter__`` synchronizes the whole
    device and empties the allocator's cache, which a capture on another
    thread (a prepare on the planner's pool) does not survive;
  * a capture that fails raises.  Nothing falls back to the eager call on
    a CUDA tensor.

Each later call copies its tensor inputs into the static buffers (a donated
leaf passed back as the buffer it is skips the copy), replays, and
returns clones of the outputs, so a later replay never overwrites a value
the caller holds; an output that is a donated input's buffer is returned
as that buffer.  Each graph has its own memory pool, freed with its
owner, but for the graphs of one search (:class:`GraphPool`), whose
replays take turns.  Before a capture the allocator's cache is emptied
(as ``torch.cuda.graph`` does), so the graph's pool can take what the
eager first call left cached.

The kernel wrappers' launch counts (:mod:`repro_torch.kernels.ops`) see
the launches a replay makes: a capture records its wrappers' counts
instead of adding them, and each replay adds them
(:func:`repro_torch.kernels.ops.recording_launches`).

:class:`HostSyncGuard` is a ``TorchFunctionMode`` that raises on what a
capture refuses or would freeze: a tensor's value read into Python, a
tensor made from host data, a copy between the host and the device, and
an op whose output shape depends on the data.  The tests run the decode
steps, the substituted programs and the offloaded loops under it on the
CPU.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Iterable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

__all__ = ["CAPTURE_LOCK", "CapturedFunction", "DeviceProgram",
           "GraphPool", "HostSyncGuard", "capture_enabled",
           "disable_capture", "synchronize"]

#: held by every capture, by :func:`synchronize` and by a fitness's timing
#: loop: no capture overlaps another, a device-wide sync or a timed run
CAPTURE_LOCK = threading.RLock()
_local = threading.local()


@contextlib.contextmanager
def disable_capture():
    """Within the block, on this thread, every :class:`CapturedFunction`
    runs its plain call (``jax.disable_jit``)."""
    prev = getattr(_local, "disabled", False)
    _local.disabled = True
    try:
        yield
    finally:
        _local.disabled = prev


def capture_enabled() -> bool:
    return not getattr(_local, "disabled", False)


def synchronize(device: Any = None) -> None:
    """``torch.cuda.synchronize(device)`` outside any capture: a sync of
    the whole device while a stream captures fails the capture."""
    with CAPTURE_LOCK:
        torch.cuda.synchronize(device)


class _Turn:
    """Replays that take turns: ``lock`` while one enqueues, ``done`` the
    event its work ends with, which the next waits for on its stream."""

    def __init__(self):
        self.lock = threading.Lock()
        self.done: Optional[torch.cuda.Event] = None


class GraphPool(_Turn):
    """One memory pool for graphs that never read each other's outputs
    and whose replays take turns (``lock``): the chromosomes of one
    search, which the GA prepares on several threads and times one by one.
    A graph's intermediates are rewritten by each of its replays before
    they are read, and its outputs are cloned inside the turn, so graphs
    may share the blocks each frees; the pool then holds about one
    program's peak however many prepared chromosomes wait for their
    timing."""

    def __init__(self):
        super().__init__()
        self._handle = None
        self._stream = None
        self._keeper = None

    def handle(self, device: torch.device):
        """The pool's id.  A one-op graph captured into it first lives as
        long as the pool does: the allocator frees a pool whose graphs are
        all gone and then refuses its id, and a search's programs go
        between one batch and the next."""
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
            keeper = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self.stream(device)):
                keeper.capture_begin(pool=self._handle,
                                     capture_error_mode="thread_local")
                torch.zeros(1, device=device)
                keeper.capture_end()
            self._keeper = keeper
        return self._handle

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        """The stream every capture into the pool runs on: the allocator
        hands a capture only blocks freed on its own stream."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream


def _cuda_device(leaves: Iterable) -> Optional[torch.device]:
    """The one CUDA device of the tensor leaves; None when there is none;
    raises when there are several or a tensor lies elsewhere too."""
    devs = {l.device for l in leaves if isinstance(l, torch.Tensor)}
    cuda = {d for d in devs if d.type == "cuda"}
    if not cuda:
        return None
    if len(devs) > 1:
        raise ValueError(f"a captured program takes tensors on one CUDA "
                         f"device, got {sorted(map(str, devs))}")
    return cuda.pop()


def _signature(leaves: list, spec) -> tuple:
    sig = []
    for l in leaves:
        if isinstance(l, torch.Tensor):
            sig.append(("T", tuple(l.shape), l.dtype, l.device))
            continue
        try:
            hash(l)
        except TypeError:           # an unhashable constant: by identity
            l = id(l)
        sig.append(("V", type(l), l))
    return spec, tuple(sig)


def _donated_mask(args: tuple, donate: tuple) -> list:
    mask = []
    for i, a in enumerate(args):
        mask.extend([i in donate] * len(pytree.tree_leaves(a)))
    return mask


class DeviceProgram:
    """``fn`` captured once as a CUDA graph for ``example_args``' signature
    and replayed on each call.  Building it calls ``fn(*example_args)``
    once eagerly on a side stream (``first_output``), then captures.
    ``donate`` names the positional arguments
    whose tensors the program may update in place: their example leaves
    become the static buffers, and outputs that are those buffers come
    back as they are.  The graph has a memory pool of its own, freed with
    the program, unless ``pool`` (a :class:`GraphPool`) is given.  On the
    CPU (no CUDA tensor among the leaves) a call is ``fn(*args)``.
    """

    def __init__(self, fn: Callable, example_args: tuple, *,
                 donate: tuple = (), pool: Optional[GraphPool] = None,
                 name: str = "program"):
        from repro_torch.kernels import ops

        self.fn = fn
        self.name = name
        self.donate = tuple(donate)
        leaves, self._in_spec = pytree.tree_flatten(tuple(example_args))
        self.signature = _signature(leaves, self._in_spec)
        self.device = _cuda_device(leaves)
        self.replays = 0
        self.warmup_s = self.capture_s = 0.0
        self.graph = None
        self.first_output = None
        if self.device is None:
            return
        donated = _donated_mask(tuple(example_args), self.donate)
        self._static = [l if (d or not isinstance(l, torch.Tensor))
                        else torch.empty_like(l).copy_(l)
                        for l, d in zip(leaves, donated)]
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = fn(*example_args)
        side.synchronize()
        cur.wait_stream(side)
        for t in pytree.tree_leaves(first):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(cur)
        self.first_output = first
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        on = side if pool is None else pool.stream(dev)
        with CAPTURE_LOCK, torch.cuda.stream(on), \
                ops.recording_launches() as launched:
            # what the eager call left cached goes back to the device: a
            # graph allocates from its own pool, not from the cache
            torch.cuda.empty_cache()
            graph.capture_begin(
                pool=None if pool is None else pool.handle(dev),
                capture_error_mode="thread_local")
            try:
                out = fn(*pytree.tree_unflatten(self._static, self._in_spec))
            except BaseException as e:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                # a capture_end that fails leaves the allocator routing
                # this stream's allocations to the graph's pool
                end = getattr(torch._C, "_cuda_endAllocateToPool", None)
                if end is not None:
                    with contextlib.suppress(Exception):
                        end(dev.index, graph.pool())
                raise RuntimeError(f"{name}: the capture failed: "
                                   f"{type(e).__name__}: {e}") from e
            graph.capture_end()
        self.graph = graph
        self._launched = tuple(launched)
        self._out, self._out_spec = pytree.tree_flatten(out)
        ids = {id(l): i for i, l in enumerate(self._static)
               if donated[i] and isinstance(l, torch.Tensor)}
        self._out_alias = [ids.get(id(o)) for o in self._out]
        self._turn = _Turn() if pool is None else pool
        self.warmup_s = warm_s
        self.capture_s = time.perf_counter() - t0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, *args):
        if self.graph is None:
            return self.fn(*args)
        leaves, spec = pytree.tree_flatten(args)
        if _signature(leaves, spec) != self.signature:
            raise ValueError(f"{self.name}: called with another signature "
                             f"than the one it was captured for")
        return self._replay(leaves)

    def _replay(self, leaves: list):
        """Copy ``leaves`` (of this program's signature) in, replay, and
        return the outputs."""
        from repro_torch.kernels import ops

        turn = self._turn
        with turn.lock:
            stream = torch.cuda.current_stream(self.device)
            if turn.done is not None:
                stream.wait_event(turn.done)
            for x, s in zip(leaves, self._static):
                if isinstance(s, torch.Tensor) and x is not s:
                    s.copy_(x)
            self.graph.replay()
            outs = [o.clone() if isinstance(o, torch.Tensor) and a is None
                    else (self._static[a] if a is not None else o)
                    for o, a in zip(self._out, self._out_alias)]
            turn.done = torch.cuda.Event()
            turn.done.record(stream)
            self.replays += 1
        ops.replay_launches(self._launched)
        return pytree.tree_unflatten(outs, self._out_spec)


class CapturedFunction:
    """``jax.jit`` for the port: ``fn`` captured per call signature
    (:class:`DeviceProgram`), replayed after; the plain call on the CPU
    and inside :func:`disable_capture`.  ``programs`` maps each signature
    to its program; ``pool``, a :class:`GraphPool` the next captures
    share (None: each its own)."""

    def __init__(self, fn: Callable, *, donate: tuple = (),
                 name: Optional[str] = None):
        self.fn = fn
        self.donate = tuple(donate)
        self.name = name or getattr(fn, "__name__", "program")
        self.pool: Optional[GraphPool] = None
        self.programs: dict = {}
        self._lock = threading.Lock()

    def __call__(self, *args):
        if not capture_enabled():
            return self.fn(*args)
        leaves, spec = pytree.tree_flatten(args)
        if _cuda_device(leaves) is None:
            return self.fn(*args)
        key = _signature(leaves, spec)
        prog = self.programs.get(key)
        if prog is None:
            with self._lock:
                prog = self.programs.get(key)
                if prog is None:
                    prog = DeviceProgram(self.fn, args, donate=self.donate,
                                         pool=self.pool, name=self.name)
                    self.programs[key] = prog
                    first, prog.first_output = prog.first_output, None
                    return first
        return prog._replay(leaves)



# ---------------------------------------------------------------------------
# the guard: what a capture refuses, raised on any device
# ---------------------------------------------------------------------------


def _is_index_read(ix) -> bool:
    """A 0-d integer tensor as an index: PyTorch reads its value on the
    host (``item``) to select."""
    return (isinstance(ix, torch.Tensor) and ix.ndim == 0
            and not ix.is_floating_point() and not ix.is_complex()
            and ix.dtype != torch.bool)


class HostSyncGuard(TorchFunctionMode):
    """Raise inside a region on what would sync with the host or freeze a
    host value into a captured program: a tensor's value read into Python
    (``bool()``/``float()``/``int()``/``__index__``, ``item``, ``tolist``,
    ``numpy``, a 0-d integer tensor as an index, a tensor as a factory's
    size or fill value), a tensor made from host data (``torch.tensor``,
    ``as_tensor``, ``asarray``, ``new_tensor``), a copy to another
    device (``cpu``, ``cuda``, ``to`` or ``copy_`` across devices), and an
    op whose output shape depends on the data (``nonzero``, a boolean
    mask).  Modelled on the ast frontend's ``_NoConcretization``; it runs
    on the CPU, where the tests hold the port's programs to it."""

    _READS = {torch.Tensor.__bool__, torch.Tensor.__float__,
              torch.Tensor.__int__, torch.Tensor.__index__,
              torch.Tensor.__complex__, torch.Tensor.item,
              torch.Tensor.tolist, torch.Tensor.numpy,
              torch.Tensor.__array__}
    _FROM_HOST = {torch.tensor, torch.as_tensor, torch.asarray,
                  torch.Tensor.new_tensor}
    _TO_HOST = {torch.Tensor.cpu, torch.Tensor.cuda}
    _FACTORIES = {torch.full, torch.arange, torch.zeros, torch.ones,
                  torch.empty, torch.linspace, torch.randint}
    _NEW = {torch.Tensor.new_full, torch.Tensor.new_zeros,
            torch.Tensor.new_ones, torch.Tensor.new_empty}
    _DATA_SHAPED = {torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
                    torch.Tensor.masked_select, torch.unique,
                    torch.Tensor.unique, torch.argwhere,
                    torch.unique_consecutive, torch.Tensor.unique_consecutive}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if func in self._READS:
            raise RuntimeError(f"host read of a device value ({name})")
        if func in self._FROM_HOST:
            raise RuntimeError(f"tensor made from host data ({name})")
        if func in self._TO_HOST:
            raise RuntimeError(f"copy between host and device ({name})")
        if func in self._DATA_SHAPED:
            raise RuntimeError(f"data-dependent output shape ({name})")
        if func in self._FACTORIES or func in self._NEW:
            sizes = (args[1:] if func in self._NEW else args, kwargs)
            if any(isinstance(a, torch.Tensor)
                   for a in pytree.tree_leaves(sizes)):
                raise RuntimeError(f"host read of a device value (a tensor "
                                   f"as {name}'s size or fill)")
        if func is torch.Tensor.to or func is torch.Tensor.copy_:
            self._check_copy(func, args, kwargs)
        if func is torch.Tensor.__getitem__ or \
                func is torch.Tensor.__setitem__:
            index = args[1] if len(args) > 1 else ()
            for ix in (index if isinstance(index, tuple) else (index,)):
                if isinstance(ix, torch.Tensor) and ix.dtype == torch.bool:
                    raise RuntimeError("data-dependent output shape "
                                       "(boolean mask index)")
                if _is_index_read(ix):
                    raise RuntimeError("host read of a device value (a 0-d "
                                       "integer tensor as an index)")
        return func(*args, **kwargs)

    @staticmethod
    def _check_copy(func, args, kwargs) -> None:
        src = args[0]
        if func is torch.Tensor.copy_:
            other = args[1] if len(args) > 1 else kwargs.get("src")
            if isinstance(other, torch.Tensor) and other.device != src.device:
                raise RuntimeError(f"copy between host and device "
                                   f"({other.device} -> {src.device})")
            return
        target = kwargs.get("device")
        for a in args[1:]:
            if isinstance(a, (str, torch.device)):
                target = a
            elif isinstance(a, torch.Tensor):
                target = a.device
        if target is not None and torch.device(target) != src.device \
                and not (torch.device(target).type == src.device.type
                         and torch.device(target).index is None):
            raise RuntimeError(f"copy between host and device "
                               f"({src.device} -> {target})")
