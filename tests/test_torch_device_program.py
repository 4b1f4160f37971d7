"""Captured programs (``repro_torch.core.device_program``, the port's
``jax.jit``) on the CPU, where every captured call is the plain call:
``DeviceProgram``, ``CapturedFunction``, ``SubstitutedCallable`` and
``Server`` give the plain call's outputs bit for bit; ``HostSyncGuard``
raises on a host read, a tensor made from host data, a copy between host
and device and a data-shaped op, and the programs the port captures on
the card run under it: the decode step of the five families (reduced
configs), the substituted programs of paths Q, R and W at small widths
(all on the reference ops, and all on the kernels' sites) and every
offloaded loop of the repository's demo programs, whose executor still
matches the reference's jitted loops (the same outputs within 1e-5, the
same ``jit_calls``, transfer counts and excluded loops; the re-upload of
an enclosing loop's index is the port's repair, ROADMAP §3 item 9).

    PYTHONPATH=src python -m pytest tests/test_torch_device_program.py -q

The card's twins (captured equals eager bit for bit, a replay after new
inputs, a capture error that raises) are in ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.core.frontends import ast_frontend as jast  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import device_program as dp  # noqa: E402
from repro_torch.core.frontends import ast_frontend as tast  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.models import OFFLOAD_PLAN, REFERENCE_PLAN, build_model  # noqa: E402
from repro_torch.runtime.serve import Server  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
FAMILIES = ("qwen3_0_6b", "recurrentgemma_2b", "olmoe_1b_7b", "rwkv6_3b",
            "whisper_small")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_ASTSUITE = _load("_torch_ast_suite", ROOT / "tests" / "test_torch_ast_frontend.py")
_BLOCKS = _load("_torch_block_suite", ROOT / "tests" / "test_torch_block_sites.py")


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _family(arch: str, plan=OFFLOAD_PLAN):
    """A reduced model of ``arch`` in f32 on the CPU, a prefilled state of
    two 8-token prompts with room for 4 more, and the next tokens."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g, torch.float32, device="cpu")
    batch = model.demo_batch(g, 2, 8, device="cpu")
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    plan = plan.replace(compute_dtype="float32")
    with torch.no_grad():
        logits, state = model.prefill(params, inputs, plan, cache_capacity=12)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    return model, params, plan, inputs, state, tok


# ---------------------------------------------------------------------------
# on the CPU a captured call is the plain call
# ---------------------------------------------------------------------------


def test_device_program_on_the_cpu_is_the_plain_call():
    def fn(x, y, scale):
        return x * scale + y, {"s": x.sum(0)}

    g = torch.Generator().manual_seed(0)
    args = (torch.randn(3, 4, generator=g), torch.randn(3, 4, generator=g),
            2.0)
    prog = dp.DeviceProgram(fn, args)
    assert not prog.captured and prog.device is None
    assert _equal(prog(*args), fn(*args))
    cf = dp.CapturedFunction(fn, name="f")
    assert _equal(cf(*args), fn(*args)) and cf.programs == {}
    assert dp.capture_enabled()
    with dp.disable_capture():
        assert not dp.capture_enabled()
        assert _equal(cf(*args), fn(*args))
    assert dp.capture_enabled()


def _block_program(label: str):
    """Path ``label``'s program at small widths: Q a reduced Qwen3 block,
    R a reduced RecurrentGemma RG-LRU sublayer, W one WKV-6 head as a
    scan; its engine, example arguments, and the all-reference and
    all-kernel substitutions."""
    from torch._higher_order_ops.scan import scan

    from repro_torch.models.transformer import DenseBlock, RecurrentSublayer

    g = torch.Generator().manual_seed(0)
    if label == "Q":
        cfg = get_config("qwen3_0_6b").reduced()
        target = DenseBlock(cfg, device="cpu", generator=g)
        args = (torch.randn(2, 16, cfg.d_model, generator=g) * 0.1,)
    elif label == "R":
        cfg = get_config("recurrentgemma_2b").reduced()
        target = RecurrentSublayer(cfg, device="cpu", generator=g)
        args = (torch.randn(2, 16, cfg.d_model, generator=g) * 0.1,)
    else:
        def target(r, k, v, lw, u):
            def step(s, rkvw):
                rt, kt, vt, lwt = rkvw
                kv = kt[:, None] * vt[None, :]
                y = rt @ (s + u[:, None] * kv)
                return torch.exp(lwt)[:, None] * s + kv, y
            _, ys = scan(step, torch.zeros(r.shape[-1], v.shape[-1]),
                         (r, k, v, lw))
            return ys
        r, k, v = (torch.randn(24, 64, generator=g) for _ in range(3))
        lw = -torch.exp(torch.randn(24, 64, generator=g) - 0.6)
        args = (r, k, v, lw, torch.randn(64, generator=g) * 0.1)
    ctx = Offloader(OffloadConfig(device="cpu", options={
        "example_args": args})).prepare(target)
    engine = ctx.bundle.context["engine"]

    def each_site(gene):
        return ctx.coding.decode(tuple(
            gene if ctx.graph.by_name(s.region).meta.get("pattern")
            and not ctx.graph.by_name(s.region).meta.get("block_members")
            else 0 for s in ctx.coding.sites))
    return engine, args, (engine.substitute({}),
                          engine.substitute(each_site(2)),
                          engine.substitute(each_site(1)))


@pytest.mark.parametrize("label", ["Q", "R", "W"])
def test_substituted_programs_are_their_graph_modules_and_run_under_the_guard(
        label):
    """On the CPU ``SubstitutedCallable`` runs its graph module (bit for
    bit), and the all-reference, all-kernel and all-``fused_torch``
    programs of Q, R and W run under the guard: nothing in them reads the
    device on the host."""
    _, args, subs = _block_program(label)
    assert any(c.chosen == "cuda" for c in subs[1].report.choices)
    assert any(c.chosen == "fused_torch" for c in subs[2].report.choices)
    for sub in subs:
        with torch.no_grad():
            want = sub.gm(*args)
        assert _equal(sub(*args), want)
        assert sub.captured.programs == {}
        with torch.no_grad(), dp.HostSyncGuard():
            guarded = sub.gm(*args)
        assert _equal(guarded, want)


@pytest.mark.parametrize("variant", ["block_chunked", "block_fused",
                                     "block_scatter"])
def test_block_variants_run_under_the_guard(variant):
    """The function-block variants (the attention stack's chunked and
    fused forms, the MoE dispatch's scatter) run under the guard."""
    model, args = (_BLOCKS._moe_case() if variant == "block_scatter"
                   else _BLOCKS._stack_case())
    engine, _, (fb,) = _BLOCKS._engine(model, args)
    sub = engine.substitute({fb.name: variant})
    assert sub.report.substituted == {fb.name: variant}
    with torch.no_grad():
        want = sub(*args)
        with dp.HostSyncGuard():
            got = sub.gm(*args)
    assert _equal(got, want)


def test_server_on_the_cpu_is_the_plain_prefill_and_decode():
    model, params, plan, inputs, _, _ = _family("qwen3_0_6b", REFERENCE_PLAN)
    got = Server(model, params, plan).generate(inputs, 4)
    with torch.no_grad():
        logits, state = model.prefill(params, inputs, plan,
                                      cache_capacity=8 + 4)
        want = []
        for i in range(4):
            tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(
                torch.int32)
            want.append(tok[:, 0])
            if i < 3:
                logits, state = model.decode(params, tok, state, plan)
    np.testing.assert_array_equal(got, torch.stack(want, 1).numpy())


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


def test_guard_raises_on_what_a_capture_refuses():
    x = torch.arange(6.0).reshape(2, 3)
    i = torch.tensor(1)
    cases = [
        ("host read", lambda: x.sum().item()),
        ("host read", lambda: float(x[0, 0])),
        ("host read", lambda: bool(x.sum() > 0)),
        ("host read", lambda: x[i]),
        ("host read", lambda: torch.full((2,), x.sum())),
        ("host data", lambda: torch.as_tensor(3.0)),
        ("host data", lambda: torch.tensor([1.0, 2.0])),
        ("host and device", lambda: x.cpu()),
        ("data-dependent", lambda: torch.nonzero(x)),
        ("data-dependent", lambda: x[x > 2]),
    ]
    for what, fn in cases:
        with pytest.raises(RuntimeError, match=what), dp.HostSyncGuard():
            fn()
    with dp.HostSyncGuard():               # device-only work passes
        y = torch.full((2,), 3.0) + x.sum(0)[:2] * torch.arange(2)
        z = x.index_select(0, i.reshape(1)).squeeze(0)
    assert torch.equal(y, torch.tensor([3.0, 8.0]))
    assert torch.equal(z, x[1])


def test_the_rewrite_selects_by_a_device_index_on_the_device():
    """``tnp.getitem`` / ``setitem`` take a 0-d integer tensor (an enclosing
    loop's index) with ``index_select`` / ``index_copy_``: under the
    guard, with PyTorch's results for the index's value, a negative one
    included."""
    ns = tast.TorchNumpy(torch.device("cpu"))
    a = torch.arange(24.0).reshape(2, 3, 4)
    for j in (1, -1):
        t = torch.tensor(j, dtype=torch.int32)
        for ix in ((t,), (0, t), (slice(None), t, 2), (1, slice(0, 2), t),
                   (t, slice(None), t)):
            want = a[tuple(j if e is t else e for e in ix)]
            with dp.HostSyncGuard():
                got = ns.getitem(a, ix)
            assert torch.equal(got, want), ix
            b, c = a.clone(), a.clone()
            c[tuple(j if e is t else e for e in ix)] = -5.0
            with dp.HostSyncGuard():
                ns.setitem(b, ix, -5.0)
            assert torch.equal(b, c), ix
    with dp.HostSyncGuard():                # a fill, not a host copy
        s = ns.asarray(2.5)
    assert s.dtype == torch.float32 and s.shape == ()


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_runs_under_the_guard_and_writes_its_state_back(arch):
    """The decode step of each family runs under the guard, and the
    captured form's body (the new RG-LRU / RWKV states and ``cache_len``
    copied back into the state's buffers) gives the plain step's logits
    and state, bit for bit."""
    model, params, plan, inputs, state, tok = _family(arch)
    server = Server(model, params, plan)
    bound = server._bound
    with torch.no_grad():
        fresh = pytree.tree_map(lambda t: t.clone(), state)
        want_logits, want_state = model.decode(bound.params, tok, fresh, plan)
        again = pytree.tree_map(lambda t: t.clone(), state)
        with dp.HostSyncGuard():
            logits, out = bound._decode_in_place(tok, again)
    assert out is again
    assert torch.equal(logits, want_logits)
    want = dict(pytree.tree_flatten_with_path(want_state)[0])
    got = dict(pytree.tree_flatten_with_path(out)[0])
    assert set(want) <= set(got)
    for path, leaf in want.items():
        assert torch.equal(got[path], leaf), pytree.keystr(path)


# ---------------------------------------------------------------------------
# the offloaded loops: under the guard, against the reference's jitted ones
# ---------------------------------------------------------------------------


class _GuardedLoop(dp.CapturedFunction):
    """An offloaded loop whose every call runs under the guard."""

    def __call__(self, *args):
        with dp.HostSyncGuard():
            return super().__call__(*args)


@pytest.mark.parametrize("name", sorted(_ASTSUITE.PROGRAMS))
def test_offloaded_loops_run_under_the_guard_and_match_the_reference(
        name, monkeypatch):
    """Every single-loop offload pattern (and none) of the demo programs,
    hoisting on: each offloaded loop runs under the guard; the outputs
    are within 1e-5 of the reference's, the ``ExecStats`` (``jit_calls``,
    transfers and their bytes) and the excluded loops the reference's,
    but where the reference reads a stale hoisted index (there the port
    re-uploads it and gives the interpreted program's outputs)."""
    monkeypatch.setattr(tast, "CapturedFunction", _GuardedLoop)
    jp, _, ok, inputs = _ASTSUITE._checked(name)
    src, consts, _ = _ASTSUITE.PROGRAMS[name]
    tp = tast.PyProgram(src, consts=consts)
    assert tp.check_offloadable(inputs, device="cpu") == ok
    assert {r.name for r in tp.graph.loops() if "offload_error" in r.meta} \
        == {r.name for r in jp.graph.loops() if "offload_error" in r.meta}
    names = jp.output_names
    interp = jast.Executor(jp, {}).outputs(
        jast.Executor(jp, {}).run(**inputs), names)
    tol = _ASTSUITE.F32_TOL
    matched = 0
    for impl in _ASTSUITE._patterns(ok):
        tex = tast.Executor(tp, impl, device="cpu")
        got = tex.outputs(tex.run(**inputs), names)
        assert all(isinstance(f, _GuardedLoop)
                   for f in tp._compiled_cache.values())
        for n in names:
            np.testing.assert_allclose(got[n], interp[n], rtol=tol, atol=tol,
                                       err_msg=f"{impl} {n}")
        jex = jast.Executor(jp, impl)
        try:
            want = jex.outputs(jex.run(**inputs), names)
        except ValueError as e:          # the reference's read-only copy
            assert "read-only" in str(e)
            continue
        if _ASTSUITE._reads_enclosing_target(tp, impl):
            assert tex.stats.jit_calls == jex.stats.jit_calls, impl
            continue
        assert dataclasses.asdict(tex.stats) == \
            dataclasses.asdict(jex.stats), impl
        for n in names:
            np.testing.assert_allclose(got[n], want[n], rtol=tol, atol=tol,
                                       err_msg=f"{impl} {n}")
        matched += 1
    assert matched >= 1
