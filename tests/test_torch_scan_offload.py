"""Scan sites in the port on the CPU: the export frontend's ``loop``
regions for torch twins of the reference's ``_recurrence_app`` and
``_wkv_app`` (``tests/test_substitution.py``), the substitution engine's
scan sites and the ``linear_recurrence``/``wkv_recurrence`` variants held
against the unsubstituted program and the JAX apps, the structural
fallbacks, and slice 2's main path: a RecurrentGemma-2B RG-LRU sublayer
(reduced widths) against the JAX reference sublayer and through
``Offloader.plan``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._higher_order_ops.scan import scan  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.models.plan import REFERENCE_PLAN  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core.frontends.export_frontend import (  # noqa: E402
    annotate_variants, build_graph)
from repro_torch.core.ga import Evaluation, GAConfig  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.core.pattern_db import default_db  # noqa: E402
from repro_torch.core.substitution import SubstitutionEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.convert import recurrent_sublayer_from_jax  # noqa: E402
from repro_torch.models.transformer import DenseBlock  # noqa: E402

#: REFERENCE_PLAN's implementation choices in f32 (its bf16 default rounds
#: what a float32 comparison at 1e-4 must not include)
PLAN_F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
TOL = {"linear_recurrence": {"atol": 1e-5, "rtol": 1e-4},
       "wkv_recurrence": {"atol": 5e-5, "rtol": 1e-3}}


# ---------------------------------------------------------------------------
# the reference's scan apps, in JAX and as torch twins
# ---------------------------------------------------------------------------


def _recurrence_app_jax(la, b):
    def step(h, ab):
        h = jnp.exp(ab[0]) * h + ab[1]
        return h, h
    _, hs = jax.lax.scan(step, jnp.zeros(la.shape[-1]), (la, b))
    return hs * 1.5


def _wkv_app_jax(r, k, v, lw, u):
    def step(s, rkvw):
        rt, kt, vt, lwt = rkvw
        kv = kt[:, None] * vt[None, :]
        y = rt @ (s + u[:, None] * kv)
        return jnp.exp(lwt)[:, None] * s + kv, y
    _, ys = jax.lax.scan(step, jnp.zeros((r.shape[-1], v.shape[-1])),
                         (r, k, v, lw))
    return ys


def _recurrence_app(la, b):
    def step(h, ab):
        h = torch.exp(ab[0]) * h + ab[1]
        return h, h.clone()            # a scan's ys may not alias its carry
    _, hs = scan(step, torch.zeros(la.shape[-1]), (la, b))
    return hs * 1.5


def _wkv_app(r, k, v, lw, u):
    def step(s, rkvw):
        rt, kt, vt, lwt = rkvw
        kv = kt[:, None] * vt[None, :]
        y = rt @ (s + u[:, None] * kv)
        return torch.exp(lwt)[:, None] * s + kv, y
    _, ys = scan(step, torch.zeros(r.shape[-1], v.shape[-1]), (r, k, v, lw))
    return ys


def _case(rng, pattern, s=24, d=16):
    f32 = np.float32
    if pattern == "linear_recurrence":
        la = (-np.abs(rng.normal(size=(s, d))) * 0.2).astype(f32)
        b = (rng.normal(size=(s, d)) * 0.5).astype(f32)
        return _recurrence_app, _recurrence_app_jax, (la, b)
    r, k, v = ((rng.normal(size=(s, d)) * 0.5).astype(f32) for _ in range(3))
    lw = (-np.abs(rng.normal(size=(s, d))) * 0.3).astype(f32)
    u = (rng.normal(size=(d,)) * 0.1).astype(f32)
    return _wkv_app, _wkv_app_jax, (r, k, v, lw, u)


def _engine(fn, args):
    graph = annotate_variants(build_graph(fn, *args), default_db())
    return graph, SubstitutionEngine(None, args, graph)


def _loop(graph):
    loops = [r for r in graph.regions if r.kind == "loop"]
    assert len(loops) == 1
    return loops[0]


# ---------------------------------------------------------------------------
# the export frontend and the engine's scan sites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern,structure", [
    ("linear_recurrence", {"num_consts": 0, "num_carry": 1, "num_xs": 2}),
    ("wkv_recurrence", {"num_consts": 1, "num_carry": 1, "num_xs": 4}),
])
def test_export_frontend_makes_a_loop_region_per_scan(rng, pattern,
                                                      structure):
    fn, _, args = _case(rng, pattern)
    graph, _ = _engine(fn, tuple(torch.from_numpy(a) for a in args))
    region = _loop(graph)
    assert region.offloadable
    assert region.meta["pattern"] == pattern
    assert region.meta["pattern_match"] == {"how": "similarity", "score": 1.0}
    assert region.alternatives == ("ref", "fused_torch", "cuda")
    assert region.meta["scan"] == {**structure, "length": 24, "reverse": False}
    assert region.trip_count == 24
    assert "scan" in region.callees and "exp" in region.feature_vector
    # the body's get_attr is never a region input (vars are named v<i> in
    # graph order)
    gm = graph.meta["graph_module"]
    bodies = {f"v{i}" for i, n in enumerate(gm.graph.nodes)
              if n.op == "get_attr" and n.target.startswith("scan_combine")}
    assert bodies and all(not (r.uses & bodies) for r in graph.regions)


def test_scan_sites_follow_the_scan_operand_order(rng):
    _, _, args = _case(rng, "wkv_recurrence")
    graph, engine = _engine(_wkv_app, tuple(torch.from_numpy(a) for a in args))
    (site,) = engine.sites
    assert site.kind == "scan"
    # (consts..., init..., xs...) as the reference's (u, s0, r, k, v, log_w)
    assert [n.name for n in site.in_nodes] == [
        "args_4", "zeros", "args_0", "args_1", "args_2", "args_3"]
    assert [n.name for n in site.nodes] == ["scan", "getitem", "getitem_1"]
    cs = site.call_site("cpu")
    assert cs.params == {"num_consts": 1, "num_carry": 1, "length": 24,
                         "reverse": False, "zero_init": True}
    assert cs.out_used == (False, True)         # the final state is dropped
    assert [a.shape for a in cs.out_avals] == [(16, 16), (24, 16)]


@pytest.mark.parametrize("variant", ["fused_torch", "cuda"])
@pytest.mark.parametrize("pattern", ["linear_recurrence", "wkv_recurrence"])
def test_each_scan_variant_verifies_and_matches_jax(rng, pattern, variant):
    fn, jfn, args = _case(rng, pattern)
    targs = tuple(torch.from_numpy(a) for a in args)
    graph, engine = _engine(fn, targs)
    region = _loop(graph).name
    ops.reset_launch_counts()
    sub = engine.substitute({region: variant})
    assert sub.report.substituted == {region: variant}
    assert engine.verify(sub).ok
    res, chosen = engine.verify_block(region, variant)
    assert res.ok and chosen == variant
    want = np.asarray(jfn(*map(jnp.asarray, args)))
    np.testing.assert_allclose(sub(*targs).numpy(), want, **TOL[pattern])
    # CPU tensors take the plain versions: no kernel launch is counted
    assert set(ops.launch_counts().values()) == {0}


def test_reverse_scan_falls_back_with_the_reason(rng):
    """``reverse=True`` exports as flip -> scan -> flip: the site records
    it, the recurrence variants refuse it, and the flips stay on the
    reference path."""
    def rev_rec(la, b):
        def step(h, ab):
            return torch.exp(ab[0]) * h + ab[1], h.clone()
        _, hs = scan(step, torch.zeros(la.shape[-1]), (la, b), reverse=True)
        return hs

    la = torch.from_numpy(rng.normal(size=(12, 4)).astype(np.float32))
    graph, engine = _engine(rev_rec, (la, la))
    region = _loop(graph)
    assert region.meta["scan"]["reverse"] is True
    assert region.meta["pattern"] == "linear_recurrence"
    assert not any("flip" in r.callees for r in graph.regions
                   if r.kind == "loop")
    for variant in ("fused_torch", "cuda"):
        sub = engine.substitute({region.name: variant})
        assert sub.report.substituted == {}
        assert "reverse scan unsupported" in sub.report.fallbacks[region.name]
        torch.testing.assert_close(sub(la, la), rev_rec(la, la),
                                   rtol=1e-5, atol=1e-5)


def test_carry_only_scan_rejects_instead_of_crashing(rng):
    """A scan with no ys has one output, not (carry, ys): the recurrence
    predicates refuse it (ref fallback with the reason), no IndexError."""
    def carry_only(la, b):
        def step(h, ab):
            return torch.exp(ab[0]) * h + ab[1], []
        h, _ = scan(step, torch.zeros(la.shape[-1]), (la, b))
        return h

    la = torch.from_numpy(rng.normal(size=(12, 4)).astype(np.float32))
    graph, engine = _engine(carry_only, (la, la))
    for r in graph.offloadable():
        sub = engine.substitute({r.name: "cuda"})
        assert sub.report.substituted == {}
        if r.meta.get("pattern"):
            assert "expected (h_final, ys)" in sub.report.fallbacks[r.name]
        torch.testing.assert_close(sub(la, la), carry_only(la, la),
                                   rtol=1e-5, atol=1e-5)


def test_wkv_variants_refuse_what_the_kernels_do_not_take(rng):
    """A head dim the kernel is not built for falls back from ``cuda``
    only; a nonzero initial state from both variants."""
    _, _, args = _case(rng, "wkv_recurrence", d=12)
    targs = tuple(torch.from_numpy(a) for a in args)
    graph, engine = _engine(_wkv_app, targs)
    region = _loop(graph).name
    sub = engine.substitute({region: "cuda"})
    assert "head dims" in sub.report.fallbacks[region]
    assert engine.substitute({region: "fused_torch"}).report.substituted \
        == {region: "fused_torch"}

    def from_state(r, k, v, lw, u, s0):
        def step(s, rkvw):
            rt, kt, vt, lwt = rkvw
            kv = kt[:, None] * vt[None, :]
            return torch.exp(lwt)[:, None] * s + kv, rt @ (s + u[:, None] * kv)
        return scan(step, s0, (r, k, v, lw))[1]

    s0 = torch.ones(12, 12)
    graph, engine = _engine(from_state, targs + (s0,))
    region = _loop(graph).name
    for variant in ("fused_torch", "cuda"):
        sub = engine.substitute({region: variant})
        assert "zero state" in sub.report.fallbacks[region]


def test_getitem_and_flip_runs_are_not_scan_sites():
    def program(x):
        m, _ = torch.max(torch.flip(x, [0]), dim=-1)      # getitem + flip
        return torch.flip(m, [0]) * 2.0 + x.sum(-1) - 1.0

    x = torch.randn(6, 5)
    graph, engine = _engine(program, (x,))
    assert not [r for r in graph.regions if r.kind == "loop"]
    assert all("scan" not in r.meta for r in graph.regions)
    assert all(s.kind == "span" for s in engine.sites)


def test_qwen_block_keeps_five_sites_and_no_loop_region():
    cfg = tget("qwen3_0_6b").reduced()
    block = DenseBlock(cfg, device="cpu")
    graph = annotate_variants(build_graph(block, torch.randn(1, 8, 64)),
                              default_db())
    assert not [r for r in graph.regions if r.kind == "loop"]
    assert sorted(r.meta["pattern"] for r in graph.regions
                  if r.meta.get("pattern")) == ["rmsnorm"] * 4 \
        + ["softmax_attention"]


# ---------------------------------------------------------------------------
# slice 2's main path: the RG-LRU sublayer (reduced widths, f32)
# ---------------------------------------------------------------------------

B, S = 2, 24


@pytest.fixture(scope="module")
def sublayer():
    cfg = get_config("recurrentgemma_2b").reduced()
    sub = T._hybrid_sub_init(jax.random.PRNGKey(0), cfg, "rglru", jnp.float32)
    x = np.random.default_rng(0).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want = np.asarray(T._rglru_sublayer_full(jnp.asarray(x), sub, cfg,
                                             PLAN_F32)[0])
    sub_np = jax.tree_util.tree_map(np.asarray, sub)
    layer = recurrent_sublayer_from_jax(
        sub_np, tget("recurrentgemma_2b").reduced(), device="cpu")
    return sub_np, layer, torch.from_numpy(x), want


def test_recurrent_sublayer_matches_jax_sublayer(sublayer):
    _, layer, x, want = sublayer
    with torch.no_grad():
        got = layer(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_recurrent_sublayer_from_jax_rejects_bad_parameters(sublayer):
    sub, _, _, _ = sublayer
    cfg = tget("recurrentgemma_2b").reduced()
    missing = {**sub, "rglru": {k: v for k, v in sub["rglru"].items()
                                if k != "lam"}}
    with pytest.raises(ValueError, match="parameter sets differ"):
        recurrent_sublayer_from_jax(missing, cfg, device="cpu")
    misshapen = {**sub, "rglru": {**sub["rglru"],
                                  "w_a": sub["rglru"]["w_a"][:, :8]}}
    with pytest.raises(ValueError, match="rglru.w_a: shape"):
        recurrent_sublayer_from_jax(misshapen, cfg, device="cpu")
    with pytest.raises(KeyError):
        recurrent_sublayer_from_jax({k: v for k, v in sub.items()
                                     if k != "mlp"}, cfg, device="cpu")


def test_export_frontend_finds_two_norms_and_the_recurrence(sublayer):
    _, layer, x, _ = sublayer
    graph = annotate_variants(build_graph(layer, x), default_db())
    matched = {r.meta["module"]: r.meta["pattern"] for r in graph.regions
               if r.meta.get("pattern")}
    assert matched == {"ln1": "rmsnorm", "ln2": "rmsnorm",
                       "scan": "linear_recurrence"}
    loop = _loop(graph)
    assert loop.meta["module"] == "scan"
    assert loop.meta["scan"]["length"] == S
    # the permutes to and from time-major stay outside the scan's region
    assert not any(c in loop.callees for c in ("transpose", "permute"))


def _plan(target, args, **ga):
    cfg = OffloadConfig(device="cpu", repeats=1,
                        ga=GAConfig(**{"population": 4, "generations": 2,
                                       "seed": 0, **ga}),
                        options={"example_args": args})
    return Offloader(cfg).plan(target)


def test_offloader_plan_on_cpu_verifies_the_sublayer(sublayer):
    _, layer, x, want = sublayer
    res = _plan(layer, (x,))
    assert res.frontend == "export"
    assert res.verification == {"mode": "measured", "verified": True}
    np.testing.assert_allclose(res.artifact(x).numpy(), want,
                               atol=1e-4, rtol=1e-4)


def test_forced_all_kernel_plan_binds_cuda_at_three_sites(sublayer):
    _, layer, x, want = sublayer
    res = _plan(layer, (x,), generations=1)
    bits = tuple(2 if res.graph.by_name(s.region).meta.get("pattern") else 0
                 for s in res.coding.sites)
    sub = res.details["engine"].substitute(res.coding.decode(bits))
    chosen = sorted((c.pattern, c.chosen) for c in sub.report.choices
                    if c.pattern)
    assert chosen == [("linear_recurrence", "cuda")] + [("rmsnorm", "cuda")] * 2
    ops.reset_launch_counts()
    np.testing.assert_allclose(sub(x).numpy(), want, atol=1e-4, rtol=1e-4)
    assert set(ops.launch_counts().values()) == {0}


def _first_generation_kernel_sites(target, args, population):
    seen = []

    def fitness(bits):
        seen.append(tuple(bits))
        return Evaluation(tuple(bits), 1.0, True)

    cfg = OffloadConfig(device="cpu", fitness_fn=fitness,
                        ga=GAConfig(population=population, generations=1,
                                    seed=0),
                        options={"example_args": args})
    res = Offloader(cfg).plan(target)
    patterns = [res.graph.by_name(s.region).meta.get("pattern")
                for s in res.coding.sites]
    return {p for bits in seen for p, v in zip(patterns, bits) if v == 2 and p}


def test_first_generation_tries_the_kernels_on_paths_r_and_w(sublayer, rng):
    """The seed-0 searches the chip run makes (population 8 on the
    sublayer, 6 on the WKV app) propose the kernel variant at every matched
    pattern in their first generation, whatever the timings — so the scan
    kernels' launch counters must rise on the card."""
    _, layer, x, _ = sublayer
    assert _first_generation_kernel_sites(layer, (x,), 8) == {
        "linear_recurrence", "rmsnorm"}
    _, _, args = _case(rng, "wkv_recurrence")
    assert _first_generation_kernel_sites(
        _wkv_app, tuple(torch.from_numpy(a) for a in args), 6) == {
        "wkv_recurrence"}


# ---------------------------------------------------------------------------
# the hybrid family's scans and conv against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["step", "assoc", "chunked"])
@pytest.mark.parametrize("s,h0", [(24, False), (24, True), (26, True)])
def test_rglru_scans_match_the_reference_scans(impl, s, h0):
    """``rglru_scan`` under each ``rglru_impl`` against the reference's
    ``_scan_step``/``_scan_assoc``/``_scan_chunked`` (chunk 8: S = 26 is no
    multiple of it, so ``chunked`` falls back to ``assoc`` as there), from a
    zero and a nonzero state: the states and the last state."""
    from repro.models import rglru as R
    from repro_torch.models.rglru import LinearRecurrence, rglru_scan

    rng = np.random.default_rng(s + 2 * h0)
    la = (-np.abs(rng.normal(size=(2, s, 16))) * 0.3).astype(np.float32)
    b = rng.normal(size=(2, s, 16)).astype(np.float32)
    h = rng.normal(size=(2, 16)).astype(np.float32) if h0 \
        else np.zeros((2, 16), np.float32)
    ref = {"step": R._scan_step, "assoc": R._scan_assoc,
           "chunked": lambda *a: R._scan_chunked(*a, 8)}[impl]
    want_hs, want_h = ref(jnp.asarray(la), jnp.asarray(b), jnp.asarray(h))
    plan = PLAN_F32.replace(rglru_impl=impl, rglru_chunk=8)
    got_hs, got_h = rglru_scan(torch.from_numpy(la), torch.from_numpy(b),
                               torch.from_numpy(h) if h0 else None, plan,
                               LinearRecurrence())
    tol = TOL["linear_recurrence"]
    np.testing.assert_allclose(got_hs.numpy(), np.asarray(want_hs), **tol)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **tol)


@pytest.mark.parametrize("prefix", [False, True])
def test_conv1d_causal_matches_the_reference(prefix):
    """The causal depthwise conv (width 4), from zeros and from a decode
    state's carried inputs, over a sequence shorter than the width too."""
    from repro.models import rglru as R
    from repro_torch.models.rglru import conv1d_causal

    rng = np.random.default_rng(5)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    bias = rng.normal(size=(8,)).astype(np.float32)
    pre = rng.normal(size=(2, 3, 8)).astype(np.float32) if prefix else None
    for s in (9, 2):
        x = rng.normal(size=(2, s, 8)).astype(np.float32)
        got = conv1d_causal(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(bias),
                            torch.from_numpy(pre) if prefix else None)
        want = R.conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias),
                               jnp.asarray(pre) if prefix else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_recurrence_site_folds_only_the_zeros_it_builds(sublayer, with_state):
    """The ``linear_recurrence`` site of a sublayer run from zero is
    ``zero_init`` (the kernel needs no fold); run from a decode state it is
    not, and the forced kernel plan still matches the program."""
    from repro_torch.models.rglru import RGLRUState

    _, layer, x, _ = sublayer
    cfg = layer.cfg
    gen = torch.Generator().manual_seed(4)
    h = torch.randn(B, cfg.d_rnn_resolved, generator=gen)
    conv = torch.randn(B, cfg.conv1d_width - 1, cfg.d_rnn_resolved,
                       generator=gen)

    class Continue(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = layer

        def forward(self, x, h, conv):
            state = RGLRUState(h, conv) if with_state else None
            return self.layer(x, state=state, with_state=True)

    args = (x, h, conv)
    graph = annotate_variants(build_graph(Continue(), *args), default_db())
    loop = _loop(graph)
    assert loop.meta["pattern"] == "linear_recurrence"
    engine = SubstitutionEngine(graph.meta["graph_module"], args, graph)
    assert engine._site(loop.name).params["zero_init"] is not with_state
    sub = engine.substitute({loop.name: "cuda"})
    assert [c.chosen for c in sub.report.choices
            if c.region == loop.name] == ["cuda"]
    (y, st), (want_y, want_st) = sub(*args), engine.reference()
    for got, want in ((y, want_y), (st.h, want_st.h),
                      (st.conv, want_st.conv)):
        torch.testing.assert_close(got, want, **TOL["linear_recurrence"])


# ---------------------------------------------------------------------------
# an exported scan program does not outlive its caller's references
# ---------------------------------------------------------------------------


def test_scan_export_releases_the_program():
    """Exporting a scan compiles its body through ``torch.compile``, and
    dynamo's caches of that compile held the export's tracer, the program,
    its modules and their weights until a global ``torch._dynamo.reset()``.
    The export frontend now releases what it traced: a reduced hybrid
    model's parameter dies once the caller drops its references."""
    import gc
    import weakref

    from repro_torch.models import build_model
    from repro_torch.models.plan import ExecPlan

    cfg = tget("recurrentgemma_2b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    plan = ExecPlan(compute_dtype="float32")            # the step scan
    tokens = torch.randint(0, cfg.vocab, (1, 16),
                           generator=torch.Generator().manual_seed(1))
    alive = weakref.ref(params.embed)
    graph = build_graph(lambda t: model.prefill(params, {"tokens": t}, plan),
                        tokens)
    assert sum(r.kind == "loop" for r in graph.regions) == 2
    del graph, params
    gc.collect()
    assert alive() is None
