"""Function-block genes in the port's export frontend
(``export_frontend.annotate_block_sites``) and the block variants of the
port's registry, on the CPU.

Twins of the block and static-cost tests of ``tests/test_substitution.py``
(whole-window equivalence, claiming and releasing members, predicate
fallbacks, the ``block_sites``/``static_cost`` options) over the torch twin
of the reference's attention-stack program -- an ``nn.Module`` whose norm
and attention core are submodules, as every model of the zoo has them.
The reference's jaxpr block pass cannot run under the installed jax (it
reads ``jax.core.Literal``), so the oracles are its positional
(python_ast) block adapters for ``attention_stack``, bound with no
equations, and ``repro.models.moe.moe_scatter`` and the dense one-hot
formula for ``moe_dispatch``; all at rtol = atol = 1e-5 in f32."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import variants as jvariants  # noqa: E402
from repro.kernels import registry as jreg  # noqa: E402
from repro_torch.core.frontends import export_frontend as ef  # noqa: E402
from repro_torch.core.frontends.registry import (OffloadConfig,  # noqa: E402
                                                 get_frontend)
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.offload import Offloader, plan  # noqa: E402
from repro_torch.core.pattern_db import default_db  # noqa: E402
from repro_torch.core.substitution import SubstitutionEngine  # noqa: E402
from repro_torch.core.variants import resolve_variant  # noqa: E402
from repro_torch.core.verifier import verify  # noqa: E402
from repro_torch.kernels.registry import (Aval, CallSite,  # noqa: E402
                                          default_registry)
from repro_torch.models.layers import RMSNorm  # noqa: E402

BLOCK_VARIANTS = ("block_chunked", "block_fused")
TOL = 1e-5
CPU = {"device": "cpu"}


# ---------------------------------------------------------------------------
# the programs: torch twins of the reference's block workloads
# ---------------------------------------------------------------------------


class Attention(torch.nn.Module):
    """Causal single-head attention core (the name-matched submodule)."""

    def forward(self, q, k, v):
        s = q @ k.T / math.sqrt(q.shape[-1])
        mask = torch.tril(torch.ones(q.shape[0], k.shape[0],
                                     dtype=torch.bool, device=q.device))
        return torch.softmax(torch.where(mask, s, -1e30), dim=-1) @ v


class AttentionStack(torch.nn.Module):
    """The reference's ``_attention_stack_case`` model: RMSNorm, q/k/v
    projections, causal attention, output projection and the residual."""

    def __init__(self, x_scale, wq, wk, wv, wo):
        super().__init__()
        self.norm = RMSNorm(x_scale.shape[0])
        with torch.no_grad():
            self.norm.weight.copy_(x_scale)
        self.wq, self.wk, self.wv, self.wo = (
            torch.nn.Parameter(w) for w in (wq, wk, wv, wo))
        self.attn = Attention()

    def forward(self, x):
        xn = self.norm(x)
        o = self.attn(xn @ self.wq, xn @ self.wk, xn @ self.wv)
        return x + o @ self.wo


class Router(torch.nn.Module):
    """Softmax top-k router returning the combined gate matrix (T, E)."""

    def __init__(self, w_router, top_k):
        super().__init__()
        self.weight = torch.nn.Parameter(w_router)
        self.top_k = top_k

    def forward(self, x):
        probs = torch.softmax(x @ self.weight, dim=-1)
        gates, idx = torch.topk(probs, self.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        onehot = (idx[..., None] == torch.arange(
            self.weight.shape[1], device=x.device)).float()
        return torch.einsum("tk,tke->te", gates, onehot)


class Experts(torch.nn.Module):
    """Every token through every expert, combined by the gate matrix."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (
            torch.nn.Parameter(w) for w in (w_gate, w_up, w_down))

    def forward(self, x, combine):
        g = torch.einsum("td,edf->tef", x, self.w_gate)
        u = torch.einsum("td,edf->tef", x, self.w_up)
        h = torch.nn.functional.silu(g) * u
        y = torch.einsum("tef,efd->ted", h, self.w_down)
        return torch.einsum("ted,te->td", y, combine)


class MoEDispatch(torch.nn.Module):
    """The ``moe_dispatch`` record's dense one-hot program."""

    def __init__(self, w_router, w_gate, w_up, w_down, top_k):
        super().__init__()
        self.router = Router(w_router, top_k)
        self.experts = Experts(w_gate, w_up, w_down)

    def forward(self, x):
        return self.experts(x, self.router(x))


def _stack_arrays(s=64, d=16, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(s, d))
    scale = r.normal(size=d) * 0.1
    ws = [r.normal(size=(d, d)) / math.sqrt(d) for _ in range(4)]
    return [a.astype(np.float32) for a in (x, scale, *ws)]


def _moe_arrays(t=32, d=16, e=8, f=12, seed=0):
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.normal(size=(t, d)), r.normal(size=(d, e)) / math.sqrt(d),
        r.normal(size=(e, d, f)) / math.sqrt(d),
        r.normal(size=(e, d, f)) / math.sqrt(d),
        r.normal(size=(e, f, d)) / math.sqrt(f))]


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _stack_case(s=64, d=16):
    x, scale, wq, wk, wv, wo = _t(*_stack_arrays(s, d))
    return AttentionStack(scale, wq, wk, wv, wo), (x,)


def _engine(model, args, block_sites=True):
    fe = get_frontend("export")
    cfg = OffloadConfig(repeats=1, options={"example_args": args,
                                            "block_sites": block_sites},
                        **CPU)
    graph = fe.build_graph(model, None, cfg)
    engine = SubstitutionEngine(None, args, graph)
    blocks = [r for r in graph.regions if r.meta.get("block_members")]
    return engine, graph, blocks


def _block_engine():
    model, args = _stack_case()
    engine, graph, blocks = _engine(model, args)
    assert len(blocks) == 1, "the attention stack makes one block region"
    return engine, blocks[0], model, args


def _site(engine, region):
    return next(s for s in engine.sites if s.region == region)


# ---------------------------------------------------------------------------
# the window rule
# ---------------------------------------------------------------------------


def test_attention_stack_gets_one_block_over_norm_and_attention():
    engine, fb, _, _ = _block_engine()
    graph = engine.graph
    assert fb.name == "fnblock_0" and fb.kind == "block"
    assert fb.meta["pattern"] == "attention_stack"
    assert fb.alternatives == ("ref",) + BLOCK_VARIANTS
    members = [graph.by_name(m) for m in fb.meta["block_members"]]
    assert [m.meta.get("pattern") for m in members] == \
        ["rmsnorm", "softmax_attention"]
    # the q/k/v projections between them go with the window, geneless
    stmts = [r for r in graph.regions if r.kind == "stmt"
             and set(r.meta["nodes"]) <= set(fb.meta["nodes"])]
    assert stmts and not any(r.offloadable for r in stmts)
    assert fb.defs == frozenset() and fb.uses == frozenset()
    site = _site(engine, fb.name)
    assert site.kind == "block" and len(site.in_nodes) == 5
    assert len(site.out_nodes) == 1


def test_function_without_submodules_has_no_window():
    x, scale, wq, wk, wv, _ = _t(*_stack_arrays())

    def flat(x, scale, wq, wk, wv):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        xn = x * torch.rsqrt(var + 1e-6) * (1.0 + scale)
        q, k, v = xn @ wq, xn @ wk, xn @ wv
        s = q @ k.T / math.sqrt(q.shape[-1])
        mask = torch.tril(torch.ones(s.shape, dtype=torch.bool))
        return torch.softmax(torch.where(mask, s, -1e30), dim=-1) @ v

    _, graph, blocks = _engine(flat, (x, scale, wq, wk, wv))
    assert len([r for r in graph.regions if r.meta.get("nodes")]) == 1
    assert blocks == []


def test_wider_window_that_binds_no_variant_is_not_kept():
    """A second attention after the stack: the widest windows match by
    name but bind no variant (more than five inputs, or several used
    outputs), so the block kept is the stack's own window."""
    model, args = _stack_case()

    class Wider(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = model
            self.attn2 = Attention()

        def forward(self, x):
            y = self.inner(x)
            return self.attn2(y, y, y)

    _, graph, blocks = _engine(Wider(), args)
    assert len(blocks) == 1
    members = [graph.by_name(m) for m in blocks[0].meta["block_members"]]
    assert [m.meta["module"] for m in members] == ["inner.norm", "inner.attn"]


# ---------------------------------------------------------------------------
# twins of tests/test_substitution.py's block and static-cost tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", BLOCK_VARIANTS)
def test_block_substitution_equivalence(variant):
    engine, fb, model, args = _block_engine()
    assert set(fb.alternatives) >= {"ref"} | set(BLOCK_VARIANTS)

    res, chosen = engine.verify_block(fb.name, variant)
    assert chosen == variant
    assert res.ok, (variant, res)

    sub = engine.substitute({fb.name: variant})
    assert sub.report.substituted[fb.name] == variant
    by_region = {c.region: c for c in sub.report.choices}
    for member in fb.meta["block_members"]:
        assert by_region[member].chosen == "ref"
        assert f"claimed by block {fb.name}" in by_region[member].why
    with torch.no_grad():
        v = verify(model(*args), sub(*args))
    assert v.ok, (variant, v)


def test_block_gene_overrides_member_requests():
    engine, fb, model, args = _block_engine()
    member = fb.meta["block_members"][-1]
    sub = engine.substitute({fb.name: "block_fused", member: "fused_torch"})
    assert sub.report.substituted == {fb.name: "block_fused"}
    choice = next(c for c in sub.report.choices if c.region == member)
    assert choice.chosen == "ref"
    assert f"claimed by block {fb.name}" in choice.why
    with torch.no_grad():
        v = verify(model(*args), sub(*args))
    assert v.ok, v


def test_block_unknown_impl_releases_members():
    engine, fb, model, args = _block_engine()
    member = fb.meta["block_members"][-1]
    sub = engine.substitute({fb.name: "no-such-variant",
                             member: "fused_torch"})
    assert fb.name not in sub.report.substituted
    assert "unknown implementation" in sub.report.fallbacks[fb.name]
    for c in sub.report.choices:
        assert "claimed by block" not in c.why
    # released: the member's own variant substitutes
    assert sub.report.substituted == {member: "fused_torch"}
    with torch.no_grad():
        np.testing.assert_allclose(sub(*args).numpy(), model(*args).numpy(),
                                   rtol=TOL, atol=TOL)
    res, chosen = engine.verify_block(fb.name, "no-such-variant")
    assert chosen == "ref" and res.ok


def test_block_predicate_rejection_falls_back_to_ref():
    d = 600                              # > the binder's 512 head-dim cap
    av = lambda *shape: Aval(shape, torch.float32)   # noqa: E731
    site = CallSite(pattern="attention_stack", kind="block",
                    in_avals=(av(32, d), av(d), av(d, d), av(d, d),
                              av(d, d)),
                    out_avals=(av(32, d),), out_used=(True,))
    for variant in BLOCK_VARIANTS:
        adapter, chosen, why = resolve_variant(site, variant)
        assert adapter is None and chosen == "ref"
        assert "head dim outside kernel range" in why


def test_block_sites_opt_out_leaves_graph_loop_only():
    model, args = _stack_case()
    cfg = OffloadConfig(ga=GAConfig(population=6, generations=2, seed=0),
                        options={"example_args": args,
                                 "block_sites": False}, repeats=1, **CPU)
    res = Offloader(cfg).plan(model)
    assert not any(r.meta.get("block_members") for r in res.graph.regions)
    assert all(not s.members for s in res.coding.sites)


def test_static_cost_path_plans_the_block_gene_without_running():
    model, args = _stack_case()
    res = plan(model, config=OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=0),
        options={"example_args": args, "static_cost": True}, **CPU))
    assert res.verification["mode"] == "static-cost"
    assert not res.verification["verified"]
    assert res.best.detail.get("static_cost")
    assert isinstance(res.artifact, dict)    # impl map, not a callable
    # the block pass claims every name-matched region, the fnblock window
    # too, as the reference's static-cost path does: nothing is left to
    # search, and the impl map holds the claims
    assert res.block.claimed_regions == ("block_0", "block_2", "fnblock_0")
    assert res.artifact == dict.fromkeys(res.block.claimed_regions, "kernel")
    assert res.coding.length == 0


# ---------------------------------------------------------------------------
# the block adapters against the reference's
# ---------------------------------------------------------------------------


def _jx_positional_adapter(variant, avals):
    """The reference's attention_stack adapter bound positionally, as its
    python_ast frontend binds it (no equations)."""
    av = [jax.ShapeDtypeStruct(shape, jnp.float32) for shape in avals]
    site = jreg.CallSite(pattern="attention_stack", kind="block",
                         in_avals=tuple(av[:5]),
                         out_avals=(jax.ShapeDtypeStruct(
                             (avals[0][0], avals[2][1]), jnp.float32),),
                         out_used=(True,))
    adapter, chosen, why = jvariants.resolve_variant(site, variant)
    assert adapter is not None, why
    return adapter


@pytest.mark.parametrize("variant", BLOCK_VARIANTS)
def test_block_adapters_equal_the_reference_positional_adapters(variant):
    """On the same arrays: the reference's adapter bound positionally (no
    equations), the port's bound positionally, and the port's bound on the
    export window (roles from the FX dataflow, operands in the window's
    first-use order)."""
    arrays = _stack_arrays(s=64, d=16)[:5]            # x, scale, wq, wk, wv
    want = np.asarray(_jx_positional_adapter(
        variant, [a.shape for a in arrays])(*map(jnp.asarray, arrays))[0])

    av = [Aval(a.shape, torch.float32) for a in arrays]
    pos_site = CallSite(pattern="attention_stack", kind="block",
                        in_avals=tuple(av),
                        out_avals=(Aval((64, 16), torch.float32),),
                        out_used=(True,))
    pos_adapter, chosen, why = resolve_variant(pos_site, variant)
    assert chosen == variant, why
    np.testing.assert_allclose(pos_adapter(*_t(*arrays))[0].numpy(), want,
                               rtol=TOL, atol=TOL)

    engine, fb, _, _ = _block_engine()               # the same arrays
    site = _site(engine, fb.name)
    adapter, chosen, why = resolve_variant(site.call_site("cpu"), variant)
    assert chosen == variant, why
    ins, _ = engine._site_values(site)
    with torch.no_grad():
        got = adapter(*ins)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# moe_dispatch: the window and block_scatter
# ---------------------------------------------------------------------------


def _moe_case(top_k=2, **kw):
    x, wr, wg, wu, wd = _t(*_moe_arrays(**kw))
    return MoEDispatch(wr, wg, wu, wd, top_k), (x,)


def test_moe_dispatch_window_is_found_and_bound():
    model, args = _moe_case()
    engine, graph, blocks = _engine(model, args)
    assert len(blocks) == 1
    fb = blocks[0]
    assert fb.meta["pattern"] == "moe_dispatch"
    assert fb.alternatives == ("ref", "block_scatter")
    assert len(fb.meta["block_members"]) == 2
    site = _site(engine, fb.name)
    assert site.kind == "block" and len(site.in_nodes) == 5
    res, chosen = engine.verify_block(fb.name, "block_scatter")
    assert chosen == "block_scatter" and res.ok, res
    sub = engine.substitute({fb.name: "block_scatter"})
    assert sub.report.substituted == {fb.name: "block_scatter"}
    with torch.no_grad():
        np.testing.assert_allclose(sub(*args).numpy(), model(*args).numpy(),
                                   rtol=TOL, atol=TOL)


def _jx_dense(x, wr, wg, wu, wd, k):
    probs = jax.nn.softmax(x @ wr, axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
    combine = jnp.einsum("tk,tke->te", gates,
                         jax.nn.one_hot(idx, wr.shape[1]))
    g = jnp.einsum("td,edf->tef", x, wg)
    u = jnp.einsum("td,edf->tef", x, wu)
    y = jnp.einsum("tef,efd->ted", jax.nn.silu(g) * u, wd)
    return jnp.einsum("ted,te->td", y, combine)


@pytest.mark.parametrize("top_k", [2, 3])
def test_block_scatter_equals_the_reference_moe_scatter(top_k):
    from repro.configs.base import ArchConfig, MoEConfig
    from repro.models.moe import moe_scatter
    from repro.models.plan import ExecPlan

    arrays = _moe_arrays()
    x, wr, wg, wu, wd = arrays
    model, args = _moe_case(top_k=top_k)
    engine, graph, blocks = _engine(model, args)
    site = _site(engine, blocks[0].name)
    adapter, chosen, why = resolve_variant(site.call_site("cpu"),
                                           "block_scatter")
    assert chosen == "block_scatter", why
    by_name = {n.name: t for n, t in zip(site.in_nodes,
                                         engine._site_values(site)[0])}
    with torch.no_grad():
        got = adapter(*by_name.values())[0].numpy()

    e, f = wg.shape[0], wg.shape[2]
    cfg = ArchConfig("block_moe", "moe", d_model=x.shape[1],
                     moe=MoEConfig(n_experts=e, top_k=top_k, d_ff_expert=f,
                                   capacity_factor=float(e)))
    want, _ = moe_scatter(jnp.asarray(x), {
        "w_router": jnp.asarray(wr), "w_gate": jnp.asarray(wg),
        "w_up": jnp.asarray(wu), "w_down": jnp.asarray(wd)}, cfg,
        ExecPlan(moe_impl="scatter_ep", compute_dtype="float32"))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    dense = np.asarray(_jx_dense(*map(jnp.asarray, arrays), top_k))
    np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)
    with torch.no_grad():
        np.testing.assert_allclose(model(*args).numpy(), dense,
                                   rtol=TOL, atol=TOL)


def test_moe_site_reads_top_k_from_the_topk_node():
    from repro_torch.kernels.registry import _moe_site

    model, args = _moe_case(top_k=3)
    engine, _, blocks = _engine(model, args)
    site = _site(engine, blocks[0].name).call_site("cpu")
    *_, n_experts, top_k = _moe_site(site)
    assert (n_experts, top_k) == (8, 3)


# ---------------------------------------------------------------------------
# the pipeline: a measured plan over the block gene
# ---------------------------------------------------------------------------


def test_measured_plan_carries_the_block_gene_and_verifies():
    model, args = _stack_case()
    res = plan(model, config=OffloadConfig(
        ga=GAConfig(population=6, generations=2, seed=0), repeats=1,
        options={"example_args": args}, **CPU))
    assert res.verification["verified"]
    blocks = [s for s in res.coding.sites if s.members]
    assert len(blocks) == 1 and len(blocks[0].members) == 2
    engine = res.details["engine"]
    # every block variant verifies through the planned engine
    for variant in BLOCK_VARIANTS:
        v, chosen = engine.verify_block(blocks[0].region, variant)
        assert chosen == variant and v.ok, v
