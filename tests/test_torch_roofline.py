"""The port's roofline and aten-graph cost analyzer (``repro_torch.roofline``,
``repro_torch.hlo_analysis``) against the reference's on the CPU: the ring
model, the model-FLOP counts, the FLOPs of a prefill and a train step
against the reference's ``analyze_hlo`` and ``FlopCounterMode``, scan
multipliers, slice-update and view bytes, collectives, module scopes, the
liveness walk, and the kernel costs against ``chip_smoke.py``'s phase-2
counts."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._higher_order_ops.scan import scan  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import hlo_analysis as jha  # noqa: E402
from repro import roofline as jrl  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.models.plan import REFERENCE_PLAN as JREFERENCE_PLAN  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim.schedule import make_schedule as jmake_schedule  # noqa: E402
from repro.runtime.train import TrainState as JTrainState  # noqa: E402
from repro.runtime.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import hlo_analysis as ha  # noqa: E402
from repro_torch import roofline as rl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import REFERENCE_PLAN  # noqa: E402

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
JF32 = JREFERENCE_PLAN.replace(compute_dtype="float32")
COLLECTIVE_OPS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                  "collective-permute")


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16, 256])
@pytest.mark.parametrize("op", COLLECTIVE_OPS)
def test_ring_model_matches_reference(op, g):
    for sz in (0, 4, 4096, 3 * 1024 * 1024 + 12):
        want = jha._ring_bytes(op, sz, g)
        assert rl.CollectiveOp(op, sz, g, "").link_bytes == want
        assert jrl.CollectiveOp(op, sz, g, "").link_bytes == want
        assert ha._ring_bytes(op, sz, g) == want


def test_roofline_terms_use_the_card_and_the_reference_summary_keys():
    roof = rl.Roofline(flops=3e12, hbm_bytes=6.7e9, collective_bytes=9e8,
                       n_devices=1, model_flops=2e12,
                       flops_by_dtype={"bf16": 1.978e12, "f32": 1.022e12})
    assert roof.compute_s == pytest.approx(1.978e12 / 989e12
                                           + 1.022e12 / 67e12, rel=1e-12)
    assert roof.memory_s == pytest.approx(6.7e9 / 3.35e12, rel=1e-12)
    assert roof.collective_s == pytest.approx(9e8 / 450e9, rel=1e-12)
    assert roof.step_s == roof.compute_s and roof.dominant == "compute"
    assert roof.roofline_fraction == pytest.approx(
        2e12 / (roof.step_s * 3e12 / roof.compute_s), rel=1e-12)
    want = jrl.Roofline(3e12, 6.7e9, 9e8, 1, model_flops=2e12).summary()
    assert list(roof.summary()) == list(want)
    # without a precision mix the reference's rule: every FLOP at bf16
    assert rl.Roofline(989e12, 0, 0, 1).compute_s == pytest.approx(1.0)


def test_f32_matmuls_take_tf32_when_the_precision_allows():
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        assert rl.matmul_class(torch.float32) == "f32"
        torch.set_float32_matmul_precision("high")
        assert rl.matmul_class(torch.float32) == "tf32"
        assert rl.matmul_class(torch.bfloat16) == "bf16"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    n = get_config(arch).param_count(active_only=True)
    assert n == jget_config(arch).param_count(active_only=True)
    for tokens in (1, 4096, 1_048_576):
        assert rl.model_flops_train(n, tokens) == \
            jrl.model_flops_train(n, tokens)
        assert rl.model_flops_infer(n, tokens) == \
            jrl.model_flops_infer(n, tokens)


def _phase2_flash(b, sq, sk, hq, hkv, d, causal, elt):
    """``chip_smoke.py``'s phase-2 count as it was written there."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4.0 * b * hq * d * pairs, \
        (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elt


@pytest.mark.parametrize("shape", [
    (2, 2048, 2048, 16, 8, 128, True), (2, 2048, 2048, 10, 1, 256, True),
    (2, 448, 448, 12, 12, 64, True), (2, 1500, 1500, 12, 12, 64, False),
    (2, 448, 1500, 12, 12, 64, False), (1, 8, 8, 1, 1, 128, True),
    (1, 2048, 2048, 1, 1, 128, True), (1, 300, 128, 2, 1, 64, True)])
def test_kernel_costs_equal_phase2_counts(shape):
    *dims, causal = shape
    for dtype, elt, cls in ((torch.float32, 4, "f32"),
                            (torch.bfloat16, 2, "bf16")):
        c = rl.flash_cost(*dims, causal, dtype)
        assert (c.flops, c.bytes) == _phase2_flash(*dims, causal, elt)
        assert c.dtype == cls
    for n, d in ((4096, 1024), (2, 2560), (3000, 768), (128, 1024)):
        for dtype, elt in ((torch.float32, 4), (torch.bfloat16, 2)):
            c = rl.rmsnorm_cost(n, d, dtype, dtype)
            assert (c.flops, c.bytes, c.dtype) == \
                (4.0 * n * d, 2 * n * d * elt + d * elt, "f32")
    for (b, s, d), h0 in (((2, 2048, 2560), False), ((1, 128, 2560), True)):
        n = b * s * d
        c = rl.rglru_cost(b, s, d, h0)
        assert (c.flops, c.bytes) == \
            (3.0 * n, 3 * n * 4 + (b * d * 4 if h0 else 0))
    for b, s, h, d in ((1, 4096, 1, 64), (2, 2048, 40, 64)):
        n = b * s * h * d
        c = rl.wkv6_cost(b, s, h, d)
        assert (c.flops, c.bytes) == (4.0 * n * d, 5 * n * 4 + h * d * 4)


# ---------------------------------------------------------------------------
# the analyzer against the reference's analyze_hlo and FlopCounterMode
# ---------------------------------------------------------------------------


def _meta_run_flops(lowered) -> float:
    """FlopCounterMode over one run of the traced graph on meta tensors."""
    vals = [n.meta.get("val") for n in lowered.gm.graph.nodes
            if n.op == "placeholder"]
    args = [torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                device="meta")
            if isinstance(v, torch.Tensor) else v for v in vals]
    with FlopCounterMode(display=False) as fc:
        lowered.gm(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "tinyllama_1_1b",
                                  "olmoe_1b_7b"])
def test_prefill_flops_match_reference_and_flop_counter(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), n_layers=2)
    low = dryrun._lower_one(cfg, ShapeSpec("p", 32, 2, "prefill"), F32,
                            torch.device("cpu"), torch.float32)
    got = ha.analyze_hlo(low.compile(), 1)
    jm = jbuild_model(jcfg)
    lowered = jax.jit(lambda p, i: jm.prefill(p, i, JF32, cache_capacity=32)
                      ).lower(jm.param_shapes(dtype=jnp.float32),
                              jm.input_specs(JShapeSpec("p", 32, 2,
                                                        "prefill")))
    want = jha.analyze_hlo(lowered.compile().as_text(), 1).flops
    assert got.flops == pytest.approx(want, rel=1e-6)
    assert got.flops == pytest.approx(_meta_run_flops(low), rel=1e-6)
    assert got.flops_by_dtype == {"f32": got.flops} or \
        rl.matmul_class(torch.float32) == "tf32"


@pytest.mark.parametrize("arch,rel", [("qwen3_0_6b", 1e-6),
                                      ("olmoe_1b_7b", 2e-3)])
def test_train_step_flops_match_reference(arch, rel):
    """The dense train step matches the reference's HLO count exactly
    (stated tolerance 1e-6); OLMoE's differs by 1.09e-3: the router's and
    the one-hot dispatch's backward products, which XLA folds where autograd
    keeps a matmul.  Against ``FlopCounterMode`` on the same graph: exact."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), n_layers=2)
    low = dryrun._lower_one(cfg, ShapeSpec("t", 32, 2, "train"), F32,
                            torch.device("cpu"), None)
    got = ha.analyze_hlo(low.compile(), 1).flops
    jm = jbuild_model(jcfg)
    pshapes = jm.param_shapes(dtype=jnp.float32)
    step = jmake_train_step(jm, JF32, JOptimizerConfig(),
                            jmake_schedule(total_steps=10_000))
    state = JTrainState(pshapes, jax.eval_shape(jadamw_init, pshapes), None)
    lowered = jax.jit(step).lower(
        state, jm.input_specs(JShapeSpec("t", 32, 2, "train")))
    want = jha.analyze_hlo(lowered.compile().as_text(), 1).flops
    assert got == pytest.approx(want, rel=rel)
    assert abs(got - want) / want > 1e-3 if arch == "olmoe_1b_7b" else True


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_traced_train_step_recomputes_as_eager_does(remat):
    """The trace runs as a non-strict tracing session: the ``dots``
    selective checkpoint recomputes its batched products in the backward
    as an eager run does (``FlopCounterMode`` on the eager step)."""
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig, adamw_init, make_schedule
    from repro_torch.runtime.train import TrainState, make_train_step

    cfg = dataclasses.replace(get_config("qwen3_0_6b").reduced(), n_layers=2)
    plan = F32.replace(remat=remat, attn_impl="chunked")
    low = dryrun._lower_one(cfg, ShapeSpec("t", 32, 2, "train"), plan,
                            torch.device("cpu"), None)
    model = build_model(cfg)
    params = model.param_shapes()
    state = TrainState(params, adamw_init(params), None)
    step = make_train_step(model, plan, OptimizerConfig(),
                           make_schedule(total_steps=10_000))
    with FlopCounterMode(display=False) as fc:
        step(state, model.input_specs(ShapeSpec("t", 32, 2, "train")))
    assert ha.analyze_hlo(low.compile(), 1).flops == fc.get_total_flops()


def test_scan_bodies_multiply_and_nested_multipliers_compose():
    def fn(h0, xss, w):
        def inner(h, x):
            h = h @ w + x
            return h, h.clone()

        def outer(h, xs):
            h, ys = scan(inner, h, xs)
            return h, ys.sum(0)

        return scan(outer, h0, xss)

    args = (torch.randn(4, 8), torch.randn(5, 3, 4, 8), torch.randn(8, 8))
    gm = make_fx(fn, tracing_mode="fake")(*(a.to("meta") for a in args))
    cost = ha.analyze_hlo(gm, 1)
    assert cost.flops == 5 * 3 * 2 * 4 * 8 * 8     # 15 (4, 8) @ (8, 8)
    inner_scope = max(cost.by_computation.values(), key=lambda e: e["mult"])
    assert inner_scope["mult"] == 15


def test_slice_updates_cost_their_slice_and_views_cost_nothing():
    cache = torch.zeros(2, 4096, 8, 64)
    kv = torch.randn(2, 1, 8, 64)
    pos = torch.tensor([7])

    def update(c, x, p):
        return c.index_copy(1, p, x)

    def views(c):
        return c.view(2, 4096, 512).transpose(0, 1).reshape(4096, 1024)[3]

    gm = make_fx(update, tracing_mode="fake")(cache, kv, pos)
    assert ha.analyze_hlo(gm, 1).bytes == 2 * kv.numel() * 4
    gm = make_fx(views, tracing_mode="fake")(cache)
    # one copy where reshape cannot view the transposed layout; nothing else
    copies = [n for n in gm.graph.nodes if n.op == "call_function"
              and not n.target.is_view]
    want = sum(2 * n.meta["val"].numel() * 4 for n in copies)
    assert ha.analyze_hlo(gm, 1).bytes == want


def test_elementwise_bytes_are_operands_plus_result_a_broadcast_once():
    def fn(x, b):
        return x * b                       # b (1024,) broadcast over rows

    gm = make_fx(fn, tracing_mode="fake")(torch.randn(64, 1024),
                                          torch.randn(1024))
    assert ha.analyze_hlo(gm, 1).bytes == (2 * 64 * 1024 + 1024) * 4


def test_collectives_get_ring_bytes_with_their_group_size():
    """A graph of functional collectives, built as a traced program holds
    them (values on the meta device)."""
    g = torch.fx.Graph()
    x = g.placeholder("x")
    x.meta["val"] = torch.empty(1024, 256, device="meta")
    ag = g.call_function(torch.ops._c10d_functional.all_gather_into_tensor
                         .default, (x, 4, "0"))
    ag.meta["val"] = torch.empty(4096, 256, device="meta")
    ar = g.call_function(torch.ops._c10d_functional.all_reduce.default,
                         (x, "sum", "0"))
    ar.meta["val"] = torch.empty(1024, 256, device="meta")
    rs = g.call_function(torch.ops._c10d_functional.reduce_scatter_tensor
                         .default, (x, "sum", 2, "0"))
    rs.meta["val"] = torch.empty(512, 256, device="meta")
    g.output((ag, ar, rs))
    gm = torch.fx.GraphModule(torch.nn.Module(), g)
    cost = ha.analyze_hlo(gm, 8)
    sz = 1024 * 256 * 4
    want = [("all-gather", 4 * sz, 4), ("all-reduce", sz, 8),
            ("reduce-scatter", sz // 2, 2)]
    assert [c[:3] for c in cost.collectives] == want
    assert cost.link_bytes == sum(jha._ring_bytes(*w) for w in want)
    hist = jha.HloCost(0, 0, 0, [(*w, jha._ring_bytes(*w), 1.0)
                                 for w in want], {}).collective_histogram()
    assert cost.collective_histogram() == hist
    roof = rl.analyze(None, gm, n_devices=8)
    assert roof.collective_s == pytest.approx(cost.link_bytes / rl.LINK_BW)
    assert [c.op for c in roof.collectives] == [w[0] for w in want]
    assert len(rl.parse_collectives(gm, 8)) == 3


def test_by_computation_is_keyed_by_module_scope():
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = torch.nn.Linear(32, 64)
            self.down = torch.nn.Linear(64, 32)

        def forward(self, x):
            return self.down(torch.relu(self.up(x)))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = torch.nn.ModuleList([Block(), Block()])

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return x

    ep = torch.export.export(Net(), (torch.randn(8, 32),))
    cost = ha.analyze_hlo(ep, 1)
    assert cost.by_computation["blocks.1.up"]["flops"] == 2 * 8 * 32 * 64
    assert sum(e["flops"] for e in cost.by_computation.values()) == cost.flops


def test_memory_analysis_counts_each_storage_once():
    def fn(x, w):
        h = x @ w                          # temp: 64 x 128
        a = h.view(128, 64)                # a view of h: no new storage
        y = torch.relu(a).sum(0)           # temp relu (128 x 64), out (64,)
        x.add_(1.0)                        # in place on an argument
        return y, x                        # x aliases an argument

    gm = make_fx(fn, tracing_mode="fake")(torch.randn(64, 32),
                                          torch.randn(32, 128))
    mem = ha.memory_analysis(gm)
    assert mem.argument_size_in_bytes == (64 * 32 + 32 * 128) * 4
    assert mem.output_size_in_bytes == 64 * 4
    assert mem.alias_size_in_bytes == 64 * 32 * 4
    assert mem.temp_size_in_bytes == 2 * 64 * 128 * 4


def test_compiled_artifact_has_the_reference_interface():
    low = ha.lower(lambda x, w: (x @ w).relu(), torch.randn(16, 32),
                   torch.randn(32, 8))
    compiled = low.compile()
    assert compiled.cost_analysis() == {"flops": 2 * 16 * 32 * 8,
                                        "bytes accessed":
                                            compiled.hlo_cost(1).bytes}
    assert "mm" in compiled.as_text()
    mem = compiled.memory_analysis()
    assert mem.argument_size_in_bytes == (16 * 32 + 32 * 8) * 4
    roof = rl.analyze(compiled)
    assert roof.flops == 2 * 16 * 32 * 8 and roof.collective_s == 0.0
    assert roof.step_s == max(roof.compute_s, roof.memory_s)
    assert math.isfinite(roof.roofline_fraction)
