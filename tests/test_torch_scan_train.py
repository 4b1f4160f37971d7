"""Train steps through a ``scan`` on the cost side and in eager runs, on the
CPU at reduced sizes, against the JAX reference: the traced train step of
RecurrentGemma-2B (RG-LRU ``step``, ``assoc``, ``chunked``) and RWKV-6-3B
(WKV ``step``, ``chunked``) under every ``remat`` and the production plans,
its FLOPs against the reference's ``analyze_hlo`` and against
``FlopCounterMode`` over the eager step; the lifted scans' losses and
gradients against ``jax.grad``; the dry run's command line on the train
cells (the microbatch split) on one card and on ``pod16x16``; and the
module frontend's ``lower_fn`` GA scoring the ``step`` chromosomes."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._higher_order_ops.scan import generic_scan, scan_op  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode  # noqa: E402

from repro import hlo_analysis as jha  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch.plans import production_plan as jproduction_plan  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import rwkv as JW  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.models.plan import REFERENCE_PLAN as JREFERENCE_PLAN  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim.schedule import make_schedule as jmake_schedule  # noqa: E402
from repro.runtime.train import TrainState as JTrainState  # noqa: E402
from repro.runtime.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import hlo_analysis as ha  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TRAIN_4K, ShapeSpec  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.plans import production_plan  # noqa: E402
from repro_torch.models import REFERENCE_PLAN, build_model  # noqa: E402
from repro_torch.models import rwkv as W  # noqa: E402
from repro_torch.models.layers import remat_safe_scan  # noqa: E402
from repro_torch.models.rglru import LinearRecurrence, rglru_scan  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init, make_schedule  # noqa: E402
from repro_torch.runtime.train import TrainState, make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
JF32 = JREFERENCE_PLAN.replace(compute_dtype="float32")
TRAIN = ShapeSpec("t", 32, 2, "train")
#: the existing parity tests' tolerances (``test_torch_scan_offload.py``)
TOL = {"rglru": {"atol": 1e-5, "rtol": 1e-4},
       "wkv": {"atol": 5e-5, "rtol": 1e-3}}
#: (arch, the plan field the scan form sits in, its forms)
SCANS = [("recurrentgemma_2b", "rglru_impl", ("step", "assoc", "chunked")),
         ("rwkv6_3b", "wkv_impl", ("step", "chunked"))]
MATRIX = [(arch, field, impl, remat) for arch, field, impls in SCANS
          for impl in impls for remat in ("none", "dots", "full")]


def _traced_flops(arch: str, plan) -> float:
    low = dryrun.lower_cell(get_config(arch).reduced(), TRAIN, plan, "cpu")[0]
    return ha.analyze_hlo(low.compile(), 1).flops


def _reference_flops(arch: str, plan) -> float:
    jm = jbuild_model(jget_config(arch).reduced())
    pshapes = jm.param_shapes(dtype=jnp.float32)
    step = jmake_train_step(jm, plan, JOptimizerConfig(),
                            jmake_schedule(total_steps=10_000))
    state = JTrainState(pshapes, jax.eval_shape(jadamw_init, pshapes), None)
    lowered = jax.jit(step).lower(
        state, jm.input_specs(JShapeSpec("t", 32, 2, "train")))
    return jha.analyze_hlo(lowered.compile().as_text(), 1).flops


def _wkv_difference(impl: str, remat: str) -> float:
    """The port's FLOPs less the reference's for reduced RWKV-6-3B (2
    layers, H = 4 heads of D = 16) at B = 2, S = 32, op by op.

    ``step``: the reference writes the state update's outer product
    ``einsum("bhk,bhv->bhkv", k, v)``; XLA transposes it into two
    contractions (dk = dkv . v, dv = k . dkv, 2 D^2 each a head and step)
    and computes the cotangent of the read ``r @ A`` (an outer product of
    r and dy) as a broadcast product.  The port builds kv as a broadcast
    product (its backward a product and a sum, no FLOPs) and autograd's
    ``bmm`` backward forms dA as a (D, 1) @ (1, D) product (2 D^2).  Net:
    the port counts 2 D^2 fewer a (batch, head, step), whatever the remat
    (the forward's one contraction is recomputed on both sides).

    ``chunked``: S = 32 is one chunk (``wkv_chunk`` 64 > S).  XLA runs the
    one-trip loop once and drops what nothing reads: the chunk's
    final-state product k_tail^T @ v (the loss does not read the final
    state) and the gradient of the zero initial state, r_dec^T @ dy.
    Autograd's scan keeps both (a one-trip scan is a scan), each 2 BH D^2 c
    with c = 32, and under remat its recomputed forward holds the first
    once more."""
    layers, b, h, d, s = 2, 2, 4, 16, 32
    if impl == "step":
        return -layers * b * h * s * 2 * d * d
    product = 2 * b * h * d * d * s
    return layers * product * (2 if remat == "none" else 3)


@pytest.mark.parametrize("arch,field,impl,remat", MATRIX)
def test_traced_train_step_flops_match_reference(arch, field, impl, remat):
    """The traced train step of every scan form under every remat holds
    the forward and backward scans and matches the reference's HLO count:
    exactly for RecurrentGemma (stated tolerance 1e-9), and for RWKV-6 once
    :func:`_wkv_difference` (the ops XLA and autograd count apart) is
    added to the reference's count."""
    plan = F32.replace(remat=remat, **{field: impl})
    jplan = JF32.replace(remat=remat, **{field: impl})
    want = _reference_flops(arch, jplan)
    if arch == "rwkv6_3b":
        want += _wkv_difference(impl, remat)
    assert _traced_flops(arch, plan) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_3b"])
def test_production_plan_train_flops_match_reference(arch):
    """The production plans (``assoc`` / ``chunked`` scans, full remat,
    chunked attention and vocab loss, 2 microbatches) at the same recipe,
    stated tolerance 1e-9 after the differences counted op by op: RWKV-6's
    of :func:`_wkv_difference`, and RecurrentGemma's local attention at
    one sequence a microbatch.  There XLA's program holds three (Hq, S, S)
    score products a microbatch where at two sequences (microbatch 1) it
    holds four, as the port holds at either split: the scores Q K^T of
    the forward, of its full-remat recompute and of the chunked
    attention's backward, and dP = dO V^T (2 Hq S^2 Dh = 131,072 FLOPs
    each at Hq 4, S 32, Dh 16).  The port's count does not depend on the
    split, and equals the reference's at microbatch 1."""
    shape = dataclasses.replace(TRAIN_4K, seq_len=32, global_batch=2)
    plan = production_plan(get_config(arch).reduced(), shape)
    jplan = jproduction_plan(jget_config(arch).reduced(),
                             JShapeSpec("train_4k", 32, 2, "train"))
    assert plan.microbatch == jplan.microbatch == 2
    got = _traced_flops(arch, plan)
    assert _traced_flops(arch, plan.replace(microbatch=1)) == got
    want = _reference_flops(arch, jplan)
    if arch == "rwkv6_3b":
        want += _wkv_difference(plan.wkv_impl, plan.remat)
    else:
        score = 2 * 4 * 32 * 32 * 16
        want += plan.microbatch * score
        assert _reference_flops(arch, jplan.replace(microbatch=1)) == got
    assert got == pytest.approx(want, rel=1e-9)


@pytest.fixture
def counted_scans():
    """``FlopCounterMode`` has no rule for ``scan``: for this test it runs
    the scan's loop under the counter, each trip's ops counted."""
    def count(mode, combine_fn, init, xs, consts):
        # the body's own code, not its module call: the counter's module
        # tracker hooks a call, and its operands need no gradient here
        body = getattr(combine_fn, "forward", combine_fn)
        init, xs, consts = ([t.detach() for t in a] for a in (init, xs,
                                                                consts))
        with mode:
            return generic_scan(body, init, xs, additional_inputs=consts)

    scan_op.py_impl(_FlopCounterMode)(count)
    yield
    scan_op.python_key_table.pop(_FlopCounterMode)
    scan_op._dispatch_cache.clear()


@pytest.mark.parametrize("arch,field,impl,remat", [
    ("recurrentgemma_2b", "rglru_impl", "step", "none"),
    ("recurrentgemma_2b", "rglru_impl", "step", "dots"),
    ("recurrentgemma_2b", "rglru_impl", "step", "full"),
    ("rwkv6_3b", "wkv_impl", "chunked", "none"),
    ("rwkv6_3b", "wkv_impl", "chunked", "dots")])
def test_traced_scan_flops_equal_flop_counter_on_the_eager_step(
        counted_scans, arch, field, impl, remat):
    """The traced graph's scans, each body times its trip count, count
    what the eager step runs (``FlopCounterMode`` over the step on meta
    tensors, the scans' loops run trip by trip), recomputation included.
    (RWKV-6's ``step`` form is left out: it hands the parameter ``u``
    itself to its recurrence module, and the counter's module tracker
    cannot hook a leaf inside ``autograd.grad``; the reference matrix
    above counts it.)"""
    cfg = get_config(arch).reduced()
    plan = F32.replace(remat=remat, **{field: impl})
    model = build_model(cfg)
    params = model.param_shapes()
    state = TrainState(params, adamw_init(params), None)
    step = make_train_step(model, plan, OptimizerConfig(),
                           make_schedule(total_steps=10_000))
    with FlopCounterMode(display=False) as fc:
        step(state, model.input_specs(TRAIN))
    assert _traced_flops(arch, plan) == fc.get_total_flops()


# ---------------------------------------------------------------------------
# the lifted scans' gradients
# ---------------------------------------------------------------------------


def _weights(rng, *shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("impl", ["step", "chunked"])
@pytest.mark.parametrize("state", ["nonzero", "zeros"])
def test_rglru_scan_loss_and_gradients_match_jax(impl, state):
    """``rglru_scan``'s states and last state weighted into a loss: the
    loss and its gradients in log_a, b (and a nonzero h0) against
    ``jax.grad`` through the reference's scan.  ``zeros``: the state the
    scan builds itself (needing no gradient), the train step's case."""
    rng = np.random.default_rng(7)
    la = (-np.abs(rng.normal(size=(2, 24, 16))) * 0.3).astype(np.float32)
    b, h0 = _weights(rng, (2, 24, 16), (2, 16))
    wy, wh = _weights(rng, (2, 24, 16), (2, 16))
    if state == "zeros":
        h0 = np.zeros_like(h0)
    ref = {"step": JR._scan_step,
           "chunked": lambda *a: JR._scan_chunked(*a, 8)}[impl]

    def jloss(la, b, h0):
        hs, h = ref(la, b, h0)
        return jnp.sum(hs * wy) + jnp.sum(h * wh)

    argnums = (0, 1, 2) if state == "nonzero" else (0, 1)
    jl, jg = jax.value_and_grad(jloss, argnums)(
        *(jnp.asarray(a) for a in (la, b, h0)))
    args = [torch.tensor(a, requires_grad=True) for a in (la, b, h0)]
    plan = F32.replace(rglru_impl=impl, rglru_chunk=8)
    hs, h = rglru_scan(args[0], args[1],
                       args[2] if state == "nonzero" else None, plan,
                       LinearRecurrence())
    loss = (hs * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
    grads = torch.autograd.grad(loss, args[:len(argnums)])
    np.testing.assert_allclose(float(loss), float(jl), **TOL["rglru"])
    for g, want in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL["rglru"])


@pytest.mark.parametrize("impl", ["step", "chunked"])
@pytest.mark.parametrize("state", ["nonzero", "zeros"])
def test_wkv_scan_loss_and_gradients_match_jax(impl, state):
    """The WKV recurrence (``u`` lifted into the scan's inputs) weighted
    into a loss of its outputs and final state: the loss and its gradients
    in r, k, v, log_w, u (and a nonzero s0) against ``jax.grad`` through
    the reference's ``wkv_step_scan`` / ``wkv_chunked`` (chunk 8 over S =
    24)."""
    rng = np.random.default_rng(8)
    b, s, h, d = 2, 24, 3, 16
    r, k, v = (a * 0.5 for a in _weights(rng, *[(b, s, h, d)] * 3))
    lw = -np.exp(np.clip(rng.normal(size=(b, s, h, d)) - 1.0, -8.0, 2.0))
    lw = lw.astype(np.float32)
    u = _weights(rng, (h, d))[0] * 0.1
    s0 = _weights(rng, (b, h, d, d))[0] * 0.3
    if state == "zeros":
        s0 = np.zeros_like(s0)
    wy, ws = _weights(rng, (b, s, h, d), (b, h, d, d))
    ins = (r, k, v, lw, u, s0)
    ref = {"step": JW.wkv_step_scan,
           "chunked": lambda *a: JW.wkv_chunked(*a, 8)}[impl]

    def jloss(*a):
        y, st = ref(*a)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    argnums = tuple(range(6 if state == "nonzero" else 5))
    jl, jg = jax.value_and_grad(jloss, argnums)(*map(jnp.asarray, ins))
    args = [torch.tensor(a, requires_grad=i in argnums)
            for i, a in enumerate(ins)]
    if impl == "step":
        y, st = W.wkv_step_scan(*args, W.WKVRecurrence())
    else:
        y, st = W.wkv_chunked(*args, 8, W.WKVRecurrence())
    loss = (y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()
    grads = torch.autograd.grad(loss, [args[i] for i in argnums])
    np.testing.assert_allclose(float(loss), float(jl), **TOL["wkv"])
    for g, want in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL["wkv"])


def test_lifted_scan_gradients_equal_an_unrolled_loop():
    """From an initial carry that needs no gradient (torch 2.11 drops such
    a carry from the scan's joint graph and with it the carry's gradient
    between steps): the gradients in xs and the lifted input equal those
    of the same body unrolled, to f32 rounding."""
    g = torch.Generator().manual_seed(3)
    la = (-torch.rand(6, 2, 5, generator=g)).requires_grad_()
    b = torch.randn(6, 2, 5, generator=g, requires_grad=True)
    u = torch.randn(2, 5, generator=g, requires_grad=True)
    h0 = torch.zeros(2, 5)

    def step(h, x, u):
        h = torch.exp(x[0]) * h + x[1] * u
        return h, h.clone()

    h_last, hs = remat_safe_scan(step, h0, (la, b), (u,))
    got = torch.autograd.grad((hs ** 2).sum() + h_last.sum(), [la, b, u])
    h, ys = h0, []
    for t in range(6):
        h, y = step(h, (la[t], b[t]), u)
        ys.append(y)
    want = torch.autograd.grad((torch.stack(ys) ** 2).sum() + h.sum(),
                               [la, b, u])
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_a_cached_partition_gives_the_gradients_of_a_fresh_one():
    """A scan body's partitioned joint graph is traced once for its code
    and operands' metadata: a second call (the cached graph, run on a
    copy) gives the first call's gradients bit for bit, and a call at
    another length traces its own."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(4)
    xs = tuple(torch.randn(3, 6, 8, 16, generator=g) for _ in range(4))
    u = torch.randn(6, 16, generator=g)

    def grads(n):
        args = [t[:n].clone().requires_grad_() for t in xs] \
            + [u.clone().requires_grad_()]
        s_t, y = W.WKVRecurrence()(tuple(args[:4]), args[4],
                                   torch.zeros(6, 16, 16), chunked=True)
        return torch.autograd.grad((y ** 2).sum() + s_t.sum(), args)

    layers._PARTITIONED.clear()
    first = grads(3)
    assert len(layers._PARTITIONED) == 1
    again = grads(3)
    assert len(layers._PARTITIONED) == 1
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    grads(2)
    assert len(layers._PARTITIONED) == 2


def test_a_body_closing_over_a_tensor_is_refused():
    w = torch.ones(3)
    with pytest.raises(ValueError, match="closes over a tensor"):
        remat_safe_scan(lambda h, x: (h * w + x, h.clone()), torch.zeros(3),
                        torch.ones(4, 3))


# ---------------------------------------------------------------------------
# the dry run's train cells: the microbatch split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,microbatch", [("rwkv6_3b", 2),
                                             ("recurrentgemma_2b", 2),
                                             ("olmoe_1b_7b", 4),
                                             ("qwen3_0_6b", 1)])
def test_dryrun_cli_records_the_train_cell_ok(tmp_path, arch, microbatch):
    """The card holds one sequence a microbatch of the production plan;
    Qwen3-0.6B's (one microbatch) record is as before: one sequence."""
    dryrun.main(["--arch", arch, "--shape", "train_4k", "--device", "cpu",
                 "--reduced", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / f"{arch}__train_4k__h100x1__production"
                      ".json").read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["reduced"].startswith(f"global batch 256 -> {microbatch} "
                                     "(one card's share)")
    assert ("microbatches" in rec["reduced"]) == (microbatch > 1)
    assert math.isfinite(rec["roofline"]["step_s"])
    assert rec["memory"]["fits_80gb"] is True


def test_dryrun_cli_records_rwkv_train_on_pod16x16(tmp_path):
    """In a child process (one fake process group a process): RWKV-6's
    train step on the 256-rank mesh, the WKV scans in ``local_map``."""
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rwkv6_3b", "--shape", "train_4k", "--mesh", "pod16x16",
         "--device", "cpu", "--reduced", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    path = tmp_path / "rwkv6_3b__train_4k__pod16x16__production.json"
    assert path.exists(), (res.stdout[-2000:], res.stderr[-3000:])
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256
    assert "2 a data-parallel rank" in rec["reduced"]
    assert rec["collectives"]


@pytest.mark.parametrize("batch", [3, 1])
def test_a_batch_the_microbatches_do_not_split_raises(tmp_path, batch):
    with pytest.raises(ValueError, match="does not split into the plan's 2"):
        dryrun.main(["--arch", "recurrentgemma_2b", "--shape", "train_4k",
                     "--device", "cpu", "--reduced", "--batch", str(batch),
                     "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the module frontend's lower_fn GA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,field", [("recurrentgemma_2b", "rglru_impl"),
                                        ("rwkv6_3b", "wkv_impl")])
def test_lower_fn_ga_scores_step_chromosomes(arch, field):
    """A GA of 2 x 1 on a tiny model's train step, with no pattern record
    to claim the scan site (the default DB's block pass claims it for its
    offloaded form): the baseline chromosome (the reference's ``step``
    scan) lowers and scores a finite time, as does the best one."""
    from repro_torch.core.pattern_db import PatternDB

    cfg = get_config(arch).reduced()
    shape = ShapeSpec("t", 16, 2, "train")
    seen = []

    def lower_fn(plan):
        seen.append(getattr(plan, field))
        return dryrun.lower_cell(cfg, shape, plan, "cpu")[0]

    res = Offloader(OffloadConfig(
        device="cpu", ga=GAConfig(population=2, generations=1, seed=0),
        db=PatternDB([]), options={"lower_fn": lower_fn})).plan(cfg)
    assert "step" in seen
    assert res.baseline.valid and math.isfinite(res.baseline.time_s)
    assert res.best.valid and math.isfinite(res.best.time_s)
    assert res.verification == {"mode": "measured", "verified": True}


def test_a_body_closing_over_an_unhashable_value_is_refused():
    scale = [2.0]
    with pytest.raises(ValueError, match="cannot be hashed"):
        remat_safe_scan(lambda h, x: (h * scale[0] + x, h.clone()),
                        torch.zeros(3), torch.ones(4, 3))
