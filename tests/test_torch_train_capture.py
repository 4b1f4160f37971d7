"""The train steps as the port captures them (``runtime/train.py``'s
``jit_step``, the reference's ``jax.jit(make_train_step(...),
donate_argnums=(0,))``) on the CPU, where a captured call is the plain
in-place step:

- ``make_train_step`` and the donated in-place step run under
  ``HostSyncGuard`` (no host read, no tensor made from host data, no copy
  between host and device, no data-shaped op: what a capture refuses or
  would freeze) for the reduced dense, hybrid (``assoc`` and ``step``),
  MoE, SSM (``chunked``) and enc-dec models, microbatch 1 and 2, remat
  ``none``/``dots``/``full``;
- the guard raises on a schedule that reads the step on the host;
- the donated step returns the input's own moment and step tensors,
  advanced in place to ``make_train_step``'s values;
- gradients are bit-identical whether a checkpoint preserves the RNG
  state or not (``transformer.PRESERVE_RNG_STATE``);
- the slice as a whole: four steps of ``jit_step`` (the launcher's
  helper) from weights carried across by ``model_from_jax`` against four
  steps of the reference's ``jax.jit(make_train_step(...),
  donate_argnums=(0,))`` on the same batches, at a warmup-cosine lr that
  changes every step.

    PYTHONPATH=src python -m pytest tests/test_torch_train_capture.py -q

The card's twins (captured equals eager bit for bit, the backward inside
the graph, a supervised run with a failure, a replaced parameter, a
schedule that reads the step) are in ``tests/test_torch_cuda.py``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import make_schedule as jmake_schedule  # noqa: E402
from repro.runtime import train as JR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.device_program import HostSyncGuard  # noqa: E402
from repro_torch.launch.train import launcher_plan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import model_from_jax  # noqa: E402
from repro_torch.optim import (OptimizerConfig, adamw_init,  # noqa: E402
                               make_schedule)
from repro_torch.runtime.train import (TrainState, in_place_step,  # noqa: E402
                                       init_train_state, jit_step,
                                       make_train_step)
from test_torch_train import LR, SMALL, _allclose, launcher_plans  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two intra-op threads: the suite runs several workers a machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CASES = {
    "dense": ("qwen3_0_6b", {}),
    "hybrid_assoc": ("recurrentgemma_2b", {"rglru_impl": "assoc"}),
    "hybrid_step": ("recurrentgemma_2b", {"rglru_impl": "step"}),
    "moe": ("olmoe_1b_7b", {}),
    "ssm_chunked": ("rwkv6_3b", {"wkv_impl": "chunked"}),
    "encdec": ("whisper_small", {}),
}


@functools.lru_cache(maxsize=None)
def _launcher_plan(arch: str):
    """The launcher's plan of ``arch`` (reduced), once a module: the block
    offload exports the pattern DB's records (~1.5 s)."""
    return launcher_plan(get_config(arch).reduced())[0]


def _setup(case: str, remat: str = "dots", microbatch: int = 1):
    arch, over = CASES[case]
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    plan = _launcher_plan(arch).replace(remat=remat, microbatch=microbatch,
                                        **SMALL, **over)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = model.demo_batch(torch.Generator().manual_seed(1), 2, 16,
                             device="cpu")
    return model, plan, state, batch


def _cosine():
    return make_schedule("cosine", peak_lr=LR, warmup_steps=2, total_steps=4)


def _clone(state: TrainState, model) -> TrainState:
    params = model.param_shapes().to_empty(device="cpu")
    with torch.no_grad():
        for p, q in zip(params.parameters(), state.params.parameters()):
            p.copy_(q)
    opt = state.opt
    return TrainState(params, type(opt)(
        opt.step.clone(), {k: v.clone() for k, v in opt.mu.items()},
        {k: v.clone() for k, v in opt.nu.items()}), None)


# ---------------------------------------------------------------------------
# what a capture refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_run_under_the_host_sync_guard(case, remat, microbatch):
    """A step each of ``make_train_step`` and of the donated in-place step
    at a warmup-cosine lr: nothing a capture refuses, and both give the
    same loss."""
    model, plan, state, batch = _setup(case, remat, microbatch)
    other = _clone(state, model)
    pure = make_train_step(model, plan, OptimizerConfig(), _cosine())
    donated = in_place_step(make_train_step(model, plan, OptimizerConfig(),
                                            _cosine()))
    with HostSyncGuard():
        state, m_pure = pure(state, batch)
        other, m_donated = donated(other, batch)
    assert torch.equal(m_pure["loss"], m_donated["loss"])
    assert int(other.opt.step) == 1


@pytest.mark.parametrize("reads", ["float", "int", "item"])
def test_guard_raises_on_a_schedule_that_reads_the_step_on_the_host(reads):
    """A schedule that turns the step count into a Python number would
    freeze one lr into a captured step: the guard raises on it, as the
    card's capture does."""
    read = {"float": float, "int": int, "item": lambda s: s.item()}[reads]
    model, plan, state, batch = _setup("dense", "none")
    step = jit_step(make_train_step(
        model, plan, OptimizerConfig(),
        lambda s: LR * min(1.0, (read(s) + 1) / 10)))
    with HostSyncGuard(), pytest.raises(RuntimeError, match="host read"):
        step(state, batch)


def test_donated_step_advances_the_input_state_in_place():
    """``jit_step`` on the CPU is the plain in-place step: the returned
    state's moments and step are the input's own tensors, holding the
    values ``make_train_step`` returns in new ones; nothing is captured."""
    model, plan, state, batch = _setup("hybrid_step")
    other = _clone(state, model)
    want, want_m = make_train_step(model, plan, OptimizerConfig(),
                                   _cosine())(other, batch)
    step = jit_step(make_train_step(model, plan, OptimizerConfig(),
                                    _cosine()))
    ids = [id(t) for t in (state.opt.step, *state.opt.mu.values(),
                           *state.opt.nu.values())]
    got, got_m = step(state, batch)
    assert step.programs == {}
    assert got.params is state.params
    assert [id(t) for t in (got.opt.step, *got.opt.mu.values(),
                            *got.opt.nu.values())] == ids
    assert int(got.opt.step) == 1
    assert torch.equal(got_m["loss"], want_m["loss"])
    for k in want.opt.mu:
        assert torch.equal(got.opt.mu[k], want.opt.mu[k]), k
        assert torch.equal(got.opt.nu[k], want.opt.nu[k]), k
    for p, q in zip(got.params.parameters(), want.params.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("case", ["dense", "hybrid_step", "ssm_chunked"])
def test_gradients_identical_across_preserve_rng_state(case, remat,
                                                       monkeypatch):
    """No layer draws random numbers: a checkpoint that stashes and
    restores the RNG states for its recompute gives the gradients that one
    which does not (the port's default, which a capture needs) gives, bit
    for bit."""
    model, plan, state, batch = _setup(case, remat)
    grads = {}
    for flag in (True, False):
        monkeypatch.setattr(transformer, "PRESERVE_RNG_STATE", flag)
        loss, _ = model.loss(state.params, batch, plan)
        grads[flag] = torch.autograd.grad(loss,
                                          list(state.params.parameters()))
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the slice as a whole: the launcher's jitted step against the reference's
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["qwen3_0_6b"])
def test_jitted_steps_match_the_reference_over_four_steps(arch):
    """Four steps of ``jit_step(make_train_step(...))`` from the
    reference's weights (``model_from_jax``) against four steps of the
    reference's ``jax.jit(make_train_step(...), donate_argnums=(0,))`` on
    the same batches, at a warmup-cosine lr (0, lr / 2, lr, 0.55 lr):
    losses within 1e-5 relative, the lr each step applied equal, and the
    parameters after each step within ``test_torch_train``'s 0.05 * lr."""
    jcfg, cfg = jbase.get_config(arch).reduced(), get_config(arch).reduced()
    plan, jp = launcher_plans(arch)
    jm, model = jbuild_model(jcfg), build_model(cfg)
    jsched = jmake_schedule("cosine", peak_lr=LR, warmup_steps=2,
                            total_steps=4)
    jstep = jax.jit(JR.make_train_step(jm, jp, JOptimizerConfig(lr=LR),
                                       jsched), donate_argnums=(0,))
    jstate = JR.init_train_state(jm, jax.random.key(0))
    params = model_from_jax(_np_tree(jstate.params), cfg, device="cpu")
    state = TrainState(params, adamw_init(params), None)
    step = jit_step(make_train_step(model, plan, OptimizerConfig(lr=LR),
                                    _cosine()))
    lrs = []
    for i in range(4):
        batch = jm.demo_batch(jax.random.key(10 + i), 2, 40)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        tb = {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}
        jstate, jmetrics = jstep(jstate, jb)
        state, metrics = step(state, tb)
        assert float(metrics["loss"]) == pytest.approx(
            float(jmetrics["loss"]), rel=1e-5), i
        assert float(metrics["lr"]) == pytest.approx(float(jmetrics["lr"]),
                                                     rel=1e-6), i
        lrs.append(float(metrics["lr"]))
        want = dict(model_from_jax(_np_tree(jstate.params), cfg,
                                   device="cpu").named_parameters())
        for k, p in state.params.named_parameters():
            _allclose(p.detach(), want[k].detach(), 0.05 * LR, 0)
    assert len(set(lrs)) == 4 and lrs[0] == 0.0
    assert int(state.opt.step) == int(jstate.opt.step) == 4
