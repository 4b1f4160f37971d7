"""The port's training step against the JAX reference on the CPU, at
reduced widths in f32, inputs from numpy or ``jax.random`` seeds, weights
(and the reference's gradients) carried across by ``model_from_jax``:

- ``attend_chunked``'s custom backward (the ``_Flash`` autograd Function)
  against ``jax.vjp`` of the reference's ``attend_chunked`` (its ``_flash``
  ``custom_vjp``) on random cotangents: causal and not, a window, ragged
  last chunks, GQA; 1e-5 abs + 1e-4 rel.  The Function keeps only (q, k,
  v, out, logsumexp) for the backward;
- one ``make_train_step`` step for every config of ``ARCH_IDS`` under the
  launcher's plan (block offload over the module frontend, f32, remat
  ``dots``) at small chunks: loss and metrics within 1e-4, every gradient
  leaf within 1e-4 * |g_ref| + 1e-6 (2-norms), the updated parameters
  within 0.05 * lr.

Remat, microbatching and the launcher are in ``test_torch_train_loop.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import copy  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import plan as jplan  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.runtime import train as JR  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.block_offload import block_offload_pass  # noqa: E402
from repro_torch.core.frontends import module_frontend  # noqa: E402
from repro_torch.core.pattern_db import default_db  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.convert import model_from_jax  # noqa: E402
from repro_torch.models.plan import ExecPlan  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.runtime.train import TrainState, make_train_step  # noqa: E402

LR = 1e-3
#: small chunks, so that a 40-token batch takes ragged attention chunks
#: and several scan chunks
SMALL = dict(attn_kv_chunk=16, rglru_chunk=8, wkv_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two intra-op threads: the suite runs several workers a machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _allclose(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def launcher_plans(arch: str, **over) -> tuple:
    """The launcher's plan for ``arch`` (block offload over the module
    frontend's graph; f32, remat ``dots``) in both packages."""
    updates = block_offload_pass(
        module_frontend.build_graph(tbase.get_config(arch)),
        default_db()).plan_updates
    kw = {"compute_dtype": "float32", **SMALL, **updates, **over}
    return ExecPlan(**kw), jplan.ExecPlan(**kw)


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------


FLASH_CASES = {
    # id: (b, sq, sk, hq, hkv, d, causal, window, chunk)
    "causal": (2, 32, 32, 2, 2, 16, True, 0, 8),
    "noncausal_ragged": (1, 24, 40, 2, 2, 16, False, 0, 16),
    "window": (1, 32, 32, 2, 2, 16, True, 8, 8),
    "causal_ragged": (2, 30, 30, 2, 2, 16, True, 0, 16),
    "gqa": (2, 32, 32, 4, 2, 16, True, 0, 8),
    "gqa_noncausal_ragged": (1, 20, 36, 4, 1, 16, False, 0, 16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_vjp_matches_reference(case):
    b, sq, sk, hq, hkv, d, causal, window, ck = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    plan = ExecPlan(compute_dtype="float32", attn_impl="chunked",
                    attn_kv_chunk=ck)
    jp = jplan.ExecPlan(compute_dtype="float32", attn_impl="chunked",
                        attn_kv_chunk=ck)

    def ref(q, k, v):
        return JA.attend_chunked(q, k, v, jnp.arange(sq), jnp.arange(sk),
                                 causal, window, jp)

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = A.attend_chunked(tq, tk, tv, torch.arange(sq), torch.arange(sk),
                           causal, window, plan)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    _allclose(out.detach(), jout, 1e-5, 1e-4)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        _allclose(g, w, 1e-5, 1e-4)


def test_flash_keeps_no_chunk_scores_for_the_backward():
    """What autograd saves through ``attend_chunked`` is (q, k, v, out,
    logsumexp) of the flattened heads: at 8 chunks of 8 keys, plain
    autograd through the loop would keep each chunk's (BH, Sq, 8) scores
    and probabilities, about 3 * BH * Sq * Sk elements."""
    b, s, h, d, ck = 1, 64, 2, 16, 8
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g).requires_grad_()
               for _ in range(3))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    plan = ExecPlan(compute_dtype="float32", attn_impl="chunked",
                    attn_kv_chunk=ck)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = A.attend_chunked(q, k, v, torch.arange(s), torch.arange(s),
                               True, 0, plan)
    bh = b * h
    assert sum(saved) <= 4 * bh * s * d + bh * s, saved
    out.sum().backward()
    assert q.grad is not None and k.grad is not None


# ---------------------------------------------------------------------------
# one train step, every config
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=jbase.ARCH_IDS)
def stepped(request):
    """One train step of ``arch`` (reduced) in both packages from the same
    weights and batch (2 x 40 tokens), at a constant lr."""
    arch = request.param
    jcfg, cfg = jbase.get_config(arch).reduced(), \
        tbase.get_config(arch).reduced()
    plan, jp = launcher_plans(arch)
    jm, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.key(0))
    batch = jm.demo_batch(jax.random.key(1), 2, 40)
    batch = {k: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
             else np.asarray(x) for k, x in batch.items()}
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    tb = {k: _t(x) for k, x in batch.items()}

    jgrads = jax.jit(jax.grad(lambda p: jm.loss(p, jb, jp)[0]))(jparams)
    jstep = jax.jit(JR.make_train_step(jm, jp, JOptimizerConfig(),
                                       lambda s: LR))
    jstate, jmetrics = jstep(JR.init_train_state(jm, jax.random.key(0)), jb)

    params = model_from_jax(_np_tree(jparams), cfg, device="cpu")
    loss, _ = model.loss(params, tb, plan)
    grads = dict(zip([k for k, _ in params.named_parameters()],
                     torch.autograd.grad(loss, list(params.parameters()))))
    state = TrainState(copy.deepcopy(params), adamw_init(params), None)
    state, metrics = make_train_step(model, plan, OptimizerConfig(),
                                     lambda s: LR)(state, tb)
    return dict(cfg=cfg, params=params, grads=grads, state=state,
                metrics=metrics, jgrads=jgrads, jstate=jstate,
                jmetrics=jmetrics)


def test_train_step_metrics_match_reference(stepped):
    m, jm = stepped["metrics"], stepped["jmetrics"]
    assert sorted(m) == sorted(jm)
    for k in ("loss", "ce", "moe_lb", "moe_z"):
        if k in jm:
            assert abs(float(m[k]) - float(jm[k])) < 1e-4, k
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    assert float(m["lr"]) == pytest.approx(LR)
    assert int(stepped["state"].opt.step) == int(stepped["jstate"].opt.step) \
        == 1


def test_train_step_gradients_match_reference(stepped):
    """Every gradient leaf: |g - g_ref| <= 1e-4 |g_ref| + 1e-6 (2-norms),
    the reference's tree renamed onto the port's parameters."""
    cfg = stepped["cfg"]
    want = dict(model_from_jax(_np_tree(stepped["jgrads"]), cfg,
                               device="cpu").named_parameters())
    got = stepped["grads"]
    assert list(got) == list(want)
    for k, g in got.items():
        w = want[k].detach()
        err = float(torch.linalg.vector_norm(g - w))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(w)) + 1e-6, \
            (k, err)


def test_train_step_updated_params_match_reference(stepped):
    """The first AdamW step moves each element by about lr * sign(g): the
    updated parameters agree within 0.05 * lr (an element whose gradient
    is within rounding of 0 may move differently, by g / eps * lr)."""
    cfg = stepped["cfg"]
    want = dict(model_from_jax(_np_tree(stepped["jstate"].params), cfg,
                               device="cpu").named_parameters())
    for k, p in stepped["state"].params.named_parameters():
        _allclose(p.detach(), want[k].detach(), 0.05 * LR, 0)
        mu = stepped["state"].opt.mu[k]
        assert mu.dtype == torch.float32 and mu.shape == p.shape
