"""The port's MoE block (``repro_torch/models/moe.py``) against the JAX
reference's (``repro/models/moe.py``) on the CPU: the router and its
auxiliary losses, ``moe_dense`` and ``moe_scatter`` at a capacity that drops
tokens, many assignments to one expert (where the within-expert ranks, and
so the dropped tokens, come from a stable sort), the decode step's
``cap = 1`` collision, and the shared expert; same numpy inputs from a
seed, f32, tolerance 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import plan as jplan  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import REFERENCE_PLAN  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

F32 = REFERENCE_PLAN.replace(compute_dtype="float32")
JF32 = jplan.REFERENCE_PLAN.replace(compute_dtype="float32")
ATOL = 1e-5


def _cfgs(arch, **moe):
    """The reduced ``arch`` in both packages, its MoE fields replaced."""
    def cfg(base):
        c = base.get_config(arch).reduced()
        return dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
    return cfg(jbase), cfg(tbase)


def _params(jcfg, seed=0):
    """The reference's ``moe_init`` as numpy and as the port's tensors,
    with the port's :class:`~repro_torch.models.moe.Router`."""
    jp = jax.tree_util.tree_map(lambda a: np.array(a),
                                JM.moe_init(jax.random.key(seed), jcfg))
    tp = {k: (torch.from_numpy(v) if not isinstance(v, dict)
              else {n: torch.from_numpy(w) for n, w in v.items()})
          for k, v in jp.items()}
    router = M.Router(torch.nn.Parameter(tp.pop("w_router")),
                      jcfg.moe.top_k)
    return jp, tp, router


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _cap(cfg, t):
    e = cfg.moe
    return int(max(1, (t * e.top_k / e.n_experts) * e.capacity_factor))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_scout_17b_a16e"])
def test_router_and_aux_losses_match_reference(arch):
    jcfg, _ = _cfgs(arch)
    jp, _, router = _params(jcfg)
    x = np.random.default_rng(0).normal(size=(40, jcfg.d_model)) \
        .astype(np.float32)
    with torch.no_grad():
        gates, idx, aux = router(torch.from_numpy(x))
    jgates, jidx, jaux = JM._route(jnp.asarray(x), jp, jcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates, jgates)
    _close(gates.sum(-1), np.ones(40))
    _close(aux.load_balance, jaux.load_balance)
    _close(aux.router_z, jaux.router_z)


@pytest.mark.parametrize("impl", ["dense_onehot", "scatter_ep"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_matches_reference(impl, capacity_factor):
    """Both implementations on a reduced olmoe (4 experts, top-2); at
    capacity factor 0.5 each expert keeps 10 of its ~20 assignments, so
    ``scatter_ep`` drops tokens the way the reference does."""
    jcfg, cfg = _cfgs("olmoe_1b_7b", capacity_factor=capacity_factor)
    jp, tp, router = _params(jcfg)
    x = np.random.default_rng(1).normal(size=(2, 20, jcfg.d_model)) \
        .astype(np.float32)
    plan, jpl = F32.replace(moe_impl=impl), JF32.replace(moe_impl=impl)
    with torch.no_grad():
        y, aux = M.moe_block(torch.from_numpy(x), tp, router, cfg, plan)
    jy, jaux = JM.moe_block(jnp.asarray(x), jp, jcfg, jpl)
    _close(y, jy)
    _close(aux.load_balance, jaux.load_balance)
    _close(aux.router_z, jaux.router_z)
    if impl == "scatter_ep" and capacity_factor < 1:
        full, _ = JM.moe_dense(jnp.asarray(x.reshape(40, -1)), jp, jcfg, JF32)
        assert np.abs(np.asarray(full) - y.reshape(40, -1).numpy()).max() \
            > 1e-3                                    # tokens were dropped


def test_scatter_drops_the_reference_tokens_when_all_pick_one_expert():
    """Every token routes to experts 0 and 1 (a router column per expert
    along one shared direction of x), so each expert has 32 assignments
    and keeps ``cap`` = 8 of them: which 8 depends on the within-expert
    ranks, the reference's stable order."""
    jcfg, cfg = _cfgs("olmoe_1b_7b", capacity_factor=0.5)
    jp, tp, router = _params(jcfg)
    rng = np.random.default_rng(2)
    d = jcfg.d_model
    c = rng.normal(size=d).astype(np.float32)
    c /= np.linalg.norm(c)
    x = (rng.normal(size=(32, d)) * 0.1 + 5.0 * c).astype(np.float32)
    w = np.asarray(jp["w_router"]).copy()
    w += np.outer(c, [4.0, 3.0, -3.0, -4.0]).astype(np.float32)
    jp = dict(jp, w_router=w)
    router.weight.data = torch.from_numpy(w)
    with torch.no_grad():
        _, idx, _ = router(torch.from_numpy(x))
        y, _ = M.moe_scatter(torch.from_numpy(x), tp, router, cfg, F32)
    assert (torch.sort(idx, -1).values == torch.tensor([0, 1])).all()
    assert _cap(cfg, 32) == 8
    jy, _ = JM.moe_scatter(jnp.asarray(x), jp, jcfg, JF32)
    _close(y, jy)
    assert int((y.abs().sum(-1) > 0).sum()) == 8     # 8 tokens per expert,
    assert int((np.abs(np.asarray(jy)).sum(-1) > 0).sum()) == 8  # both kept


def test_decode_step_capacity_of_one_drops_collisions_like_reference():
    """A decode step of batch 4 at olmoe's routing (64 experts, top-8):
    ``cap = int(max(1, 4 * 8 / 64 * 1.25)) = 1``, so of two tokens that
    pick one expert the second drops."""
    jcfg, cfg = _cfgs("olmoe_1b_7b", n_experts=64, top_k=8)
    jp, tp, router = _params(jcfg)
    x = np.random.default_rng(3).normal(size=(4, 1, jcfg.d_model)) \
        .astype(np.float32)
    assert _cap(cfg, 4) == 1
    with torch.no_grad():
        _, idx, _ = router(torch.from_numpy(x.reshape(4, -1)))
        y, _ = M.moe_block(torch.from_numpy(x), tp, router, cfg,
                           F32.replace(moe_impl="scatter_ep"))
    assert len(set(idx.reshape(-1).tolist())) < idx.numel()   # a collision
    jy, _ = JM.moe_block(jnp.asarray(x), jp, jcfg,
                         JF32.replace(moe_impl="scatter_ep"))
    _close(y, jy)


@pytest.mark.parametrize("impl", ["dense_onehot", "scatter_ep"])
def test_shared_expert_matches_reference(impl):
    """llama4-scout's shape: 4 experts (reduced), top-1, one shared expert
    that every token runs through."""
    jcfg, cfg = _cfgs("llama4_scout_17b_a16e")
    assert cfg.moe.n_shared_experts == 1 and cfg.moe.top_k == 1
    jp, tp, router = _params(jcfg)
    assert sorted(tp["shared"]) == ["w_down", "w_gate", "w_up"]
    x = np.random.default_rng(4).normal(size=(2, 12, jcfg.d_model)) \
        .astype(np.float32)
    plan, jpl = F32.replace(moe_impl=impl), JF32.replace(moe_impl=impl)
    with torch.no_grad():
        y, _ = M.moe_block(torch.from_numpy(x), tp, router, cfg, plan)
    jy, _ = JM.moe_block(jnp.asarray(x), jp, jcfg, jpl)
    _close(y, jy)


def test_scatter_repeats_bit_for_bit():
    """No atomics in the dispatch or the combine: two runs give the same
    bits (so a later layer's routing repeats)."""
    jcfg, cfg = _cfgs("olmoe_1b_7b", capacity_factor=0.5)
    _, tp, router = _params(jcfg)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(64, jcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        a, _ = M.moe_scatter(x, tp, router, cfg, F32)
        b, _ = M.moe_scatter(x, tp, router, cfg, F32)
    assert torch.equal(a, b)


def test_moe_init_draws_the_reference_shapes_and_keeps_the_router_f32():
    _, cfg = _cfgs("llama4_scout_17b_a16e")
    moe = M.MoE(cfg, dtype=torch.bfloat16, device="cpu",
                generator=torch.Generator().manual_seed(0)).requires_grad_(
                    False)
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert moe.router.weight.dtype == torch.float32
    assert tuple(moe.router.weight.shape) == (d, e)
    assert tuple(moe.w_gate.shape) == (e, d, ff) \
        and tuple(moe.w_down.shape) == (e, ff, d)
    assert moe.w_up.dtype == torch.bfloat16
    assert tuple(moe.shared["w_gate"].shape) == (d, ff)
    w = moe.w_gate.float() * np.sqrt(d)        # truncated N(0, 1) at +-2
    assert float(w.abs().max()) <= 2.0 + 1e-2
