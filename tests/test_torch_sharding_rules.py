"""The port's sharding rules (``repro_torch.runtime.pspec`` and
``runtime.sharding``) against the reference's, one for one.

The rules are pure functions of a mesh's axis sizes, so both packages run
on the reference tests' ``StubMesh`` (an object whose ``.shape`` is a dict
of axis sizes): no device and no process group.  The port's parameters are
per-layer modules where the reference stacks its leaves over the layers;
each port parameter maps to its reference leaf (``reference_path``), gets
the reference's axes less the layer axis, and the same ``PartitionSpec``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ARCH_IDS, ShapeSpec  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.runtime import sharding as ref_shd  # noqa: E402
from repro.runtime.pspec import ShardingRules as RefRules  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.pspec import (ShardingRules,  # noqa: E402
                                       placements_spec, spec_placements)
from torch.distributed.tensor import Replicate, Shard  # noqa: E402


class StubMesh:
    def __init__(self, shape: dict):
        self.shape = shape


MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4})
DECODE = ShapeSpec("d", 64, 2, "decode")
TRAIN = ShapeSpec("t", 64, 2, "train")


def _rules(shape):
    mesh = StubMesh(shape)
    return (ShardingRules(mesh, shd.logical_table(mesh)),
            RefRules(mesh, ref_shd.logical_table(mesh)), mesh)


def _ref_leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_sharding_rules.py), on every mesh
# ---------------------------------------------------------------------------

CASES = [((32000, 2048), ("vocab", "fsdp")),
         ((51865, 768), ("vocab", "fsdp")),
         ((1024, 2048), ("vocab", "tensor")),
         ((256, 128), ("batch", None)), ((8, 128), ("batch", None)),
         ((1, 128), ("batch", None)), ((64, 4096, 8, 128),
                                       ("batch", "kv_seq", None, None)),
         ((3, 5), ("experts", "fsdp")), ((7,), (None,))]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("shape,axes", CASES)
def test_pspec_equals_the_reference(mesh_shape, shape, axes):
    port, ref, _ = _rules(mesh_shape)
    assert port.pspec(shape, axes) == tuple(ref.pspec(shape, axes))
    for name in ("batch", "fsdp", "vocab", "kv_seq", "heads", None):
        for dim in (1, 8, 30, 256, 51865):
            assert port.resolve(name, dim) == ref.resolve(name, dim)


def test_reference_rule_outcomes_hold():
    port, _, _ = _rules({"data": 16, "model": 16})
    assert port.pspec((32000, 2048), ("vocab", "fsdp")) == ("model", "data")
    assert port.pspec((51865, 768), ("vocab", "fsdp")) == (None, "data")
    assert port.pspec((1024, 2048), ("vocab", "tensor")) == ("model", None)
    pod, _, _ = _rules({"pod": 2, "data": 16, "model": 16})
    assert pod.pspec((256, 128), ("batch", None)) == (("pod", "data"), None)
    assert pod.pspec((8, 128), ("batch", None)) == ("pod", None)
    assert pod.pspec((1, 128), ("batch", None)) == (None, None)


# ---------------------------------------------------------------------------
# every parameter, state leaf and batch leaf of the ten configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_and_pspecs_match_the_reference(arch):
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    params = build_model(cfg).param_shapes()
    ref_shapes = ref_build_model(ref_cfg).param_shapes()
    ref_paths = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(
                     ref_shapes)[0]}
    for mesh_shape in MESHES:
        port, ref, mesh = _rules(mesh_shape)
        axes = shd.param_logical_axes(params, cfg, mesh)
        ref_axes = ref_shd.param_logical_axes(ref_shapes, ref_cfg, mesh)
        seen = set()
        for name, p in params.named_parameters():
            path, stacked = shd.reference_path(name, cfg.family)
            assert path in ref_paths, (name, path)
            seen.add(path)
            want = _ref_leaf(ref_axes, path)
            ref_shape = tuple(_ref_leaf(ref_shapes, path).shape)
            if stacked:
                assert ref_shape[1:] == tuple(p.shape), (name, ref_shape)
                want = want[1:]
            else:
                assert ref_shape == tuple(p.shape), (name, ref_shape)
            assert axes[name] == tuple(want), (name, mesh_shape)
            assert port.pspec(tuple(p.shape), axes[name]) == \
                tuple(ref.pspec(tuple(p.shape), tuple(want))), name
        assert seen == ref_paths, sorted(ref_paths ^ seen)


def _ref_state_path(path: str) -> str:
    """A port state path (per-layer lists) -> the reference's (stacked)."""
    return "/".join(k for k in path.split("/") if not k.isdigit())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_and_batch_axes_match_the_reference(arch):
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    model, ref_model = build_model(cfg), ref_build_model(ref_cfg)
    state = model.state_specs(DECODE)
    ref_state = ref_model.state_specs(DECODE)
    paths, leaves, _ = shd._with_paths(state)
    ref_flat = {"/".join(str(getattr(k, "key", k)) for k in p): v
                for p, v in jax.tree_util.tree_flatten_with_path(
                    ref_state)[0]}
    assert {_ref_state_path(p) for p in paths} == set(ref_flat)
    for mesh_shape in MESHES:
        port, ref, mesh = _rules(mesh_shape)
        for path, leaf, ax in zip(paths, leaves, _leaf_axes(state, cfg,
                                                              mesh)):
            ref_leaf = ref_flat[_ref_state_path(path)]
            want = ref_shd._axes_for_state(_ref_state_path(path),
                                           tuple(ref_leaf.shape), ref_cfg,
                                           mesh)
            lead = len(ref_leaf.shape) - leaf.dim()
            assert tuple(ref_leaf.shape)[lead:] == tuple(leaf.shape), path
            assert ax == tuple(want)[lead:], (path, mesh_shape)
            assert port.pspec(tuple(leaf.shape), ax) == \
                tuple(ref.pspec(tuple(leaf.shape), tuple(want)[lead:]))
        batch = model.input_specs(TRAIN)
        ref_batch = ref_model.input_specs(TRAIN)
        b_axes = shd.batch_logical_axes(batch)
        ref_b_axes = ref_shd.batch_logical_axes(ref_batch)
        assert set(batch) == set(ref_batch)
        for k, leaf in batch.items():
            assert b_axes[k] == tuple(ref_b_axes[k])
            assert port.pspec(tuple(leaf.shape), b_axes[k]) == tuple(
                ref.pspec(tuple(ref_batch[k].shape), ref_b_axes[k]))


def _leaf_axes(state, cfg, mesh) -> list:
    axes = shd.state_logical_axes(state, cfg, mesh)
    return torch.utils._pytree.tree_flatten(
        axes, is_leaf=lambda x: isinstance(x, tuple) and all(
            a is None or isinstance(a, str) for a in x))[0]


def test_reference_param_outcomes_hold_on_the_port_names():
    mesh = StubMesh({"data": 16, "model": 16})
    tiny = get_config("tinyllama_1_1b")       # 32 q heads, 4 kv heads
    axes = shd.param_logical_axes(build_model(tiny).param_shapes(), tiny,
                                  mesh)
    assert axes["blocks.0.wq"] == ("fsdp", "tensor")
    assert axes["blocks.0.wk"] == ("fsdp", None)
    assert axes["blocks.0.wo"] == ("tensor", "fsdp")
    olmoe = get_config("olmoe_1b_7b").reduced()
    axes = shd.param_logical_axes(build_model(olmoe).param_shapes(), olmoe,
                                  mesh)
    assert axes["blocks.1.moe.w_gate"] == ("experts", "fsdp", None)
    assert axes["blocks.1.moe.w_down"] == ("experts", None, "fsdp")
    assert axes["blocks.1.moe.router.weight"] == ("fsdp", None)
    assert shd.reference_path("blocks.1.moe.router.weight") == \
        ("blocks/moe/w_router", True)
    assert shd.reference_path("pre_blocks.0.rglru.w_a") == \
        ("pre_blocks/0/rglru/w_a", False)
    assert shd.reference_path("blocks.2.ln1.bias", "ssm") == \
        ("blocks/ln1_b", True)


# ---------------------------------------------------------------------------
# PartitionSpec <-> DTensor placements
# ---------------------------------------------------------------------------


def test_placements_of_a_pspec():
    mesh = StubMesh({"pod": 2, "data": 16, "model": 16})
    rules = ShardingRules(mesh, shd.logical_table(mesh))
    assert rules.placements((256, 4096, 2048), ("batch", None, "tensor")) \
        == [Shard(0), Shard(0), Shard(2)]
    assert rules.placements((8, 128), ("batch", None)) == \
        [Shard(0), Replicate(), Replicate()]
    assert rules.placements((1, 128), ("batch", "vocab")) == \
        [Replicate(), Replicate(), Shard(1)]
    spec = (("pod", "data"), None, "model")
    assert placements_spec(mesh, spec_placements(mesh, spec), 3) == spec
    with pytest.raises(ValueError, match="mesh's order"):
        spec_placements(mesh, (("data", "pod"),))
