"""The dry run on the reference's production meshes (``--mesh pod16x16``
and ``pod2x16x16``), each in its own child process (one fake process
group a process), at the reduced Qwen3-0.6B config on ``train_4k``: the
record is the reference's, every collective's group is an axis of the
mesh, the multi-pod mesh reduces over ``pod``, and each rank holds the
parameters' shards the rules give."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_MESHES  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.pspec import ShardingRules  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE = "qwen3_0_6b", "train_4k"


class StubMesh:
    def __init__(self, shape: dict):
        self.shape = shape


@pytest.fixture(scope="module", params=["pod16x16", "pod2x16x16"])
def record(request, tmp_path_factory):
    mesh = request.param
    out = tmp_path_factory.mktemp(mesh)
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", SHAPE, "--mesh", mesh, "--device", "cpu", "--reduced",
         "--out", str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    path = out / f"{ARCH}__{SHAPE}__{mesh}__production.json"
    assert path.exists(), (res.stdout[-2000:], res.stderr[-3000:])
    return mesh, json.loads(path.read_text())


def _groups(rec) -> list:
    return [int(k.split("@g")[1]) for k in rec["collectives"]]


def test_record_has_the_reference_keys(record):
    mesh, rec = record
    assert rec["status"] == "ok", rec.get("error")
    for key in ("arch", "shape", "mesh", "plan", "status", "memory",
                "roofline", "collectives"):
        assert key in rec
    assert rec["mesh"] == mesh
    assert rec["memory"]["live_bytes"] > 0
    assert rec["n_devices"] == math.prod(PRODUCTION_MESHES[mesh][0])
    assert "450 GB/s" in rec["link_bw_note"]
    assert "a data-parallel rank" in rec["reduced"]


def test_collective_groups_are_mesh_axes(record):
    mesh, rec = record
    groups = _groups(rec)
    assert groups, rec["collectives"]
    assert all(rec["n_devices"] % g == 0 for g in groups), groups
    assert 16 in groups                      # the model or data axis
    if mesh == "pod2x16x16":
        assert 2 in groups                   # the gradient over "pod"
    else:
        assert 2 not in groups


def test_each_rank_holds_the_rules_shards(record):
    mesh, rec = record
    shape, names = PRODUCTION_MESHES[mesh]
    sizes = dict(zip(names, shape))
    cfg = get_config(ARCH).reduced()
    params = build_model(cfg).param_shapes()
    rules = ShardingRules(StubMesh(sizes), shd.logical_table(
        StubMesh(sizes)))
    axes = shd.param_logical_axes(params, cfg, StubMesh(sizes))
    want = 0
    for name, p in params.named_parameters():
        spec = rules.pspec(tuple(p.shape), axes[name])
        shards = math.prod(sizes[a] for e in spec if e is not None
                           for a in ((e,) if isinstance(e, str) else e))
        assert p.numel() % shards == 0, name     # every leaf divides
        want += p.numel() // shards * p.element_size()
    assert rec["memory"]["param_bytes"] == want
    total = sum(p.numel() * p.element_size() for p in params.parameters())
    assert want < total
