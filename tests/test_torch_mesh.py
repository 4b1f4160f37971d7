"""The port's meshes (``repro_torch.launch.mesh``) and the cost analyzer's
collective group sizes, each in a child process: a process holds one
default process group, and a fake one (the production meshes') cannot
live beside a real one.

* a world-size-1 ``gloo`` host mesh: its shape, ``make_destination_mesh``
  at 1 (works) and 8 (raises), and the sharded train step
  (``jit_train_step``) on that (1, 1) mesh against ``make_train_step``;
* a (2, 4) mesh on an 8-rank fake world: an all-reduce over ``model`` is
  charged its group of 4, an all-reduce over ``data`` its group of 2,
  not the world's 8."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HOST = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import (make_destination_mesh,
                                         make_host_mesh)
    from repro_torch.configs.base import get_config
    from repro_torch.models import OFFLOAD_PLAN, build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train import (init_train_state, jit_train_step,
                                           make_train_step, state_shardings)
    from repro_torch.core.genes import probed_device_count

    out = {}
    try:
        make_host_mesh()
    except RuntimeError as e:
        out["cuda_refused"] = "CUDA" in str(e)
    mesh = make_host_mesh(device="cpu")
    out["backend"] = dist.get_backend()
    out["shape"] = list(mesh.shape)
    out["names"] = list(mesh.mesh_dim_names)
    out["probed"] = probed_device_count()
    d1 = make_destination_mesh(1, "data", "cpu")
    out["dest1"] = [list(d1.shape), list(d1.mesh_dim_names)]
    out["dest1_cached"] = make_destination_mesh(1, "data", "cpu") is d1
    try:
        make_destination_mesh(8, "data", "cpu")
    except ValueError as e:
        out["dest8"] = str(e)

    cfg = get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    plan = OFFLOAD_PLAN.replace(attn_kv_chunk=16, loss_vocab_chunk=64,
                                compute_dtype="float32")
    batch = model.demo_batch(torch.Generator().manual_seed(1), 2, 32,
                             device="cpu")
    rules = shd.make_rules(mesh)
    sched = lambda step: 1e-3
    plain = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    sharded = init_train_state(model, torch.Generator().manual_seed(0),
                               device="cpu")
    step = make_train_step(model, plan, OptimizerConfig(), sched)
    sstep = jit_train_step(model, plan, OptimizerConfig(), sched, rules,
                           state_shardings(sharded, rules, cfg))
    losses, diffs = [], []
    for _ in range(2):
        plain, m0 = step(plain, batch)
        sharded, m1 = sstep(sharded, batch)
        losses.append([float(m0["loss"]), float(m1["loss"].full_tensor())])
    for (n, p), (_, q) in zip(plain.params.named_parameters(),
                              sharded.params.named_parameters()):
        diffs.append(float((p.detach() - q.detach().full_tensor())
                           .abs().max()))
    out["losses"] = losses
    out["max_param_diff"] = max(diffs)
    out["dtensor_params"] = all(type(p).__name__ == "DTensor"
                                for p in sharded.params.parameters())
    out["moment_placements"] = str(sharded.opt.mu["blocks.0.wq"].placements)
    out["param_placements"] = str(sharded.params.blocks[0].wq.placements)
    print("RESULT " + json.dumps(out))
""")

_FAKE = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import DTensor, Partial, Shard, Replicate
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch import hlo_analysis as ha

    init_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    local = torch.empty(16, 32, device="meta")
    x = DTensor.from_local(local, mesh, [Shard(0), Partial()],
                           run_check=False)
    y = DTensor.from_local(local, mesh, [Partial(), Replicate()],
                           run_check=False)

    def fn(a, b):
        return (a.redistribute(mesh, [Shard(0), Replicate()]),
                b.redistribute(mesh, [Replicate(), Replicate()]))

    cost = ha.analyze_hlo(ha.lower(fn, x, y).gm, 8)
    print("RESULT " + json.dumps(sorted(
        [op, g] for op, rb, g, lb, m in cost.collectives)))
""")


def _run(script: str, timeout: int) -> dict:
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    line = next((ln for ln in res.stdout.splitlines()
                 if ln.startswith("RESULT ")), None)
    assert line is not None, (res.stdout[-2000:], res.stderr[-3000:])
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def host():
    return _run(_HOST, 300)


def test_host_mesh_is_the_default_groups_ranks(host):
    assert host["backend"] == "gloo"
    assert host["shape"] == [1, 1]
    assert host["names"] == ["data", "model"]
    assert host["probed"] == 1
    if not torch.cuda.is_available():
        assert host["cuda_refused"]           # never a CPU mesh for cuda


def test_destination_mesh_needs_the_ranks(host):
    assert host["dest1"] == [[1], ["data"]]
    assert host["dest1_cached"]
    assert "wants 8 devices, host has 1" in host["dest8"]


def test_sharded_step_on_a_one_rank_mesh_matches_the_plain_step(host):
    assert host["dtensor_params"]
    # the AdamW moments take their parameter's placements
    assert host["moment_placements"] == host["param_placements"]
    for plain, sharded in host["losses"]:
        assert abs(plain - sharded) <= 1e-5, host["losses"]
    assert host["max_param_diff"] <= 1e-5


def test_collectives_are_charged_their_group_size():
    got = _run(_FAKE, 300)
    assert ["all-reduce", 4] in got, got       # over "model" (4 ranks)
    assert ["all-reduce", 2] in got, got       # over "data" (2 ranks)
    assert all(g in (2, 4) for _, g in got), got
