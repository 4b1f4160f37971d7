"""A rank's train step on a mesh holds its own rows, not the batch.

In a child process on a (2 data, 2 model) fake world, the dry run traces
a reduced RWKV-6's train step (the production plan: two microbatches, full
remat, the chunked WKV) once on one device and once as rank 0 of the mesh:

* no tensor of the rank's graph that has the lerp's five mixes (a dim of
  5) holds more than the rank's rows of the microbatch: the lerp, and its
  weights' gradients, stay on the rank's batch shard;
* the rank's ``live_bytes`` is at most the one-device trace's over the
  ``data`` size, plus the parameters and the two AdamW moments whole;
* the first trace of a rank's program counts what the second does: the
  recorder leaves out the ops DTensor's sharding propagation runs (on
  whole-shape fake tensors, among others) when it first meets an op,
  which a first trace used to count."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import hlo_analysis as ha
    from repro_torch.configs.base import TRAIN_4K, ShapeSpec, get_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.launch.plans import production_plan

    init_fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config("rwkv6_3b").reduced()
    shape = ShapeSpec("train_small", 64, 4, "train")
    plan = production_plan(cfg, TRAIN_4K)

    def live(lowered):
        m = lowered.compile().memory_analysis()
        return (m.argument_size_in_bytes + m.output_size_in_bytes
                + m.temp_size_in_bytes + m.generated_code_size_in_bytes)

    def tensors(gm):
        for node in gm.graph.nodes:
            val = node.meta.get("val")
            if isinstance(val, torch.Tensor):
                yield val
            if node.op == "get_attr":
                sub = getattr(gm, node.target, None)
                if isinstance(sub, torch.fx.GraphModule):
                    yield from tensors(sub)

    one = lower_cell(cfg, shape, plan, device="cpu")[0]
    rank = lower_cell(cfg, shape, plan, device="cpu", mesh=mesh)[0]
    again = lower_cell(cfg, shape, plan, device="cpu", mesh=mesh)[0]
    mixes = [list(t.shape) for t in tensors(rank.gm) if 5 in t.shape]
    print("RESULT " + json.dumps({
        "microbatch": shape.global_batch // plan.microbatch,
        "seq": shape.seq_len, "d": cfg.d_model, "data": 2,
        "param_bytes": 4 * cfg.param_count(),
        "live_one": live(one), "live_rank": live(rank),
        "mixes": mixes,
        "flops": [ha.analyze_hlo(g.gm, 4).flops for g in (rank, again)],
        "bytes": [ha.analyze_hlo(g.gm, 4).bytes for g in (rank, again)]}))
""")


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    line = next((ln for ln in res.stdout.splitlines()
                 if ln.startswith("RESULT ")), None)
    assert line is not None, (res.stdout[-2000:], res.stderr[-3000:])
    return json.loads(line[len("RESULT "):])


def test_no_lerp_tensor_holds_the_whole_batch(traced):
    t = traced
    rows = t["microbatch"] // t["data"]          # the rank's sequences
    own = rows * t["seq"] * 5 * t["d"]           # its (rows, S, 5, d) mix
    assert t["mixes"], t                         # the lerp was traced
    big = [s for s in t["mixes"] if torch.Size(s).numel() > own]
    assert not big, big


def test_rank_live_bytes_are_the_rank_share(traced):
    t = traced
    bound = t["live_one"] / t["data"] + 3 * t["param_bytes"]
    assert 0 < t["live_rank"] <= bound, t


def test_first_rank_trace_equals_the_second(traced):
    assert traced["flops"][0] == traced["flops"][1] > 0, traced
    # the scan's first call partitions its joint graph once, a few small
    # ops of its own that the second call's cache skips
    assert traced["bytes"][0] == pytest.approx(traced["bytes"][1],
                                               rel=1e-3), traced
