"""The head-split sites on a mesh, in a child process on a (2, 2) fake
world (``data`` x ``model``), every input replicated: RecurrentGemma's
block-diagonal gates (``rglru._gates``) and its banded local attention
(``attention.attend_local_banded``) run in ``local_map``.

Each pin is the reference's share (whole FLOPs / a rank's) on the same
mesh, as ``tests/test_torch_mesh_parity.py`` reads it from the reference's
XLA program.  The gates split over the batch only: with replicated
operands the reference's partitioner leaves the heads whole on each rank,
whether ``model`` divides them or not.  Banded attention splits over the
whole mesh: by the KV heads where ``model`` divides them, else by chunks
over ``seq_sp`` (2 chunks over 2 ranks here), as the reference's
``constrain`` of its chunk axis does."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import json
    from types import SimpleNamespace

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import hlo_analysis as ha
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.models import OFFLOAD_PLAN
    from repro_torch.models.attention import attend_local_banded
    from repro_torch.models.rglru import _gates
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.pspec import axis_rules

    init_fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = shd.make_rules(mesh)
    plan = OFFLOAD_PLAN.replace(compute_dtype="float32")
    B, S, HD, W = 2, 8, 4, 4

    def flops(fn, shapes):
        plain = ha.analyze_hlo(ha.lower(
            fn, *[torch.empty(s, device="meta") for s in shapes]).gm, 1)
        dts = [DTensor.from_local(torch.empty(s, device="meta"), mesh,
                                  [Replicate(), Replicate()],
                                  run_check=False) for s in shapes]

        def under_rules(*a):
            with axis_rules(rules):
                return fn(*a)

        return [plain.flops,
                ha.analyze_hlo(ha.lower(under_rules, *dts).gm, 4).flops]

    out = {}
    for nh in (4, 3):
        cfg = SimpleNamespace(n_heads=nh)
        out[f"gates_{nh}"] = flops(
            lambda x, wa, wx, ba, bx: _gates(
                x, {"w_a": wa, "w_x": wx, "b_a": ba, "b_x": bx}, cfg),
            [(B, S, nh * HD), (nh, HD, HD), (nh, HD, HD), (nh * HD,),
             (nh * HD,)])
    pos = torch.arange(S, dtype=torch.int32, device="meta")
    for hq, nkv in ((4, 2), (3, 1)):
        out[f"banded_{hq}_{nkv}"] = flops(
            lambda q, k, v: attend_local_banded(q, k, v, pos, pos, W, plan),
            [(B, S, hq, HD), (B, S, nkv, HD), (B, S, nkv, HD)])
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def per_rank():
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    line = next((ln for ln in res.stdout.splitlines()
                 if ln.startswith("RESULT ")), None)
    assert line is not None, (res.stdout[-2000:], res.stderr[-3000:])
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("site,share", [
    ("gates_4", 2),        # 4 heads, replicated operands: heads whole
    ("gates_3", 2),        # 3 heads: every rank projects all of them
    ("banded_4_2", 4),     # 2 KV heads: model divides them
    ("banded_3_1", 4),     # one KV head: the chunks split over seq_sp
])
def test_per_rank_flops_of_a_head_split_site(per_rank, site, share):
    whole, rank = per_rank[site]
    assert whole > 0
    assert rank * share == pytest.approx(whole, rel=1e-12), (site, whole,
                                                              rank)
