"""Mesh destinations in the export engine: a site whose gene places it on
``mesh:<axis>:<n>:<spec>`` runs its own reference nodes on each rank's
shards inside ``local_map`` (``SubstitutionEngine._mesh_adapter``).

* The reference's three cases (``tests/test_substitution.py``), in this
  process at world size 1 (a ``gloo`` group that the fixture tears down):
  n = 1 is a degenerate but genuine mesh and executes; n = 8 is
  unavailable and falls back to the variant with a modeled cost; a span
  with a scalar output is rejected with the reason.
* The reference's mesh GA (``tests/test_multidevice.py``'s
  ``_MESH_GA_SCRIPT``) on 4 ``gloo`` ranks in a child process: the
  alphabet holds ``mesh:data:2:batch`` and ``mesh:data:4:batch``, the
  search executes mesh genes, every rank reaches the same winner, the mesh
  winner matches the single-device output, and the ``PlanStore`` round
  trip rehydrates it."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402

import numpy as np  # noqa: E402
from torch import nn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world1():
    """A world-size-1 gloo group for the test, torn down after it."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    assert not dist.is_initialized()
    M.init_host_group("cpu")
    yield
    M._destination_mesh.cache_clear()
    dist.destroy_process_group()


class _Norm(nn.Module):
    def __init__(self):
        super().__init__()
        from repro_torch.models.layers import RMSNorm
        self.norm = RMSNorm(8)
        with torch.no_grad():
            self.norm.weight.copy_(torch.linspace(-0.5, 0.5, 8))

    def forward(self, x):
        return torch.tanh(self.norm(x)) * 2.0


class _SumNorm(nn.Module):
    def forward(self, x):
        return torch.sum(torch.tanh(x) ** 2) + torch.sum(x * x) * 0.5


class _Scalar(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = _SumNorm()

    def forward(self, x):
        return self.norm(x) * 2.0


def _engine(program, x):
    from repro_torch.core.frontends.export_frontend import (annotate_variants,
                                                            build_graph)
    from repro_torch.core.pattern_db import default_db
    from repro_torch.core.substitution import SubstitutionEngine

    graph = annotate_variants(build_graph(program, x), default_db())
    engine = SubstitutionEngine(None, (x,), graph)
    return engine, engine._sites[0].region


def _x():
    return torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 8)).astype(np.float32))


def test_mesh_destination_executes_span_under_local_map(world1):
    from repro_torch.core.verifier import verify

    program, x = _Norm(), _x()
    engine, region = _engine(program, x)
    sub = engine.substitute({region: "ref"},
                            destinations={region: "mesh:data:1:batch"})
    choice = next(c for c in sub.report.choices if c.region == region)
    assert choice.requested == "mesh:data:1:batch"
    assert choice.chosen == "mesh:data:1:batch"
    assert "local_map over 1xdata" in choice.why
    with torch.no_grad():
        assert verify(program(x), sub(x)).ok
    # memoised per (region, destination)
    assert engine._mesh_adapter(engine._sites[0], _dest("mesh:data:1:batch")) \
        is engine._mesh_resolved[(region, "mesh:data:1:batch")]


def _dest(name):
    from repro_torch.core.genes import get_destination
    return get_destination(name)


def test_mesh_unavailable_falls_back_to_variant_with_reason(world1):
    from repro_torch.core.verifier import verify

    program, x = _Norm(), _x()
    engine, region = _engine(program, x)
    sub = engine.substitute({region: "fused_torch"},
                            destinations={region: "mesh:data:8:batch"})
    choice = next(c for c in sub.report.choices if c.region == region)
    assert choice.requested == "mesh:data:8:batch"
    assert "unavailable" in choice.why and "modeled cost" in choice.why
    assert choice.chosen == "fused_torch"
    with torch.no_grad():
        assert verify(program(x), sub(x)).ok


def test_mesh_shape_rejection_falls_back_with_reason(world1):
    from repro_torch.core.verifier import verify

    program, x = _Scalar(), _x()[:8]
    engine, region = _engine(program, x)
    sub = engine.substitute({region: "ref"},
                            destinations={region: "mesh:data:1:batch"})
    choice = next(c for c in sub.report.choices if c.region == region)
    assert "rejected" in choice.why
    assert "sharded dimension" in choice.why
    assert choice.chosen == "ref"
    with torch.no_grad():
        assert verify(program(x), sub(x)).ok


_MESH_GA = textwrap.dedent('''
    import dataclasses, json, os, sys, tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def app(x, w1, w2):
        h = torch.tanh(x @ w1)
        g = torch.relu(h @ w2)
        y = g * 0.5 + h * 0.1
        return torch.tanh(y @ w1) + y

    def work(rank, world, store_path, out_path):
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        from repro_torch.core.frontends.registry import decoded_pattern
        from repro_torch.core.ga import Evaluation, GAConfig
        from repro_torch.core.genes import probed_device_count
        from repro_torch.core.objectives import OBJECTIVES
        from repro_torch.core.offload import OffloadConfig, Offloader
        from repro_torch.service import PlanStore, record_from_result

        out = {"probed": probed_device_count()}
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
        w1 = torch.from_numpy((rng.normal(size=(64, 64)) * 0.1)
                              .astype(np.float32))
        w2 = torch.from_numpy((rng.normal(size=(64, 64)) * 0.1)
                              .astype(np.float32))
        args = (x, w1, w2)
        ref = app(*args).numpy()
        cfg = OffloadConfig(
            device="cpu",
            ga=GAConfig(population=10, generations=4, seed=0,
                        objectives=OBJECTIVES, compile_workers=0),
            options={"example_args": args}, repeats=1)
        off = Offloader(cfg)
        ctx = off.prepare(app)
        alpha = ctx.coding.destinations
        out["mesh_names"] = [d for d in alpha if d.startswith("mesh:")]
        out["mesh_executed"] = ctx.bundle.mesh_executed
        engine = ctx.bundle.context["engine"]
        coding = ctx.coding
        mesh_ran = set()

        def fitness(values):
            values = tuple(values)
            impl = decoded_pattern(coding, values, {})
            sub = engine.substitute(
                impl, destinations=coding.destinations_of(values))
            got = sub(*args).numpy()
            ok = bool(np.allclose(got, ref, rtol=1e-4, atol=1e-5))
            t = 1.0
            for c in sub.report.choices:
                if c.chosen.startswith("mesh:"):
                    mesh_ran.add(c.chosen)
                    t -= 0.10
                elif c.chosen != "ref":
                    t -= 0.04
            return Evaluation(values, max(t, 0.05), ok)

        ctx.config.fitness_fn = fitness
        res = off.search(ctx)
        out["mesh_ran"] = sorted(mesh_ran)

        def is_mesh(ev):
            return any(n.startswith("mesh:")
                       for n in coding.destinations_of(ev.bits).values())

        front = res.front
        mesh_points = [ev for ev in front if is_mesh(ev)]
        out["front"] = sorted(list(map(int, ev.bits)) for ev in front)
        out["n_mesh_points"] = len(mesh_points)
        out["n_single_points"] = len(front) - len(mesh_points)
        best = min(mesh_points, key=lambda ev: ev.time_s)
        out["winner"] = list(map(int, best.bits))
        art = off.apply(ctx, best.bits)
        with torch.no_grad():
            got = art(*args).numpy()
        out["winner_ok"] = bool(np.allclose(got, ref, rtol=1e-4, atol=1e-5))
        out["winner_why"] = [c.why for c in art.report.choices
                             if c.chosen.startswith("mesh:")]
        rec = record_from_result(res, ctx.fingerprint)
        rec = dataclasses.replace(rec, bits=tuple(best.bits))
        store = PlanStore(tempfile.mkdtemp(prefix="mesh_plan_store_"))
        store.put(rec)
        loaded = store.load(ctx.fingerprint)
        out["stored_meshes"] = sorted(
            d.name for d in loaded.mesh_destinations().values())
        art2 = store.rehydrate(loaded, app, config=cfg)
        with torch.no_grad():
            got2 = art2(*args).numpy()
        out["rehydrated_ok"] = bool(np.allclose(got2, ref, rtol=1e-4,
                                                atol=1e-5))
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        out_path = sys.argv[1]
        mp.spawn(work, args=(4, out_path + ".store", out_path), nprocs=4)
''')


@pytest.fixture(scope="module")
def mesh_ga(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ga")
    script = d / "mesh_ga.py"
    script.write_text(_MESH_GA)
    out = d / "out"
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, str(script), str(out)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    got = []
    for r in range(4):
        p = d / f"out.{r}"
        assert p.exists(), (res.stdout[-2000:], res.stderr[-4000:])
        got.append(json.loads(p.read_text()))
    return got


def test_mesh_ga_proposes_and_executes_the_hosts_meshes(mesh_ga):
    r0 = mesh_ga[0]
    assert r0["probed"] == 4
    assert r0["mesh_names"] == ["mesh:data:2:batch", "mesh:data:4:batch"]
    assert r0["mesh_executed"]
    assert r0["mesh_ran"], "no chromosome ever ran on a mesh"
    assert r0["n_mesh_points"] and r0["n_single_points"], r0["front"]


def test_mesh_ga_ranks_agree_and_the_winner_verifies(mesh_ga):
    for r in mesh_ga[1:]:
        assert r["winner"] == mesh_ga[0]["winner"]
        assert r["front"] == mesh_ga[0]["front"]
    for r in mesh_ga:
        assert r["winner_ok"]
        assert r["winner_why"] and all("local_map" in w
                                       for w in r["winner_why"])


def test_mesh_plan_round_trips_through_the_store(mesh_ga):
    for r in mesh_ga:
        assert r["stored_meshes"]
        assert all(n.startswith("mesh:data:") for n in r["stored_meshes"])
        assert r["rehydrated_ok"]
