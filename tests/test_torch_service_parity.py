"""The port's planning service against the reference's (``repro.service``)
on the same inputs, on the CPU: equal plan records from the ``ir``
frontend under the reference's deterministic fitness, equal service
accounting and store histories over one scripted lifecycle, equal
``exec_plan`` payloads for an architecture config, the reference's
``plan_store.jsonl`` read by the port, an exported program's fingerprint
and warm load in a fresh process, and ``obsreport`` output byte for byte.

Tolerances: records and payloads are compared for equality (floats
included: both packages compute the same deterministic times); the
warm-loaded artifact's output in the child process is bit-equal to the
parent's.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import Evaluation as JEvaluation  # noqa: E402
from repro.core import GAConfig as JGAConfig  # noqa: E402
from repro.core import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.core import Offloader as JOffloader  # noqa: E402
from repro.core import Region as JRegion  # noqa: E402
from repro.core import RegionGraph as JRegionGraph  # noqa: E402
from repro.launch import obsreport as jobsreport  # noqa: E402
from repro import service as jservice  # noqa: E402
from repro_torch import service as tservice  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.frontends.registry import OffloadConfig  # noqa: E402
from repro_torch.core.ga import Evaluation, GAConfig  # noqa: E402
from repro_torch.core.ir import Region, RegionGraph  # noqa: E402
from repro_torch.core.offload import Offloader  # noqa: E402
from repro_torch.launch import obsreport  # noqa: E402
from repro_torch.obs.trace import read_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "_ref_offload_api_suite", ROOT / "tests" / "test_offload_api.py")
_API = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_API)

#: the fields a record carries besides the host (``env``) and the clock
#: (``ts``)
RECORD_FIELDS = ("fingerprint", "frontend", "version", "bits", "sites",
                 "destinations", "pattern", "best_time_s",
                 "baseline_time_s", "verified", "source", "payload", "meta",
                 "front")


def _port_fitness(ref_fitness):
    """The reference's fitness function, returning the port's
    ``Evaluation``."""
    def fitness(values) -> Evaluation:
        ev = ref_fitness(values)
        return Evaluation(tuple(ev.bits), ev.time_s, ev.valid)
    return fitness


def _ir_graphs():
    """The reference's ``_ir_graph`` in both packages."""
    regions = [
        dict(name="outer", kind="loop", trip_count=50),
        dict(name="hot", kind="loop", parent="outer", depth=1,
             uses=frozenset({"a"}), defs=frozenset({"a"}),
             offloadable=True, alternatives=("ref", "kernel"),
             trip_count=10),
        dict(name="mid", kind="loop", uses=frozenset({"b"}),
             defs=frozenset({"b"}), offloadable=True,
             alternatives=("ref", "kernel"), trip_count=4),
        dict(name="cold", kind="loop", uses=frozenset({"c"}),
             defs=frozenset({"c"}), offloadable=True,
             alternatives=("ref", "kernel"), trip_count=2),
    ]
    return (JRegionGraph([JRegion(**r) for r in regions], "ir", "toy"),
            RegionGraph([Region(**r) for r in regions], "ir", "toy"))


def _configs(ref_fitness, population=6, generations=2):
    return (JOffloadConfig(frontend="ir", fitness_fn=ref_fitness,
                           ga=JGAConfig(population=population,
                                        generations=generations, seed=0)),
            OffloadConfig(frontend="ir", fitness_fn=_port_fitness(ref_fitness),
                          ga=GAConfig(population=population,
                                      generations=generations, seed=0)))


def _fields(rec) -> dict:
    return {k: getattr(rec, k) for k in RECORD_FIELDS}


def test_ir_records_equal_the_references(tmp_path):
    jcfg, cfg = _configs(_API._det_fitness)
    jgraph, graph = _ir_graphs()
    recs = []
    for off, g, mod in ((JOffloader(jcfg), jgraph, jservice),
                        (Offloader(cfg), graph, tservice)):
        ctx = off.prepare(g)
        res = off.search(ctx)
        recs.append(mod.record_from_result(res, ctx.fingerprint,
                                           meta={"origin": "cold-search"}))
    jrec, rec = recs
    assert _fields(rec) == _fields(jrec)
    assert rec.verified is False and len(rec.front) == 1
    # the JSONL rows match key for key, env and ts aside
    jrow, row = jrec.to_json(), rec.to_json()
    assert set(row) == set(jrow)
    assert {k: v for k, v in row.items() if k not in ("env", "ts")} \
        == {k: v for k, v in jrow.items() if k not in ("env", "ts")}


def _history(store, fp) -> list:
    return [(r.version, r.bits, r.meta.get("origin")) for r in
            store.history(fp)]


def _lifecycle(mod, cfg, graph, store_dir) -> tuple:
    """plan, plan; restart: plan; tamper env; restart: plan,
    ``refine_once`` under the valley fitness, rollback.  Returns each
    service's stats and the store's history."""
    refine = mod.ServiceConfig(refine_generations=6, refine_population=8)
    stats = []
    with mod.PlanService(store_dir, config=cfg) as svc:
        fp = svc.plan(graph).fingerprint
        svc.plan(graph)
    stats.append(svc.stats.as_dict())
    with mod.PlanService(store_dir, config=cfg) as svc:
        assert svc.plan(graph).warm
    stats.append(svc.stats.as_dict())
    store = mod.PlanStore(store_dir)
    rec = store.load(fp)
    store.put(dataclasses.replace(
        rec, env=dict(rec.env, device_kind="tpu-v99", device_count=4096)))
    with mod.PlanService(store_dir, config=cfg, service=refine) as svc:
        assert not svc.plan(graph).warm
        swapped = svc.refine_once(fp)
        if swapped:
            svc.rollback(fp)
    stats.append(svc.stats.as_dict())
    return fp, swapped, stats, _history(mod.PlanStore(store_dir), fp)


def test_scripted_lifecycle_matches_the_reference_service(tmp_path):
    jcfg, cfg = _configs(_valley, population=2, generations=1)
    jgraph, graph = _ir_graphs()
    jout = _lifecycle(jservice, jcfg, jgraph, str(tmp_path / "ref"))
    out = _lifecycle(tservice, cfg, graph, str(tmp_path / "port"))
    assert out == jout
    fp, swapped, stats, history = out
    assert swapped
    assert [s["searches"] for s in stats] == [1, 0, 1]
    assert stats[2]["env_mismatches"] == 1 and stats[2]["rollbacks"] == 1
    assert [origin for *_, origin in history] == [
        "cold-search", "cold-search", "env-remeasure", "refinement",
        "env-remeasure"]


_TARGET_BITS = (1, 0, 1)


def _valley(values):
    """The reference test's valley fitness (``tests/test_service.py``):
    minimized at a pattern the seeded corners miss."""
    t = 0.5 + 0.2 * sum(int(a != b) for a, b in zip(values, _TARGET_BITS))
    return JEvaluation(tuple(values), t, True)


def test_exec_plan_payloads_equal_the_references(tmp_path):
    payloads = []
    for mod, cfg, arch in (
            (jservice, JOffloadConfig(ga=JGAConfig(population=4,
                                                   generations=1, seed=0)),
             jget_config("qwen3_0_6b")),
            (tservice, OffloadConfig(ga=GAConfig(population=4,
                                                 generations=1, seed=0)),
             get_config("qwen3_0_6b"))):
        with mod.PlanService(str(tmp_path / mod.__name__), config=cfg) as svc:
            plan = svc.plan(arch)
        payloads.append((plan.record.payload, plan.record.bits,
                         plan.record.sites, plan.record.destinations))
    (jpayload, *jcoding, jdests), (payload, *coding, dests) = payloads
    assert payload == jpayload and coding == jcoding
    assert "OFFLOAD_SITES" not in payload["exec_plan"]
    # the kernel destination is named for each package's kernels, so the
    # fingerprints (which fold in the alphabet) differ by design
    assert (jdests, dests) == (("cpu", "gpu_fused", "gpu_pallas"),
                               ("cpu", "gpu_fused", "gpu_kernel"))


def test_reference_store_reads_back_through_the_port(tmp_path):
    jcfg, _ = _configs(_API._det_fitness)
    jgraph, _ = _ir_graphs()
    with jservice.PlanService(str(tmp_path), config=jcfg) as svc:
        fp = svc.plan(jgraph).fingerprint
    jrec = jservice.PlanStore(str(tmp_path)).load(fp)
    rec = tservice.PlanStore(str(tmp_path)).load(fp)
    assert _fields(rec) == _fields(jrec)
    assert (rec.ts, rec.env) == (jrec.ts, jrec.env)
    # measured by another runtime: never a warm load here
    assert "jax_version" in rec.env and not tservice.env_matches(rec.env)


CHILD = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.frontends.registry import OffloadConfig
    from repro_torch.core.ga import GAConfig
    from repro_torch.models.transformer import DenseBlock
    from repro_torch.obs import metrics
    from repro_torch.service import PlanService

    def program():
        gen = torch.Generator().manual_seed(0)
        block = DenseBlock(get_config("qwen3_0_6b").reduced(), device="cpu",
                           generator=gen)
        return block, torch.randn(2, 16, 64, generator=gen)

    def config(x):
        return OffloadConfig(device="cpu", repeats=1,
                             ga=GAConfig(population=4, generations=1, seed=0),
                             options={"example_args": (x,)})

    if __name__ == "__main__":
        store, out = sys.argv[1], sys.argv[2]
        block, x = program()
        with PlanService(store, config=config(x)) as svc:
            plan = svc.plan(block)
        torch.save(plan(x), out)
        snap = metrics.snapshot()
        print(json.dumps({
            "fingerprint": plan.fingerprint, "warm": plan.warm,
            "stats": svc.stats.as_dict(),
            "measurements": sum(s["value"] for s in snap.get(
                "eval.measurements", {}).get("series", ()))}))
""")


def test_exported_program_warm_loads_in_a_fresh_process(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    scope: dict = {"__name__": "child"}
    exec(compile(CHILD, str(script), "exec"), scope)
    block, x = scope["program"]()
    with tservice.PlanService(str(tmp_path / "store"),
                              config=scope["config"](x)) as svc:
        plan = svc.plan(block)
    assert not plan.warm and svc.stats.searches == 1
    want = plan(x)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store"),
         str(tmp_path / "out.pt")], capture_output=True, text=True, env=env,
        timeout=600, check=True)
    got = __import__("json").loads(child.stdout.strip().splitlines()[-1])
    assert got["fingerprint"] == plan.fingerprint
    assert got["warm"] and got["stats"]["warm_loads"] == 1
    assert got["stats"]["searches"] == 0 and got["measurements"] == 0
    np.testing.assert_array_equal(torch.load(tmp_path / "out.pt").numpy(),
                                  want.numpy())


def test_obsreport_renders_like_the_reference(tmp_path, capsys):
    trace = str(tmp_path / "trace.jsonl")
    _, cfg = _configs(_API._det_fitness)
    cfg = dataclasses.replace(cfg, trace=trace)
    _, graph = _ir_graphs()
    with tservice.PlanService(str(tmp_path / "a"), config=cfg) as svc:
        svc.plan(graph)
    with tservice.PlanService(str(tmp_path / "a"), config=cfg) as svc:
        svc.plan(graph)
    spans, metrics = read_trace(trace)
    paths = [s["attrs"].get("path") for s in spans
             if s["name"] == "service.admit"]
    assert paths == ["cold-search", "warm-load"]
    text = obsreport.render(spans, metrics)
    jspans, jmetrics = jobsreport.read_trace(trace)
    assert text == jobsreport.render(jspans, jmetrics)
    assert "service.admit" in text and "coverage:" in text
    assert obsreport.render_metrics(metrics) \
        == jobsreport.render_metrics(metrics)
    outs = []
    for main in (obsreport.main, jobsreport.main):
        assert main([trace]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == text + "\n"
