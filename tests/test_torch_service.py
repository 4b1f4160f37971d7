"""The port's planning service (``repro_torch.service``) on the CPU: every
test of ``tests/test_service.py`` (PlanStore versioning and round trip,
PlanService admission with same-fingerprint coalescing and
distinct-fingerprint concurrency, background refinement with atomic
hot-swap and rollback, ``Server.from_store`` and ``swap_plan`` under load,
the environment fingerprint, operating points, the TTL sweep), with the
reference's ``jaxpr`` case as the port's ``export`` case (a small module
on the CPU); and the port's repairs: concurrent admissions of one exported
program (the trace lock), measured searches that never time each other,
and the submitting thread's torch state carried to the pool thread.

Tolerances: a stored plan re-applied gives bit-equal outputs; the
python_ast outputs are compared at the reference's rtol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.frontends.registry import OffloadConfig  # noqa: E402
from repro_torch.core.ga import Evaluation, GAConfig  # noqa: E402
from repro_torch.core.ir import Region, RegionGraph  # noqa: E402
from repro_torch.core.offload import Offloader  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.models import REFERENCE_PLAN, build_model  # noqa: E402
from repro_torch.models.layers import RMSNorm  # noqa: E402
from repro_torch.models.plan import ExecPlan  # noqa: E402
from repro_torch.runtime.serve import ServeConfig, Server  # noqa: E402
from repro_torch.service import (PlanMismatchError, PlanService,  # noqa: E402
                                 PlanStore, ServiceConfig,
                                 record_from_result)

PY_SRC = """
def app(a, x, n, iters):
    y = np.zeros((n,))
    for it in range(iters):
        y = y + np.tanh(a @ x) * 0.1
    s = 0.0
    for i in range(n):
        s = s + y[i] * y[i]
    return y, s
"""
PY_CONSTS = {"n": 10, "iters": 8}


def _py_inputs():
    rng = np.random.default_rng(0)
    return dict(a=rng.random((10, 10)), x=rng.random(10))


class NormProj(torch.nn.Module):
    """A norm submodule (the export frontend's one ``rmsnorm`` site) and a
    projection, weights from a seeded generator: two instances are the
    same program with the same weights."""

    def __init__(self, width: int = 16, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.norm = RMSNorm(width)
        self.proj = torch.nn.Linear(width, width)
        with torch.no_grad():
            self.norm.weight.copy_(torch.randn(width, generator=gen) * 0.1)
            self.proj.weight.copy_(torch.randn(width, width, generator=gen)
                                   / width ** 0.5)
            self.proj.bias.zero_()

    def forward(self, x):
        return self.proj(self.norm(x)) * 2.0


def _export_case(width: int = 16):
    x = torch.randn(8, width, generator=torch.Generator().manual_seed(1))
    return (NormProj(width), None,
            {"device": "cpu", "repeats": 1,
             "options": {"example_args": (x,)}})


def _ir_graph():
    # no callees / vectors, so the pattern DB cannot claim any region and
    # the gene covers all three sites
    regions = [
        Region("outer", "loop", trip_count=50),
        Region("hot", "loop", parent="outer", depth=1,
               uses=frozenset({"a"}), defs=frozenset({"a"}),
               offloadable=True, alternatives=("ref", "kernel"),
               trip_count=10),
        Region("mid", "loop", uses=frozenset({"b"}), defs=frozenset({"b"}),
               offloadable=True, alternatives=("ref", "kernel"),
               trip_count=4),
        Region("cold", "loop", uses=frozenset({"c"}), defs=frozenset({"c"}),
               offloadable=True, alternatives=("ref", "kernel"),
               trip_count=2),
    ]
    return RegionGraph(regions, "ir", "toy")


FRONTEND_CASES = {
    "python_ast": lambda: (PY_SRC, _py_inputs(),
                           {"repeats": 1, "device": "cpu",
                            "options": {"consts": PY_CONSTS}}),
    "export": _export_case,
    "module": lambda: (get_config("qwen3_0_6b"), None, {}),
    "ir": lambda: (_ir_graph(), None, {}),
}
ALL_FRONTENDS = sorted(FRONTEND_CASES)


def _det_fitness(values) -> Evaluation:
    # deterministic stand-in verification environment for contracts that
    # need bit-exact reproducibility regardless of wall-clock noise
    t = 1.0 + 0.05 * sum(int(v) * (i + 1) for i, v in enumerate(values))
    return Evaluation(tuple(values), t, True)


def _ir_config(**over):
    ga = over.pop("ga", GAConfig(population=6, generations=2, seed=0))
    over.setdefault("fitness_fn", _det_fitness)
    return OffloadConfig(frontend="ir", ga=ga, **over)


def _tagged_graph(tag):
    g = _ir_graph()
    return RegionGraph(list(g.regions), "ir", f"toy_{tag}")


# ---------------------------------------------------------------------------
# PlanStore: versioning, history, rollback, compaction, mismatch refusal
# ---------------------------------------------------------------------------


def _store_record(tmp_path, bits=(0, 0, 0), **over):
    off = Offloader(_ir_config())
    ctx = off.prepare(_ir_graph())
    res = off.search(ctx)
    rec = record_from_result(res, ctx.fingerprint)
    return ctx, dataclasses.replace(rec, bits=tuple(bits), **over)


def test_store_versions_grow_and_history_is_append_only(tmp_path):
    store = PlanStore(str(tmp_path))
    ctx, rec = _store_record(tmp_path)
    v1 = store.put(rec)
    v2 = store.put(rec)
    assert (v1.version, v2.version) == (1, 2)
    assert store.load(ctx.fingerprint).version == 2
    assert [r.version for r in store.history(ctx.fingerprint)] == [1, 2]
    assert store.fingerprints() == (ctx.fingerprint,)
    # rollback appends the previous version's content as a NEW head
    rb = store.rollback(ctx.fingerprint)
    assert rb.version == 3
    assert rb.meta["rolled_back_from"] == 2
    assert store.load(ctx.fingerprint).version == 3


def test_store_compaction_keeps_newest_history_depth(tmp_path):
    store = PlanStore(str(tmp_path), history_depth=3, max_records=4)
    ctx, rec = _store_record(tmp_path)
    for _ in range(10):
        store.put(rec)
    hist = store.history(ctx.fingerprint)
    assert len(hist) <= 4
    assert hist[-1].version == 10          # newest survives compaction
    assert store.load(ctx.fingerprint).version == 10


def test_store_check_refuses_mismatched_plan_or_coding(tmp_path):
    store = PlanStore(str(tmp_path))
    ctx, rec = _store_record(tmp_path)
    store.check(rec, ctx)                  # matching plan passes
    with pytest.raises(PlanMismatchError):
        store.check(dataclasses.replace(rec, fingerprint="deadbeef"), ctx)
    with pytest.raises(PlanMismatchError):
        store.check(dataclasses.replace(rec, sites=("other",)), ctx)
    # rehydrate without a payload needs the original target
    with pytest.raises(ValueError):
        store.rehydrate(rec)


# ---------------------------------------------------------------------------
# cold search -> persisted plan -> warm load (no GA) across a restart
# ---------------------------------------------------------------------------


def test_cold_search_persists_then_restart_warm_loads(tmp_path):
    cfg = _ir_config()
    with PlanService(str(tmp_path), config=cfg) as svc:
        plan = svc.plan(_ir_graph())
        assert not plan.warm and plan.version == 1
        assert svc.stats.searches == 1 and svc.stats.warm_loads == 0
        assert plan.record.meta["origin"] == "cold-search"
        assert plan.record.meta["evaluations"] > 0
        fp = plan.fingerprint

    # a fresh service on the same directory: pure artifact load, no search
    with PlanService(str(tmp_path), config=cfg) as svc2:
        plan2 = svc2.plan(_ir_graph())
        assert plan2.warm and plan2.fingerprint == fp
        assert plan2.record.bits == plan.record.bits
        assert plan2.record.pattern == plan.record.pattern
        assert svc2.stats.searches == 0 and svc2.stats.warm_loads == 1
        # second request in the same process: served from the live table
        plan3 = svc2.plan(_ir_graph())
        assert plan3 is plan2
        assert svc2.stats.live_hits == 1


# ---------------------------------------------------------------------------
# coalescing: N concurrent requests for one fingerprint -> exactly one search
# ---------------------------------------------------------------------------


def test_same_fingerprint_requests_coalesce_to_one_search(tmp_path):
    started, release = threading.Event(), threading.Event()
    calls: list = []
    calls_lock = threading.Lock()

    def blocking_fitness(values) -> Evaluation:
        with calls_lock:
            calls.append(tuple(values))
        started.set()
        assert release.wait(timeout=60)
        return _det_fitness(values)

    cfg = _ir_config(fitness_fn=blocking_fitness)
    with PlanService(str(tmp_path / "svc"), config=cfg) as svc:
        futs = [svc.submit(_ir_graph())]
        assert started.wait(timeout=60)    # first request is mid-search
        futs += [svc.submit(_ir_graph()) for _ in range(3)]
        release.set()
        plans = [f.result(timeout=120) for f in futs]

    assert svc.stats.requests == 4
    assert svc.stats.searches == 1         # the only admission that searched
    assert svc.stats.coalesced == 3        # everyone else joined it
    assert svc.stats.warm_loads == 0 and svc.stats.live_hits == 0
    assert all(p is plans[0] for p in plans)   # one future fanned out
    assert plans[0].version == 1

    # evidence the GA ran once: the service run measured exactly the same
    # chromosome set as one solo search with the same budget and seed
    solo_calls: list = []

    def counting_fitness(values) -> Evaluation:
        solo_calls.append(tuple(values))
        return _det_fitness(values)

    solo = Offloader(_ir_config(
        fitness_fn=counting_fitness,
        ga=GAConfig(population=6, generations=2, seed=0,
                    cache_dir=str(tmp_path / "solo"))))
    solo.plan(_ir_graph())
    assert sorted(set(calls)) == sorted(set(solo_calls))
    assert len(calls) == len(solo_calls)
    assert plans[0].record.meta["evaluations"] == len(solo_calls)


def test_distinct_fingerprints_plan_concurrently(tmp_path):
    # both searches must reach their first measurement at the same time; a
    # serial service would leave one side waiting at the barrier forever
    barrier = threading.Barrier(2)
    flags = {"a": False, "b": False}

    def fitness_for(tag):
        def fitness(values) -> Evaluation:
            if not flags[tag]:
                flags[tag] = True
                barrier.wait(timeout=60)   # raises BrokenBarrierError if the
            return _det_fitness(values)    # other search never starts
        return fitness

    with PlanService(str(tmp_path), config=_ir_config(),
                     service=ServiceConfig(workers=2)) as svc:
        fa = svc.submit(_tagged_graph("a"),
                        config=_ir_config(fitness_fn=fitness_for("a")))
        fb = svc.submit(_tagged_graph("b"),
                        config=_ir_config(fitness_fn=fitness_for("b")))
        pa, pb = fa.result(timeout=120), fb.result(timeout=120)

    assert pa.fingerprint != pb.fingerprint
    assert svc.stats.searches == 2 and svc.stats.coalesced == 0
    assert len(svc.fingerprints()) == 2


# ---------------------------------------------------------------------------
# store round-trip for every frontend's artifact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL_FRONTENDS)
def test_store_roundtrips_each_frontend_artifact(tmp_path, name):
    target, inputs, kwargs = FRONTEND_CASES[name]()
    cfg = OffloadConfig(ga=GAConfig(population=4, generations=1, seed=0),
                        **kwargs)
    with PlanService(str(tmp_path), config=cfg) as svc:
        cold = svc.plan(target, inputs)
        assert not cold.warm
    assert svc.stats.searches == 1

    target2, inputs2, _ = FRONTEND_CASES[name]()
    with PlanService(str(tmp_path), config=cfg) as svc2:
        warm = svc2.plan(target2, inputs2)
    assert warm.warm, "restart must load the stored plan, not search"
    assert svc2.stats.searches == 0 and svc2.stats.warm_loads == 1
    assert warm.record.bits == cold.record.bits
    assert warm.record.frontend == name
    assert warm.record.pattern == cold.record.pattern

    if name == "module":
        # self-contained payload: the ExecPlan round-trips through JSON
        assert isinstance(warm.artifact, ExecPlan)
        assert warm.artifact == cold.artifact
        assert "exec_plan" in warm.record.payload
    else:
        assert type(warm.artifact) is type(cold.artifact)
    if name == "export":                   # live artifact, re-applied: runs
        x = kwargs["options"]["example_args"][0]
        np.testing.assert_array_equal(warm(x).numpy(), cold(x).numpy())
    if name == "python_ast":
        out_w, out_c = warm.artifact.run(**inputs2), cold.artifact.run(**inputs)
        assert set(out_w) == set(out_c)
        for k in out_w:
            np.testing.assert_allclose(np.asarray(out_w[k], dtype=float),
                                       np.asarray(out_c[k], dtype=float),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# background refinement: strictly-better swap, atomicity, rollback
# ---------------------------------------------------------------------------

_TARGET_BITS = (1, 0, 1)


def _valley_fitness(values) -> Evaluation:
    # minimized at a non-trivial pattern the GA's seeded all-off / all-on
    # population cannot contain, so a tiny cold search deterministically
    # misses it and refinement has a strictly better plan to find
    t = 0.5 + 0.2 * sum(int(a != b) for a, b in zip(values, _TARGET_BITS))
    return Evaluation(tuple(values), t, True)


def test_refinement_hot_swaps_strictly_better_plan_then_rolls_back(tmp_path):
    cfg = _ir_config(fitness_fn=_valley_fitness,
                     ga=GAConfig(population=2, generations=1, seed=0))
    svc = PlanService(str(tmp_path), config=cfg,
                      service=ServiceConfig(refine_generations=6,
                                            refine_population=8))
    with svc:
        plan = svc.plan(_ir_graph())
        fp = plan.fingerprint
        # cold budget only covers the seeded corners: best is all-on
        assert plan.record.bits == (1, 1, 1)
        assert plan.record.best_time_s == pytest.approx(0.7)

        versions: list = []
        errors: list = []
        stop = threading.Event()

        def client():
            try:
                while not stop.is_set():
                    snap = svc.current(fp)   # immutable snapshot: record and
                    versions.append(snap.version)   # artifact always agree
                    assert snap.record.fingerprint == fp
                    assert snap.record.best_time_s == pytest.approx(
                        _valley_fitness(snap.record.bits).time_s)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=client)
        t.start()
        try:
            swapped = svc.refine_once(fp)
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive()
        assert not errors
        assert swapped, "refinement must find the strictly better plan"
        assert versions == sorted(versions), "clients never see a stale " \
            "plan after the swap published the new one"

        cur = svc.current(fp)
        assert cur.record.bits == _TARGET_BITS
        assert cur.record.best_time_s == pytest.approx(0.5)
        assert cur.version == 2
        assert cur.record.meta["origin"] == "refinement"
        assert cur.record.meta["replaced_version"] == 1
        assert svc.stats.refinements == 1 and svc.stats.swaps == 1

        # a further round has nothing strictly better: no swap, no new version
        assert svc.refine_once(fp) is False
        assert svc.current(fp).version == 2

        # rollback re-deploys the replaced plan as a new head version
        restored = svc.rollback(fp)
        assert restored.record.bits == (1, 1, 1)
        assert restored.version == 3
        assert svc.store.load(fp).version == 3
        assert svc.stats.rollbacks == 1


def test_refinement_loop_thread_runs_and_stops(tmp_path):
    cfg = _ir_config(fitness_fn=_valley_fitness,
                     ga=GAConfig(population=2, generations=1, seed=0))
    svc = PlanService(str(tmp_path), config=cfg,
                      service=ServiceConfig(refine_generations=6,
                                            refine_population=8))
    with svc:
        plan = svc.plan(_ir_graph())
        svc.start_refinement(interval_s=0.05)
        deadline = time.monotonic() + 60
        while svc.stats.swaps == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        svc.stop_refinement()
        assert svc.stats.swaps >= 1
        assert svc.current(plan.fingerprint).record.bits == _TARGET_BITS


# ---------------------------------------------------------------------------
# the acceptance lifecycle on a live artifact: clients keep calling through
# the hot-swap, outputs stay correct (allclose vs reference) throughout
# ---------------------------------------------------------------------------


def test_hot_swap_under_load_keeps_outputs_correct(tmp_path):
    target_bits = (1, 0)     # jit the first loop only: not a seeded corner

    def valley(values) -> Evaluation:
        t = 0.5 + 0.2 * sum(int(a != b) for a, b in zip(values, target_bits))
        return Evaluation(tuple(values), t, True)

    cfg = OffloadConfig(frontend="python_ast", fitness_fn=valley, repeats=1,
                        device="cpu",
                        ga=GAConfig(population=2, generations=1, seed=0),
                        options={"consts": PY_CONSTS})
    svc = PlanService(str(tmp_path), config=cfg,
                      service=ServiceConfig(refine_generations=6,
                                            refine_population=8))
    with svc:
        inputs = _py_inputs()
        plan = svc.plan(PY_SRC, inputs)
        fp = plan.fingerprint
        # cold budget only measured the seeded corners — both miss the valley
        assert plan.record.bits in ((0, 0), (1, 1))
        assert plan.record.best_time_s == pytest.approx(0.7)

        # the reference: the all-interpreted program's outputs — every plan
        # must compute the same values, swapped or not
        off = Offloader(cfg)
        reference = off.apply(off.prepare(PY_SRC, inputs),
                              (0, 0)).run(**inputs)
        call = svc.endpoint(fp)

        def check(out):
            assert set(out) == set(reference)
            for k in reference:
                np.testing.assert_allclose(
                    np.asarray(out[k], dtype=float),
                    np.asarray(reference[k], dtype=float), rtol=1e-6)

        check(call(**inputs))

        errors: list = []
        stop = threading.Event()

        def client():
            try:
                while not stop.is_set():
                    check(call(**inputs))   # snapshots current() per call
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=client)
        t.start()
        try:
            swapped = svc.refine_once(fp)
            # the swapped-in plan serves the very next snapshot
            check(call(**inputs))
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive()
        assert not errors, f"client failed across the swap: {errors[:1]}"
        assert swapped, "refinement must find the strictly better plan"
        cur = svc.current(fp)
        assert cur.record.bits == target_bits and cur.version == 2
        assert cur.record.best_time_s == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# serving integration: Server.from_store + swap_plan during generate
# ---------------------------------------------------------------------------


def _generate_hist_count() -> int:
    from repro_torch.obs import metrics as obs_metrics
    fam = obs_metrics.snapshot().get("serve.generate_seconds")
    return sum(s.get("count", 0) for s in fam["series"]) if fam else 0


def test_server_from_store_and_swap_plan_under_generate(tmp_path):
    arch = get_config("qwen3_0_6b")
    with PlanService(str(tmp_path),
                     config=OffloadConfig(
                         ga=GAConfig(population=4, generations=1,
                                     seed=0))) as svc:
        plan = svc.plan(arch)
        fp = plan.fingerprint
    assert isinstance(plan.artifact, ExecPlan)
    assert "exec_plan" in plan.record.payload

    cfg = arch.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticLMDataset(DataConfig(seq_len=32, global_batch=4,
                                         vocab=cfg.vocab, seed=0))
    toks = torch.as_tensor(np.asarray(data.batch(0)["tokens"][:2, :16]))

    # construct straight from the persisted artifact: no planner in the loop
    store = PlanStore(str(tmp_path))
    server = Server.from_store(model, params, store, fp,
                               ServeConfig(max_new_tokens=6))
    assert server.plan == plan.artifact
    hist0 = _generate_hist_count()
    out_stored = server.generate({"tokens": toks})
    assert out_stored.shape == (2, 6)

    with pytest.raises(LookupError):
        Server.from_store(model, params, store, "no-such-fp")

    # expected outputs for each plan (greedy decode is deterministic)
    server.swap_plan(REFERENCE_PLAN)
    assert server.plan == REFERENCE_PLAN
    out_ref = server.generate({"tokens": toks})
    expected = [out_stored, out_ref]

    errors: list = []
    stop = threading.Event()

    def client():
        try:
            while not stop.is_set():
                bound_plan = server.plan          # which plan is current now
                out = server.generate({"tokens": toks})
                # every generation ran ONE complete plan end-to-end: its
                # output matches one of the two plans' expected tokens
                ok = any(np.array_equal(out, exp) for exp in expected)
                assert ok, f"torn generation under swap (plan={bound_plan})"
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=client)
    t.start()
    try:
        for i in range(4):                       # hammer the swap path
            server.swap_plan(plan.artifact if i % 2 == 0 else REFERENCE_PLAN)
            time.sleep(0.05)
        server.swap_plan(plan.artifact)
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive()
    assert not errors, f"generate failed across swaps: {errors[:1]}"
    # post-swap calls serve the new plan
    np.testing.assert_array_equal(server.generate({"tokens": toks}),
                                  out_stored)
    # the per-generate latency histogram lives in the process-wide metrics
    # registry, not on the plan snapshot: five swap_plan calls later it has
    # kept accumulating (>= the 3 deterministic generate calls above)
    assert _generate_hist_count() >= hist0 + 3


# ---------------------------------------------------------------------------
# cross-host plan reuse: a stored plan measured on different hardware is
# re-verified by re-measurement instead of blindly reused
# ---------------------------------------------------------------------------


def test_environment_fingerprint_and_matching():
    from repro_torch.service import env_matches, environment_fingerprint

    env = environment_fingerprint()
    assert set(env) == {"device_kind", "device_count", "cpu_count",
                        "torch_version", "cuda_version"}
    assert env["torch_version"] == torch.__version__
    assert env_matches(env)
    # an empty / missing fingerprint is the unsafe legacy case: mismatch
    assert not env_matches({})
    assert not env_matches({"device_kind": env["device_kind"]})
    foreign = dict(env, device_kind="tpu-v99", device_count=4096)
    assert not env_matches(foreign)
    assert env_matches(foreign, current=foreign)
    # a record the reference wrote (jax_version, no torch_version) never
    # matches: its measurements came from another runtime
    reference_env = {k: env[k] for k in ("device_kind", "device_count",
                                          "cpu_count")}
    assert not env_matches(dict(reference_env, jax_version="0.9.0"))


def test_env_mismatch_remeasures_instead_of_warm_load(tmp_path):
    cfg = _ir_config()
    with PlanService(str(tmp_path), config=cfg) as svc:
        plan = svc.plan(_ir_graph())
        fp = plan.fingerprint
    assert plan.record.env  # searches stamp the host fingerprint

    # tamper: pretend the stored plan was measured on foreign hardware
    store = PlanStore(str(tmp_path))
    rec = store.load(fp)
    store.put(dataclasses.replace(
        rec, env=dict(rec.env, device_kind="tpu-v99", device_count=4096)))

    with PlanService(str(tmp_path), config=cfg) as svc2:
        plan2 = svc2.plan(_ir_graph())
        # the chromosome fits but its measurements are not evidence here:
        # a seeded re-search ran, no blind warm load
        assert not plan2.warm
        assert svc2.stats.env_mismatches == 1
        assert svc2.stats.searches == 1 and svc2.stats.warm_loads == 0
        assert plan2.record.meta["origin"] == "env-remeasure"

    # the re-measured head now carries THIS host's env: warm loads resume
    with PlanService(str(tmp_path), config=cfg) as svc3:
        plan3 = svc3.plan(_ir_graph())
        assert plan3.warm
        assert svc3.stats.env_mismatches == 0 and svc3.stats.searches == 0


def test_pre_env_records_always_remeasure(tmp_path):
    cfg = _ir_config()
    with PlanService(str(tmp_path), config=cfg) as svc:
        fp = svc.plan(_ir_graph()).fingerprint
    store = PlanStore(str(tmp_path))
    store.put(dataclasses.replace(store.load(fp), env={}))   # no env
    with PlanService(str(tmp_path), config=cfg) as svc2:
        plan = svc2.plan(_ir_graph())
        assert not plan.warm and svc2.stats.env_mismatches == 1


# ---------------------------------------------------------------------------
# operating points: the persisted Pareto front is served without a search
# ---------------------------------------------------------------------------


def _mo_ir_config(**over):
    from repro_torch.core.genes import EXTENDED_ALPHABET
    from repro_torch.core.objectives import OBJECTIVES

    def speedup(values) -> Evaluation:
        t = 1.0 - 0.12 * sum(int(v) == 1 for v in values)
        return Evaluation(tuple(values), t, True)

    ga = over.pop("ga", GAConfig(population=8, generations=2, seed=0,
                                 objectives=OBJECTIVES))
    over.setdefault("fitness_fn", speedup)
    over.setdefault("destinations", EXTENDED_ALPHABET)
    return OffloadConfig(frontend="ir", ga=ga, **over)


def test_select_operating_point_swaps_without_search(tmp_path):
    with PlanService(str(tmp_path), config=_mo_ir_config()) as svc:
        plan = svc.plan(_ir_graph())
        fp = plan.fingerprint
        assert len(plan.record.front) >= 2
        searches = svc.stats.searches

        # already latency-optimal (the GA best): a no-op, not a repoint
        lat = svc.select_operating_point(fp, "latency")
        assert lat is plan and svc.stats.repoints == 0

        en = svc.select_operating_point(fp, "energy")
        assert svc.stats.searches == searches, "repoint must not search"
        assert svc.stats.repoints == 1
        assert en.record.bits != lat.record.bits
        assert en.record.meta["origin"] == "operating-point"
        assert en.record.meta["objective"] == "energy"
        assert en.version > lat.version          # persisted as a new head
        assert svc.current(fp) is en
        # the energy point trades latency for joules
        en_pt = min(plan.record.front, key=lambda p: p["energy_j"])
        assert en.record.bits == tuple(en_pt["bits"])
        assert en.record.best_time_s >= lat.record.best_time_s

        # swap back: rollback target retained, still no search
        back = svc.select_operating_point(fp, "latency")
        assert back.record.bits == lat.record.bits
        assert svc.stats.searches == searches and svc.stats.repoints == 2

        with pytest.raises(ValueError):
            svc.select_operating_point(fp, "carbon")
        with pytest.raises(LookupError):
            svc.select_operating_point("no-such-fp")


def test_select_for_traffic_policy(tmp_path):
    svc_cfg = ServiceConfig(busy_hz=2.0)
    with PlanService(str(tmp_path), config=_mo_ir_config(),
                     service=svc_cfg) as svc:
        fp = svc.plan(_ir_graph()).fingerprint
        busy = svc.select_for_traffic(fp, traffic_hz=10.0)
        idle = svc.select_for_traffic(fp, traffic_hz=0.1)
        assert busy.record.bits != idle.record.bits
        assert idle.record.meta["objective"] == "energy"
        # threshold boundary: at busy_hz the latency point serves
        again = svc.select_for_traffic(fp, traffic_hz=2.0)
        assert again.record.bits == busy.record.bits
        # explicit threshold override wins over ServiceConfig
        forced = svc.select_for_traffic(fp, traffic_hz=1.0, busy_hz=0.5)
        assert forced.record.bits == busy.record.bits


def test_single_objective_record_has_no_front_and_keeps_plan(tmp_path):
    with PlanService(str(tmp_path), config=_ir_config()) as svc:
        plan = svc.plan(_ir_graph())
        # single-objective search: a one-point front (the best) persists,
        # so every objective resolves to the deployed plan — no swap
        assert len(plan.record.front) == 1
        # the front's values are plain floats, as the journal writes them
        assert all(type(v) is float for p in plan.record.front
                   for k, v in p.items() if k != "bits")
        same = svc.select_operating_point(plan.fingerprint, "energy")
        assert same.record.bits == plan.record.bits
        assert svc.stats.repoints == 0


def test_server_traffic_hz_tracks_request_rate():
    server = Server.__new__(Server)          # rate window only, no model
    import collections
    server._req_times = collections.deque(maxlen=256)
    assert server.traffic_hz() == 0.0
    now = time.perf_counter()
    server._req_times.extend([now - 0.5, now - 0.2, now - 0.1])
    assert server.traffic_hz(window_s=60.0) == pytest.approx(3 / 60.0)
    assert server.traffic_hz(window_s=0.0) == 0.0
    # requests older than the window age out of the rate
    server._req_times.appendleft(now - 120.0)
    assert server.traffic_hz(window_s=60.0) == pytest.approx(3 / 60.0)


# ---------------------------------------------------------------------------
# TTL eviction: the background refinement loop sweeps the store
# ---------------------------------------------------------------------------


def test_refinement_loop_runs_ttl_sweep(tmp_path):
    cfg = _ir_config()
    with PlanService(str(tmp_path), config=cfg) as seeder:
        fp_live = seeder.plan(_tagged_graph("live")).fingerprint
        fp_stale = seeder.plan(_tagged_graph("stale")).fingerprint

    svc = PlanService(str(tmp_path), config=cfg,
                      service=ServiceConfig(plan_ttl_s=0.2,
                                            refine_generations=1,
                                            refine_population=2))
    with svc:
        svc.plan(_tagged_graph("live"))      # deployed: spared by the sweep
        time.sleep(0.3)                      # both records age past the TTL
        svc.start_refinement(interval_s=0.05)
        deadline = time.monotonic() + 60
        while svc.stats.evictions == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        svc.stop_refinement()
        assert svc.stats.evictions == 1
        assert svc.store.load(fp_stale) is None, "stale plan swept"
        assert svc.store.load(fp_live) is not None, "deployed plan spared"


def test_no_ttl_configured_means_no_sweep(tmp_path):
    svc = PlanService(str(tmp_path), config=_ir_config(),
                      service=ServiceConfig(refine_generations=1,
                                            refine_population=2))
    with svc:
        fp = svc.plan(_ir_graph()).fingerprint
        svc.start_refinement(interval_s=0.05)
        time.sleep(0.3)
        svc.stop_refinement()
        assert svc.stats.evictions == 0
        assert svc.store.load(fp) is not None


def test_store_roundtrips_mesh_destinations(tmp_path):
    # mesh placements are wire names in the alphabet, so a mesh plan rides
    # the JSONL schema unchanged: store -> load -> parsed MeshDestination
    from repro_torch.core.genes import MeshDestination

    alphabet = ("cpu", "gpu", "mesh:data:4:batch")
    off = Offloader(_ir_config(destinations=alphabet))
    ctx = off.prepare(_ir_graph())
    res = off.search(ctx)
    rec = record_from_result(res, ctx.fingerprint)
    mesh_bits = tuple(2 if i == 0 else 0
                      for i in range(len(rec.sites)))
    rec = dataclasses.replace(rec, bits=mesh_bits)

    store = PlanStore(str(tmp_path))
    store.put(rec)
    loaded = store.load(ctx.fingerprint)
    assert loaded.destinations == alphabet
    parsed = loaded.mesh_destinations()
    assert parsed == {rec.sites[0]: MeshDestination(axis="data", n=4)}
    assert parsed[rec.sites[0]].wire() == "mesh:data:4:batch"
    # the stored plan still drives the program: rehydrate checks coding
    # compatibility against the live context (no new search)
    store.check(loaded, ctx)


# ---------------------------------------------------------------------------
# the port's repairs: concurrent traces, serial measured searches, and the
# submitting thread's torch state on the pool thread
# ---------------------------------------------------------------------------


def test_eight_concurrent_exported_submits_coalesce_to_one_search(tmp_path):
    # each submit exports the program on its own thread (Offloader.prepare);
    # torch.export is not thread-safe, so without the trace lock some of
    # these raise.  The search blocks until every submit has returned, so
    # all but the first join it.
    submitted = threading.Event()

    def blocking_fitness(values) -> Evaluation:
        assert submitted.wait(timeout=120)
        return _det_fitness(values)

    target, _, kwargs = _export_case()
    cfg = OffloadConfig(fitness_fn=blocking_fitness,
                        ga=GAConfig(population=4, generations=1, seed=0),
                        **kwargs)
    futs, errors = [None] * 8, []
    start = threading.Barrier(8)

    def client(i):
        try:
            start.wait(timeout=60)
            futs[i] = svc.submit(target)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)            # switch threads often
    try:
        with PlanService(str(tmp_path), config=cfg) as svc:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            submitted.set()
            plans = [f.result(timeout=120) for f in futs if f is not None]
    finally:
        sys.setswitchinterval(interval)
        submitted.set()
    assert not any(t.is_alive() for t in threads)
    assert not errors, f"concurrent submits raised: {errors[:2]}"
    assert len(plans) == 8
    assert svc.stats.requests == 8
    assert svc.stats.searches == 1 and svc.stats.coalesced == 7
    assert all(p is plans[0] for p in plans)
    x = kwargs["options"]["example_args"][0]
    np.testing.assert_array_equal(plans[0](x).numpy(),
                                  Offloader(cfg).apply(
                                      Offloader(cfg).prepare(target),
                                      plans[0].record.bits)(x).numpy())


def _interval_fitness(tag, log, lock, first=None, seconds=0.05):
    """A fitness that records the interval of each call; ``first`` runs
    before the first call."""
    calls = []

    def fitness(values) -> Evaluation:
        if first is not None and not calls:
            first()
        calls.append(values)
        t0 = time.monotonic()
        time.sleep(seconds)
        with lock:
            log.append((tag, t0, time.monotonic()))
        return _det_fitness(values)
    return fitness


def _overlaps(log) -> bool:
    a = [(t0, t1) for tag, t0, t1 in log if tag == "a"]
    b = [(t0, t1) for tag, t0, t1 in log if tag == "b"]
    return any(a0 < b1 and b0 < a1 for a0, a1 in a for b0, b1 in b)


def test_measured_searches_never_overlap_but_ir_searches_do(tmp_path):
    # export's measured bundle is serial_only: its search holds the card
    # for the whole search.  a's first measurement waits until b has been
    # submitted and then (up to 5 s) for b's first measurement, so without
    # the lock both searches would time at once.
    log, lock = [], threading.Lock()
    b_submitted, b_started = threading.Event(), threading.Event()
    ga = GAConfig(population=4, generations=2, seed=0)
    fitness = {
        "a": _interval_fitness(
            "a", log, lock, seconds=0.2,
            first=lambda: (b_submitted.wait(timeout=120),
                           b_started.wait(timeout=5))),
        "b": _interval_fitness("b", log, lock, first=b_started.set)}
    with PlanService(str(tmp_path / "measured"),
                     service=ServiceConfig(workers=2)) as svc:
        futs = []
        for tag, width in (("a", 16), ("b", 24)):
            target, _, kwargs = _export_case(width)
            futs.append(svc.submit(target, config=OffloadConfig(
                fitness_fn=fitness[tag], ga=ga, **kwargs)))
        b_submitted.set()
        pa, pb = (f.result(timeout=300) for f in futs)
    assert pa.fingerprint != pb.fingerprint and svc.stats.searches == 2
    assert {tag for tag, *_ in log} == {"a", "b"}
    assert not _overlaps(log), "two measured searches timed at once"

    # ir searches are not serial_only: they still run side by side
    log.clear()
    barrier = threading.Barrier(2)
    with PlanService(str(tmp_path / "ir"), config=_ir_config(),
                     service=ServiceConfig(workers=2)) as svc:
        fa, fb = (svc.submit(_tagged_graph(tag), config=_ir_config(
            fitness_fn=_interval_fitness(
                tag, log, lock, first=lambda: barrier.wait(timeout=60))))
            for tag in ("a", "b"))
        fa.result(timeout=120), fb.result(timeout=120)
    assert _overlaps(log)


def test_search_on_a_pool_thread_keeps_the_callers_grad_mode(tmp_path):
    seen: list = []

    def recording(values) -> Evaluation:
        seen.append(torch.is_grad_enabled())
        return _det_fitness(values)

    with PlanService(str(tmp_path), config=_ir_config(
            fitness_fn=recording,
            ga=GAConfig(population=2, generations=1, seed=0)),
            service=ServiceConfig(refine_generations=3,
                                  refine_population=8)) as svc:
        with torch.no_grad():
            fut = svc.submit(_ir_graph())
        plan = fut.result(timeout=120)
        assert seen and not any(seen)
        # the refinement round runs under the admitting caller's state too
        seen.clear()
        svc.refine_once(plan.fingerprint)
        assert seen and not any(seen)
