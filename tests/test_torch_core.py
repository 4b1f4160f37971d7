"""The port's core (``repro_torch.core``) against the JAX reference
(``repro.core``): the same GA search from the same seed and fitness, equal
region-graph fingerprints, the same verifier verdicts and the same gene
coding for the same graph."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import evaluator as jev  # noqa: E402
from repro.core import ga as jga  # noqa: E402
from repro.core import genes as jgenes  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import verifier as jver  # noqa: E402
from repro_torch.core import evaluator as tev  # noqa: E402
from repro_torch.core import ga as tga  # noqa: E402
from repro_torch.core import genes as tgenes  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core import verifier as tver  # noqa: E402


def _weights_fitness(mod, weights):
    """Deterministic: gene value v at site i adds weights[i] * v."""
    def fit(bits):
        t = 1.0 + sum(w * v for w, v in zip(weights, bits))
        return mod.Evaluation(tuple(bits), max(t, 1e-3), True)
    return fit


@pytest.mark.parametrize("length,arity,seed,gens", [
    (6, 2, 0, 6), (8, 3, 1, 5), (5, 3, 7, 8), (12, 2, 3, 4)])
def test_run_ga_history_identical_smoke_fitness(length, arity, seed, gens):
    cfg = dict(population=8, generations=gens, seed=seed)
    ref = jga.run_ga(length, jev._smoke_fitness_factory(), jga.GAConfig(**cfg),
                     arity=arity)
    got = tga.run_ga(length, tev._smoke_fitness_factory(), tga.GAConfig(**cfg),
                     arity=arity)
    assert got.history == ref.history
    assert got.best.bits == ref.best.bits
    assert got.evaluations == ref.evaluations


@pytest.mark.parametrize("arity,seeds", [(2, ()), (3, ((2, 0, 1, 2, 0, 1, 2),))])
def test_run_ga_history_identical_mixed_fitness(arity, seeds):
    weights = [-0.3, 0.2, -0.1, 0.05, -0.25, 0.4, -0.05]
    cfg = dict(population=10, generations=7, seed=5, patience=3)
    ref = jga.run_ga(7, _weights_fitness(jga, weights), jga.GAConfig(**cfg),
                     arity=arity, seeds=seeds)
    got = tga.run_ga(7, _weights_fitness(tga, weights), tga.GAConfig(**cfg),
                     arity=arity, seeds=seeds)
    assert got.history == ref.history
    assert got.best.bits == ref.best.bits
    assert got.duplicates_avoided == ref.duplicates_avoided


def test_run_ga_history_identical_multi_objective():
    weights = [-0.2, 0.1, -0.3, 0.25, -0.05]

    def objectives(ev):
        return (ev.time_s, float(sum(ev.bits)))

    cfg = dict(population=8, generations=5, seed=2)
    ref = jga.run_ga(5, _weights_fitness(jga, weights), jga.GAConfig(**cfg),
                     arity=3, objective_fn=objectives)
    got = tga.run_ga(5, _weights_fitness(tga, weights), tga.GAConfig(**cfg),
                     arity=3, objective_fn=objectives)
    assert got.history == ref.history
    assert [e.bits for e in got.front] == [e.bits for e in ref.front]


def _regions(mod):
    R = mod.Region
    return [
        R("loop_0", "loop", trip_count=16, defs=frozenset({"a"}),
          uses=frozenset({"x"}), offloadable=True,
          alternatives=("ref", "kernel")),
        R("stmt_1", "stmt", parent="loop_0", depth=1,
          defs=frozenset({"b"}), uses=frozenset({"a", "w"})),
        R("block_2", "block", defs=frozenset({"y"}),
          uses=frozenset({"b", "a"}), callees=("RMSNorm", "mul"),
          offloadable=True, alternatives=("ref", "fused_torch", "cuda"),
          meta={"pattern": "rmsnorm"}),
        R("block_3", "block", defs=frozenset({"z"}), uses=frozenset({"y"}),
          offloadable=True, alternatives=("ref", "kernel")),
    ]


def _twin_graphs():
    return (jir.RegionGraph(_regions(jir), "export", "twin"),
            tir.RegionGraph(_regions(tir), "export", "twin"))


@pytest.mark.parametrize("extra", ["", "args=(2, 64, 64):torch.float32"])
def test_fingerprint_equal_for_twin_graphs(extra):
    jg, tg = _twin_graphs()
    assert tg.fingerprint(extra) == jg.fingerprint(extra)
    tg.regions[0].trip_count = 17
    assert tg.fingerprint(extra) != jg.fingerprint(extra)


def test_fingerprint_equal_for_exported_graph_twin():
    """The port's export graph, rebuilt as reference Regions, hashes the same."""
    from repro_torch.core.frontends.export_frontend import build_graph

    def prog(x, w):
        h = torch.relu(x @ w)
        return (h * h).sum(-1) + x.mean(-1)

    tg = build_graph(prog, torch.ones(4, 8), torch.ones(8, 8), name="prog")
    fields = [f.name for f in dataclasses.fields(tir.Region)]
    jg = jir.RegionGraph([jir.Region(**{f: getattr(r, f) for f in fields})
                          for r in tg.regions], tg.frontend, tg.source_name)
    assert tg.fingerprint("x") == jg.fingerprint("x")


_VERIFY_CASES = [
    (np.ones((3, 4)), np.ones((3, 4)) + 5e-3),
    (np.ones((3, 4)), np.ones((3, 4)) + 5e-2),
    (np.linspace(-2, 2, 12).reshape(3, 4), np.linspace(-2, 2, 12).reshape(3, 4) * 1.009),
    (np.zeros(5), np.full(5, 0.02)),
    (np.ones((2, 2)), np.ones((2, 3))),
    (np.array([1.0, np.inf]), np.array([1.0, np.inf])),
    (np.array([1.0, np.nan]), np.array([1.0, 2.0])),
    ([np.ones(3), np.zeros(2)], [np.ones(3)]),
]


@pytest.mark.parametrize("i", range(len(_VERIFY_CASES)))
def test_verify_verdicts_match(i):
    ref, cand = _VERIFY_CASES[i]
    want = jver.verify(ref, cand)
    to_t = (lambda a: [torch.as_tensor(x) for x in a]) if isinstance(ref, list) \
        else torch.as_tensor
    for got in (tver.verify(ref, cand), tver.verify(to_t(ref), to_t(cand))):
        assert got.ok == want.ok
        assert got.detail == want.detail
        if np.isfinite(want.max_abs):
            assert got.max_abs == pytest.approx(want.max_abs)
            assert got.max_rel == pytest.approx(want.max_rel)


def test_verify_bf16_tensor_against_host_reference():
    x = torch.linspace(-1, 1, 64, dtype=torch.bfloat16)
    ref = x.double().numpy()
    assert tver.verify(ref, x).ok
    assert not tver.verify(ref, x + 0.5).ok


def _wire(name):
    """Destination names map 1:1; slot 2 is the hand kernel in each."""
    return {"gpu_pallas": "gpu_kernel"}.get(name, name)


@pytest.mark.parametrize("alphabet", [
    ("cpu", "gpu"), ("cpu", "gpu", "fpga_stub"),
    ("cpu", "gpu_fused", "gpu_pallas")])
def test_gene_coding_same_for_same_graph(alphabet):
    jg, tg = _twin_graphs()
    jc = jgenes.coding_from_graph(jg, destinations=alphabet)
    tc = tgenes.coding_from_graph(tg, destinations=tuple(map(_wire, alphabet)))
    assert [dataclasses.astuple(s) for s in tc.sites] == \
        [dataclasses.astuple(s) for s in jc.sites]
    assert tc.destinations == tuple(map(_wire, jc.destinations))
    rng = np.random.default_rng(0)
    for _ in range(20):
        bits = tuple(int(v) for v in rng.integers(0, jc.arity, jc.length))
        assert tc.decode(bits) == jc.decode(bits)
        assert tgenes.modeled_cost_s(tg, tc, bits) == \
            jgenes.modeled_cost_s(jg, jc, bits)
        ev = (jga.Evaluation(bits, 0.5, True), tga.Evaluation(bits, 0.5, True))
        assert tobj.objective_values(ev[1], tg, tc) == \
            jobj.objective_values(ev[0], jg, jc)


def test_variant_alphabet_slots_map_one_to_one():
    assert tgenes.VARIANT_ALPHABET == ("cpu", "gpu_fused", "gpu_kernel")
    for j, t in zip(jgenes.VARIANT_ALPHABET, tgenes.VARIANT_ALPHABET):
        assert tgenes.get_destination(t).impl_index == \
            jgenes.get_destination(j).impl_index


def test_probed_device_count_reads_torch_cuda():
    assert tgenes.probed_device_count() == max(1, torch.cuda.device_count())
