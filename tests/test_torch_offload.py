"""The port's main path on the CPU: a Qwen3-0.6B dense block (reduced
widths, GQA) against the JAX reference block, the export frontend's sites,
and ``Offloader.plan`` end to end; plus the package's import boundary."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import dataclasses  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.models.plan import REFERENCE_PLAN  # noqa: E402
from repro_torch.core.frontends.export_frontend import build_graph  # noqa: E402
from repro_torch.core.ga import Evaluation, GAConfig  # noqa: E402
from repro_torch.core.offload import OffloadConfig, Offloader  # noqa: E402
from repro_torch.core.substitution import SubstitutedCallable  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.convert import dense_block_from_jax  # noqa: E402
from repro_torch.models.transformer import DenseBlock  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
#: REFERENCE_PLAN's implementation choices in f32: its default compute dtype
#: (bf16) rounds weights and attention probabilities, which a float32
#: comparison at 1e-4 must not include.
PLAN_F32 = REFERENCE_PLAN.replace(compute_dtype="float32")


@pytest.fixture(scope="module")
def case():
    cfg = dataclasses.replace(get_config("qwen3_0_6b").reduced(), n_kv_heads=2)
    blk = T._dense_block_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = np.random.default_rng(0).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want = np.asarray(T._dense_block_full(jnp.asarray(x), blk, cfg, PLAN_F32,
                                          jnp.arange(S), False, 0)[0])
    block = dense_block_from_jax(jax.tree_util.tree_map(np.asarray, blk), cfg,
                                 device="cpu")
    return cfg, block, torch.from_numpy(x), want


def test_dense_block_matches_jax_block(case):
    cfg, block, x, want = case
    assert cfg.n_heads // cfg.n_kv_heads == 2            # GQA is exercised
    with torch.no_grad():
        got = block(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_export_frontend_finds_attention_and_four_norms(case):
    _, block, x, _ = case
    graph = build_graph(block, x)
    from repro_torch.core.frontends.export_frontend import annotate_variants
    from repro_torch.core.pattern_db import default_db
    annotate_variants(graph, default_db())
    matched = {r.name: r.meta["pattern"] for r in graph.regions
               if r.meta.get("pattern")}
    assert sorted(matched.values()) == ["rmsnorm"] * 4 + ["softmax_attention"]
    by_module = {r.meta["module"]: r.meta.get("pattern")
                 for r in graph.regions}
    assert by_module["attn"] == "softmax_attention"
    for norm in ("ln1", "q_norm", "k_norm", "ln2"):
        assert by_module[norm] == "rmsnorm"
    # the projections, RoPE and the MLP live in the block's own scope and
    # stay unmatched
    root = [r for r in graph.regions if r.meta["module"] == ""]
    assert root and all(r.meta.get("pattern") is None for r in root)
    assert any("silu" in r.callees for r in root)
    for r in graph.regions:
        if r.meta.get("pattern"):
            assert r.alternatives == ("ref", "fused_torch", "cuda")


def _plan(block, x, **ga):
    cfg = OffloadConfig(device="cpu", repeats=1,
                        ga=GAConfig(**{"population": 4, "generations": 2,
                                       "seed": 0, **ga}),
                        options={"example_args": (x,)})
    return Offloader(cfg).plan(block)


def test_offloader_plan_on_cpu_matches_jax_block(case):
    _, block, x, want = case
    res = _plan(block, x)
    assert res.frontend == "export"
    assert res.verification == {"mode": "measured", "verified": True}
    assert isinstance(res.artifact, SubstitutedCallable)
    assert res.coding.destinations == ("cpu", "gpu_fused", "gpu_kernel")
    np.testing.assert_allclose(res.artifact(x).numpy(), want,
                               atol=1e-4, rtol=1e-4)


def test_forced_all_kernel_plan_binds_cuda_at_all_five_sites(case):
    _, block, x, want = case
    res = _plan(block, x, generations=1)
    bits = tuple(2 if r.meta.get("pattern") else 0
                 for r in (res.graph.by_name(s.region)
                           for s in res.coding.sites))
    ctx = Offloader(OffloadConfig(device="cpu",
                                  options={"example_args": (x,)})).prepare(block)
    sub = Offloader().apply(ctx, bits)
    chosen = [c.chosen for c in sub.report.choices if c.pattern]
    assert chosen == ["cuda"] * 5
    ops.reset_launch_counts()
    np.testing.assert_allclose(sub(x).numpy(), want, atol=1e-4, rtol=1e-4)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert ops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                                   "rglru_scan": 0, "wkv6": 0}


def test_first_generation_tries_the_kernel_at_attention_and_norm(case):
    """The seed-0 search the chip run makes (population 8) proposes the
    kernel variant at the attention site and at a norm site in its first
    generation, whatever the timings — so the kernels' launch counters must
    rise on the card."""
    _, block, x, _ = case
    seen = []

    def fitness(bits):
        seen.append(tuple(bits))
        return Evaluation(tuple(bits), 1.0, True)

    cfg = OffloadConfig(device="cpu", fitness_fn=fitness,
                        ga=GAConfig(population=8, generations=1, seed=0),
                        options={"example_args": (x,)})
    res = Offloader(cfg).plan(block)
    patterns = [res.graph.by_name(s.region).meta.get("pattern")
                for s in res.coding.sites]
    kernel_at = {p for bits in seen for p, v in zip(patterns, bits)
                 if v == 2 and p}
    assert kernel_at == {"softmax_attention", "rmsnorm"}


def test_gpu_kernel_variant_rejects_unsupported_head_dim():
    """A head dim the CUDA kernel does not take falls back with a reason."""
    from repro_torch.core.frontends.export_frontend import annotate_variants
    from repro_torch.core.pattern_db import default_db
    from repro_torch.core.substitution import SubstitutionEngine
    from repro_torch.models.attention import Attention

    class Program(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = Attention()

        def forward(self, q, k, v):
            return self.attn(q, k, v) + 1.0

    q, k, v = torch.randn(3, 1, 16, 2, 12).unbind(0)
    graph = annotate_variants(build_graph(Program(), q, k, v), default_db())
    engine = SubstitutionEngine(None, (q, k, v), graph)
    region = next(r.name for r in graph.regions if r.meta.get("pattern"))
    sub = engine.substitute({region: "cuda"})
    assert sub.report.substituted == {}
    assert "multiples of 8" in sub.report.fallbacks[region]
    fused = engine.substitute({region: "fused_torch"})
    assert fused.report.substituted == {region: "fused_torch"}
    assert engine.verify(fused).ok


def test_entry_points_run_on_cuda_unless_cpu_is_asked_for(case):
    cfg, _, x, _ = case
    if torch.cuda.is_available():
        assert DenseBlock(cfg).wq.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DenseBlock(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Offloader(OffloadConfig(options={"example_args": (x,)})).plan(
                DenseBlock(cfg, device="cpu"))


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.add(node.module.split(".")[0])
    return mods


def test_port_never_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
