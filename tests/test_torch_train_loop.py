"""The port's training loop on the CPU at reduced widths: gradients
bit-identical across remat ``none``/``dots``/``full`` (the RG-LRU's
``step`` and RWKV's scans included), microbatch 2 against 1 (the loss and
gradient norm within 1e-5 relative, the updated parameters within 0.05 *
lr), the export frontend's sites of a reduced prefill unchanged under
``remat="dots"``, the entry points' default device, and the launcher's
``_run`` with ``--device cpu``: the loss falls over 20 steps and
``--resume`` replays the last checkpoint's steps with the same losses."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.frontends.export_frontend import (  # noqa: E402
    annotate_variants, build_graph)
from repro_torch.core.pattern_db import default_db  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.plan import ExecPlan  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.runtime.train import init_train_state, make_train_step  # noqa: E402
from test_torch_train import LR, _allclose, launcher_plans  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two intra-op threads: the suite runs several workers a machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# remat, microbatching, the planned graphs
# ---------------------------------------------------------------------------


REMAT_CASES = {
    "dense": ("qwen3_0_6b", {}),
    "moe": ("olmoe_1b_7b", {}),
    "hybrid_assoc": ("recurrentgemma_2b", {"rglru_impl": "chunked"}),
    "hybrid_step": ("recurrentgemma_2b", {"rglru_impl": "step"}),
    "ssm_chunked": ("rwkv6_3b", {"wkv_impl": "chunked"}),
    "encdec": ("whisper_small", {}),
}


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_gradients_identical_across_remat(case, remat):
    arch, over = REMAT_CASES[case]
    cfg = tbase.get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = model.demo_batch(torch.Generator().manual_seed(1), 2, 40,
                             device="cpu")
    batch = {k: x.float() if x.is_floating_point() else x
             for k, x in batch.items()}
    grads = {}
    for mode in ("none", remat):
        plan, _ = launcher_plans(arch, remat=mode, **over)
        loss, _ = model.loss(params, batch, plan)
        grads[mode] = torch.autograd.grad(loss, list(params.parameters()))
    for g0, g1 in zip(grads["none"], grads[remat]):
        assert torch.equal(g0, g1)


def test_microbatch_2_matches_microbatch_1():
    cfg = tbase.get_config("qwen3_0_6b").reduced()
    model = build_model(cfg)
    batch = model.demo_batch(torch.Generator().manual_seed(1), 4, 32,
                             device="cpu")
    out = {}
    for mb in (1, 2):
        plan, _ = launcher_plans("qwen3_0_6b", microbatch=mb)
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 device="cpu")
        state, metrics = make_train_step(model, plan, OptimizerConfig(),
                                         lambda s: LR)(state, batch)
        out[mb] = (state, metrics)
    (s1, m1), (s2, m2) = out[1], out[2]
    for k in ("loss", "ce", "grad_norm"):
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=1e-5), k
    for (k, p1), p2 in zip(s1.params.named_parameters(),
                           s2.params.parameters()):
        _allclose(p2.detach(), p1.detach(), 0.05 * LR, 0)
        _allclose(s2.opt.mu[k], s1.opt.mu[k], 1e-7, 1e-4)


@pytest.mark.parametrize("arch,over", [("qwen3_0_6b", {}),
                                       ("recurrentgemma_2b",
                                        {"rglru_impl": "step"})])
def test_planned_prefill_sites_unchanged_under_remat_dots(arch, over):
    """The export frontend exports without autograd, where ``_maybe_remat``
    leaves the layers as they are: the regions and matched sites of a
    reduced prefill are the same under ``remat="dots"`` as under
    ``"none"``, with autograd on in the caller."""
    cfg = tbase.get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 16),
                           generator=torch.Generator().manual_seed(1))
    sites = {}
    assert torch.is_grad_enabled()
    for remat in ("none", "dots"):
        plan = ExecPlan(compute_dtype="float32", remat=remat, **over)
        graph = annotate_variants(build_graph(
            lambda tok: model.prefill(params, {"tokens": tok}, plan),
            tokens), default_db())
        sites[remat] = [(r.name, r.kind, r.meta.get("pattern"))
                        for r in graph.regions]
    assert sites["dots"] == sites["none"]
    assert any(p for _, _, p in sites["none"])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    model = build_model(tbase.get_config("qwen3_0_6b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch._run(launch.parse_args(["--steps", "1"]))


def test_launcher_trains_and_resumes_on_cpu(tmp_path):
    """20 steps of the reduced Qwen3 (checkpoints at 0, 8 and 16): the
    loss falls; ``--resume`` restores step 16 and replays steps 16-19 with
    the same losses."""
    argv = ["--arch", "qwen3_0_6b", "--device", "cpu", "--steps", "20",
            "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "8",
            "--ckpt-dir", str(tmp_path)]
    run = launch._run(launch.parse_args(argv))
    losses = run.report.losses
    assert run.start_step == 0 and run.report.steps_done == 20
    assert run.plan_updates == {"attn_impl": "chunked", "norm_impl": "fused"}
    assert run.plan.remat == "dots" and run.plan.attn_kv_chunk == 128
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    assert run.ckpt.steps() == [0, 8, 16]
    assert [r["step"] for r in run.ckpt.saves] == [0, 8, 16]
    again = launch._run(launch.parse_args(argv + ["--resume"]))
    assert again.start_step == 16 and again.report.steps_done == 4
    assert again.restore_s is not None
    np.testing.assert_allclose(again.report.losses, losses[16:], rtol=1e-6)
