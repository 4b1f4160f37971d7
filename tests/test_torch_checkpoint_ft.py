"""The port's checkpointing and fault tolerance (``repro_torch/checkpoint``,
``repro_torch/runtime/fault_tolerance.py``): the counterparts of
``tests/test_checkpoint_ft.py`` (atomic commits, resume, keep-last-k,
supervised restart on injected failures and on a non-finite loss,
straggler detection; elastic reshard waits for the mesh), then what the
port adds: a save snapshots before it returns, so an in-place write after
``save()`` is not in the checkpoint; a train state (a parameter module, a
NamedTuple, bf16 leaves) round-trips with each leaf's dtype and device."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.fault_tolerance import StragglerMonitor, Supervisor  # noqa: E402
from repro_torch.runtime.train import init_train_state  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 8, generator=g),
            "b": torch.zeros(8),
            "nested": {"step": torch.tensor(3, dtype=torch.int32)}}


def _leaves(tree):
    return [tree["w"], tree["b"], tree["nested"]["step"]]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    t = _tree()
    mgr.save(10, t)
    step, t2 = mgr.restore(t)
    assert step == 10
    for a, b in zip(_leaves(t), _leaves(t2)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_keep_last_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [3, 4]


def test_async_save_with_donated_source(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree()
    mgr.save(5, t)
    mgr.wait()
    _, t2 = mgr.restore(t)
    assert torch.equal(t["w"], t2["w"])


def test_in_place_write_after_save_is_not_in_the_checkpoint(tmp_path):
    """The train step writes parameters in place: a save must hold the
    values of its call, whatever happens to the tensors after it returns
    and before (or while) the async writer runs."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree()
    want = t["w"].clone()
    mgr.save(5, t)
    t["w"].add_(1.0)
    t["nested"]["step"].fill_(99)
    mgr.wait()
    _, t2 = mgr.restore(_tree(1))
    assert torch.equal(t2["w"], want)
    assert int(t2["nested"]["step"]) == 3
    (rec,) = mgr.saves
    assert rec["step"] == 5 and rec["bytes"] == (64 + 8) * 4 + 4
    assert rec["snapshot_s"] >= 0 and rec["write_s"] >= 0


def test_crash_mid_save_leaves_last_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _tree(1))
    os.makedirs(tmp_path / ".tmp_step_2")
    (tmp_path / ".tmp_step_2" / "arr_0.npy").write_bytes(b"junk")
    assert mgr.latest_step() == 1
    step, _ = mgr.restore(_tree(1))
    assert step == 1


def test_train_state_roundtrip_restores_module_in_place(tmp_path):
    """A TrainState (parameter module, AdamW moments keyed by name, int32
    step) saved, then changed, then restored: the same module object holds
    the saved values, every leaf keeps the template's dtype, and the paths
    name the module's parameters."""
    cfg = get_config("qwen3_0_6b").reduced()
    state = init_train_state(build_model(cfg), torch.Generator().manual_seed(0),
                             device="cpu")
    saved = {k: p.detach().clone() for k, p in
             state.params.named_parameters()}
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    mgr.save(2, state)
    with torch.no_grad():
        for p in state.params.parameters():
            p.mul_(0.0)
    state.opt.mu["embed"].fill_(5.0)
    step, back = mgr.restore(state._replace(
        opt=state.opt._replace(step=state.opt.step + 7)))
    assert step == 2 and back.params is state.params
    for k, p in back.params.named_parameters():
        assert torch.equal(p, saved[k]), k
    assert back.opt.step.dtype == torch.int32 and int(back.opt.step) == 0
    assert float(back.opt.mu["embed"].abs().max()) == 0.0
    assert back.comp is None
    with open(tmp_path / "step_2" / "manifest.json") as f:
        paths = [e["path"] for e in json.load(f)["leaves"]]
    assert paths[0] == "params/embed" and "opt/step" in paths
    assert "opt/mu/blocks.0.wq" in paths


def test_bf16_leaves_roundtrip(tmp_path):
    t = {"w": torch.randn(5, 3).to(torch.bfloat16), "n": np.arange(3)}
    save_pytree(t, str(tmp_path / "c"))
    back = load_pytree({"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                        "n": np.zeros(3)}, str(tmp_path / "c"))
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t["w"])
    np.testing.assert_array_equal(back["n"].numpy(), t["n"])


def test_supervisor_recovers_from_injected_failures(tmp_path):
    """A 30-step run with failures at steps 7 and 19 completes with 2
    restarts and the same final state as a failure-free run."""
    def step_fn(state, batch):
        new = {"x": state["x"] + batch["v"]}
        return new, {"loss": new["x"].sum()}

    def batch_fn(step):
        return {"v": torch.ones(2) * (step + 1)}

    def run(inject):
        mgr = CheckpointManager(str(tmp_path / ("a" if inject else "b")),
                                keep=3, async_save=False)
        sup = Supervisor(mgr, ckpt_every=5, max_restarts=5)
        failed = set()

        def injector(step):
            if inject and step in (7, 19) and step not in failed:
                failed.add(step)
                return True
            return False
        return sup.run({"x": torch.zeros(2)}, batch_fn, step_fn, n_steps=30,
                       failure_injector=injector)

    s1, rep1 = run(True)
    s2, rep2 = run(False)
    assert rep1.restarts == 2 and rep2.restarts == 0
    assert torch.equal(s1["x"], s2["x"])
    assert len(rep2.step_seconds) == len(rep2.losses) == 30


def test_supervisor_nan_loss_triggers_restart(tmp_path):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            return state, {"loss": torch.tensor(float("nan"))}
        return {"x": state["x"] + 1}, {"loss": torch.tensor(1.0)}

    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    sup = Supervisor(mgr, ckpt_every=2, max_restarts=3)
    state, rep = sup.run({"x": torch.zeros(())}, lambda s: {}, step_fn,
                         n_steps=6)
    assert rep.restarts == 1
    assert float(state["x"]) == 6


def test_straggler_monitor_flags_slow_step():
    mon = StragglerMonitor(warmup=3)
    for i in range(10):
        assert not mon.observe(i, 0.10 + 0.001 * (i % 2))
    assert mon.observe(10, 0.55)
    assert not mon.observe(11, 0.101)
