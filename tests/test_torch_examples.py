"""The port's twins of the reference's examples, each run on the CPU at its
smallest arguments in a subprocess with a time limit: the quickstart and
the Python offload demo with a GA of 2 x 1, the end-to-end trainer for 3
steps.  Each must exit 0, print its summary, and import nothing of JAX or
of the reference."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH="src")
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__'); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'repro.')) or m == 'repro'); "
            "print('imported:', bad)")
    res = subprocess.run(
        [sys.executable, "-c", code, os.path.join("examples", script),
         "--device", "cpu", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    assert res.stdout.rstrip().endswith("imported: []"), res.stdout[-500:]
    return res.stdout


def test_quickstart_twin_runs_on_the_cpu():
    out = _run("quickstart_torch.py", "--population", "2",
               "--generations", "1")
    assert "planned via module" in out
    assert "export plan:" in out and "verified=True" in out
    assert "python_ast plan:" in out
    assert "step 9: loss=" in out and "generated:" in out


def test_python_offload_demo_twin_runs_on_the_cpu():
    out = _run("python_offload_demo_torch.py", "--population", "2",
               "--generations", "1")
    assert "--- function-block offload (pattern DB) ---" in out
    assert "SPEEDUP:" in out


def test_train_e2e_twin_runs_on_the_cpu(tmp_path):
    out = _run("train_e2e_torch.py", "--steps", "3", "--ckpt-dir",
               str(tmp_path))
    assert "done: 3 steps, 0 restarts" in out
    assert "loss:" in out
