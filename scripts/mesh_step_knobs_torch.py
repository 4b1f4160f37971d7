"""Finds which op of the reduced Qwen3's sharded train step a torch
version's DTensor refuses on the (1, 1) host mesh (ROADMAP §3 item 23).

Two parts, each case printing ``ok`` or its error's last line:

* one eager ``jit_train_step`` step of the reduced Qwen3 (head dim 16,
  q/k norms) under the launcher's plan, over a grid of KV chunk sizes
  (16, 128), batches of tokens (2 or 4 rows of 40, 48, 128 or 200) and
  microbatches (1, 2), with the norms fused and as reference ops: a step
  whose last KV chunk is ragged pads K and V;
* ``rmsnorm_fused`` of a DTensor then, or not, the sequence pad that
  ``attend_chunked`` applies to K and V, backward through both; each ok
  case prints the placements of the gradients.

Run it on a card (``--device cpu`` runs it on a gloo group):

    PYTHONPATH=src python3 scripts/mesh_step_knobs_torch.py
"""
import argparse
import sys

import torch


def one_step(cfg, plan, mesh, rows: int, seq: int, dev: str) -> None:
    from repro_torch.core.device_program import disable_capture
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig, make_schedule
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train import (init_train_state, jit_train_step,
                                           state_shardings)

    model = build_model(cfg)
    rules = shd.make_rules(mesh)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device=dev)
    sched = make_schedule("cosine", peak_lr=1e-3, warmup_steps=2,
                          total_steps=5)
    step = jit_train_step(model, plan, OptimizerConfig(), sched, rules,
                          state_shardings(state, rules, cfg))
    batch = model.demo_batch(torch.Generator().manual_seed(1), rows, seq,
                             device=dev)
    with disable_capture():
        step(state, batch)


def norm_then_pad(mesh, shape, placements, pad: int, dev: str) -> str:
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models import layers as L

    x = distribute_tensor(torch.randn(shape, device=dev), mesh,
                          placements).requires_grad_()
    w = distribute_tensor(torch.randn(shape[-1], device=dev), mesh,
                          [Replicate()] * mesh.ndim).requires_grad_()
    y = L.rmsnorm_fused(x, w, 1e-6)
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, pad))
    y.sum().backward()
    return f"x.grad {x.grad.placements}, w.grad {w.grad.placements}"


def outcome(fn) -> str:
    try:
        return "ok " + (fn() or "")
    except Exception as e:                             # noqa: BLE001
        return (f"FAIL {type(e).__name__}: "
                f"{str(e).strip().splitlines()[-1][:300]}")


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import launcher_plan

    print("torch", torch.__version__, torch.version.cuda, flush=True)
    mesh = make_host_mesh(device=dev)
    cfg = get_config("qwen3_0_6b").reduced()
    for mb in (1, 2):
        for ck in (16, 128):
            for rows, seq in ((4, 40), (2, 40), (2, 48), (4, 128), (2, 200)):
                for norm in ("fused", "ref"):
                    plan = launcher_plan(cfg, mb)[0].replace(
                        attn_kv_chunk=ck, norm_impl=norm)
                    pad = (-seq) % min(ck, seq)
                    res = outcome(lambda: one_step(cfg, plan, mesh, rows,
                                                   seq, dev))
                    print(f"step: microbatch {mb}, {ck}-key chunks, "
                          f"{rows} x {seq} tokens (pad {pad}), norms "
                          f"{norm}: {res}", flush=True)
    for shape in ((2, 40, 4, 16), (2, 128, 16, 128)):
        for placements in ((Shard(0), Replicate()),
                           (Replicate(), Replicate())):
            for pad in (0, 8):
                res = outcome(lambda: norm_then_pad(mesh, shape, placements,
                                                    pad, dev))
                print(f"norm then pad {pad}, {shape} {placements}: {res}",
                      flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
