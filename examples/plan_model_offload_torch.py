"""The paper's planner on a model config, on one H100: GA over a model's
offload sites with COMPILED-ARTIFACT fitness (the PyTorch port's twin of
``examples/plan_model_offload.py``; imports only ``repro_torch``).

Every chromosome decodes to an ExecPlan, lowers the train step (traced,
never run: fake tensors on the card) and is scored by its roofline step
time on one H100; plans that exceed the card's 80 GB get fitness ∞ (the
compile-error analogue).  This is `Offloader.plan` with the module
frontend — function-block pass first, GA over the remaining sites.  The
reference's 256-chip mesh waits for the port's mesh; one card holds one
sequence a step here.

Runs the reference example's scaled-down architecture; the mechanics are
identical for the full configs.

  PYTHONPATH=src python examples/plan_model_offload_torch.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch import roofline as rl
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.frontends.registry import OffloadConfig
from repro_torch.core.ga import GAConfig
from repro_torch.core.offload import Offloader
from repro_torch.launch.dryrun import lower_cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    cfg = ArchConfig(arch_id="mini_dense", family="dense", n_layers=3,
                     d_model=512, n_heads=32, n_kv_heads=4, head_dim=16,
                     d_ff=1408, vocab=8000, mlp_act="silu",
                     tie_embeddings=False)
    # the reference's global batch of 256 over its 256 chips: one a card
    shape = dataclasses.replace(ShapeSpec("mini_train", 1024, 256, "train"),
                                global_batch=1)
    n_active = cfg.param_count(active_only=True)
    model_flops = rl.model_flops_train(n_active, shape.tokens)

    def lower_fn(plan):
        lowered, _, _ = lower_cell(cfg, shape, plan, args.device)
        return lowered

    ocfg = OffloadConfig(
        frontend="module", ga=GAConfig(population=6, generations=2, seed=0),
        log=print,
        options={"lower_fn": lower_fn, "n_devices": 1,
                 "model_flops": model_flops})
    res = Offloader(ocfg).plan(cfg)

    print("\n--- block pass (pattern DB) ---")
    for b in res.block.offloads:
        print(f"  {b.region}: {b.pattern} -> {b.plan_field}")
    print("\n--- GA over remaining sites ---")
    print("  sites:", [s.region for s in res.coding.sites])
    print("  best bits:", res.best.bits)
    base_t = res.baseline.time_s
    best_t = res.best.time_s
    print(f"\nbaseline (ref impls): {base_t*1e3:9.1f} ms/step (roofline est)")
    print(f"planned:              {best_t*1e3:9.1f} ms/step "
          f"-> {base_t/best_t:.2f}x")
    print("final plan:", {
        k: getattr(res.artifact, k)
        for k in ("attn_impl", "norm_impl", "mlp_impl", "qkv_fused",
                  "loss_impl", "remat", "gather_mode")})
    r = res.best.detail.get("roofline", {})
    if r:
        print(f"best-cell terms: compute={r['compute_s']*1e3:.1f}ms "
              f"memory={r['memory_s']*1e3:.1f}ms "
              f"collective={r['collective_s']*1e3:.1f}ms "
              f"dominant={r['dominant']}")


if __name__ == "__main__":
    main()
