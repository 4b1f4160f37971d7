"""Port of ``repro/launch/plans.py``, unchanged: per-(arch x shape)
production ExecPlans.

The *baseline* production plan is what the offload planner's block pass
yields on every arch (all function blocks on their offloaded
implementations) with shape-dependent knobs: remat only where there is a
backward pass, chunked-vocab loss only where there is a loss, FSDP
(per-layer gather) always at production scale.

``tuned_plan`` holds the post-hillclimb overrides recorded in
EXPERIMENTS.md §Perf (kept separate so the paper-faithful baseline stays
reproducible).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.plan import ExecPlan, OFFLOAD_PLAN


# activation-heavy archs split the global batch (grad accumulation); chosen
# from measured dry-run live-bytes (see EXPERIMENTS.md §Perf memory log).
# The sizes below are the reference's, per TPU v5e chip of its 16 GB, not
# the port's; the values stay as they are so both packages plan alike
_TRAIN_MICROBATCH = {
    "gemma_7b": 2,            # 16.4 GB -> fits with mb=2 (d_ff=24576)
    "recurrentgemma_2b": 2,   # 22.2 GB
    "rwkv6_3b": 2,            # 16.3 GB
    "llava_next_mistral_7b": 2,
    "llama4_scout_17b_a16e": 16,  # 86.5 GB at mb=1: 48L x 5120 + MoE buffers
    "olmoe_1b_7b": 4,         # dispatch buffers scale with tokens/shard
}


def production_plan(cfg: ArchConfig, shape: ShapeSpec) -> ExecPlan:
    plan = OFFLOAD_PLAN
    if shape.kind == "train":
        # remat="full": recompute whole layers in backward — the "dots"
        # policy saves (tokens, d_ff) products inside the scan, 40 GB/device
        # at train_4k scale (measured in the dry-run; see EXPERIMENTS.md).
        plan = plan.replace(remat="full", loss_impl="chunked_vocab",
                            loss_vocab_chunk=8_192,
                            attn_q_chunk=512, attn_kv_chunk=1024,
                            microbatch=_TRAIN_MICROBATCH.get(cfg.arch_id, 1))
    else:
        plan = plan.replace(remat="none", loss_impl="full",
                            attn_q_chunk=512,
                            attn_kv_chunk=2048 if shape.seq_len >= 32_768 else 1024)
    if cfg.family == "ssm":
        plan = plan.replace(wkv_chunk=64)
    if cfg.block_pattern:
        plan = plan.replace(rglru_chunk=256)
    return plan


# --- §Perf hillclimb overrides (filled in as the perf log lands) ------------

_TUNED: dict[tuple[str, str], dict] = {
    # ("arch_id", "shape_name"): {plan field: value}
    # §Perf iter 7: bf16 FSDP weight gathers (see EXPERIMENTS.md)
    ("tinyllama_1_1b", "train_4k"): {"gather_dtype": "compute"},
    ("llama4_scout_17b_a16e", "train_4k"): {"gather_dtype": "compute",
                                            "microbatch": 8},
    ("gemma_7b", "train_4k"): {"gather_dtype": "compute"},
}


def tuned_plan(cfg: ArchConfig, shape: ShapeSpec) -> ExecPlan:
    plan = production_plan(cfg, shape)
    over = _TUNED.get((cfg.arch_id, shape.name))
    return plan.replace(**over) if over else plan
