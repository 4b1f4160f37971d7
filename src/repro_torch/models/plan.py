"""Port of ``repro/models/plan.py``, unchanged: :class:`ExecPlan` with its
fields and defaults, ``OFFLOAD_SITES`` and ``SITE_VARIANTS`` in the
reference's order (the gene ABI), ``REFERENCE_PLAN`` and ``OFFLOAD_PLAN``.
In the port the accelerated implementations are PyTorch rewrites; the
hand-written CUDA kernels come in through the export frontend's
substitution, not through these knobs.

Execution plan: the knob surface the offload planner searches.

The paper encodes "which loop runs on the accelerator" as a binary gene.  Our
TPU analogue: every *offloadable region* of a model has a reference (``ref``)
implementation and one or more accelerated implementations (fused/chunked jnp
rewrite on any backend; Pallas kernel when running on real TPU).  An
:class:`ExecPlan` pins one implementation per region plus the transfer-
placement knobs; the GA in ``repro.core`` mutates plans through their binary
gene encoding (see ``core/genes.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ExecPlan:
    # --- per-region implementation selection (the paper's loop genes) ------
    attn_impl: str = "naive"        # naive | chunked (flash-style online softmax)
    norm_impl: str = "ref"          # ref | fused
    mlp_impl: str = "ref"           # ref | fused
    qkv_fused: bool = False         # fuse q,k,v projections into one matmul
    rglru_impl: str = "step"        # step | assoc | chunked
    wkv_impl: str = "step"          # step | chunked
    moe_impl: str = "dense_onehot"  # dense_onehot | scatter_ep
    loss_impl: str = "full"         # full | chunked_vocab

    # --- tiling (BlockSpec analogue for the jnp paths) ----------------------
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    rglru_chunk: int = 256
    wkv_chunk: int = 64
    loss_vocab_chunk: int = 32_768

    # --- memory / transfer knobs (the paper's CPU<->GPU transfer hoisting) --
    remat: str = "dots"             # none | dots | full
    gather_mode: str = "per_layer"  # per_layer | hoisted  (FSDP all-gather placement)
    donate_state: bool = True       # donate params/cache buffers (kills D2H copies)
    microbatch: int = 1             # grad-accumulation splits of the global batch
    gather_dtype: str = "param"     # param | compute: cast weights BEFORE the
                                    # per-layer FSDP gather (bf16 halves traffic)

    # --- misc -----------------------------------------------------------------
    compute_dtype: str = "bfloat16"

    def replace(self, **kw: Any) -> "ExecPlan":
        return dataclasses.replace(self, **kw)

    # Regions that have an accelerated alternative, in canonical order.  This
    # is what the gene encoder enumerates (core/genes.py); order is part of
    # the framework ABI so genomes are reproducible.
    OFFLOAD_SITES: tuple[tuple[str, str, str], ...] = (
        # (field, ref_value, offload_value)
        ("attn_impl", "naive", "chunked"),
        ("norm_impl", "ref", "fused"),
        ("mlp_impl", "ref", "fused"),
        ("qkv_fused", False, True),
        ("rglru_impl", "step", "assoc"),
        ("wkv_impl", "step", "chunked"),
        ("moe_impl", "dense_onehot", "scatter_ep"),
        ("loss_impl", "full", "chunked_vocab"),
        ("remat", "none", "dots"),
        ("gather_mode", "hoisted", "per_layer"),
    )

    # Full implementation menu per offload site where the executors ship
    # more than the (ref, offload) pair.  Index order is the gene contract
    # (`Destination.impl_index`: 0 = reference, 1 = primary accelerated,
    # 2+ = extra variants), so a multi-destination chromosome selects WHICH
    # implementation runs, not just whether the site is offloaded.  Sites
    # absent here keep their binary OFFLOAD_SITES pair (genes clamp).
    SITE_VARIANTS = {
        "rglru_impl": ("step", "assoc", "chunked"),   # models/rglru.py
        "remat": ("none", "dots", "full"),            # models/transformer.py
    }


REFERENCE_PLAN = ExecPlan(
    attn_impl="naive",
    norm_impl="ref",
    mlp_impl="ref",
    qkv_fused=False,
    rglru_impl="step",
    wkv_impl="step",
    moe_impl="dense_onehot",
    loss_impl="full",
    remat="none",
    gather_mode="hoisted",
)

# The all-offload plan: every region on its accelerated implementation.
OFFLOAD_PLAN = ExecPlan(
    attn_impl="chunked",
    norm_impl="fused",
    mlp_impl="fused",
    qkv_fused=True,
    rglru_impl="assoc",
    wkv_impl="chunked",
    moe_impl="scatter_ep",
    loss_impl="chunked_vocab",
    remat="dots",
    gather_mode="per_layer",
)
