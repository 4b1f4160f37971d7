"""Port of ``repro/models``: the decoder-only LM of the dense, VLM, MoE,
hybrid and SSM families (``transformer``), the enc-dec family
(``whisper``), the facade over all of them (``api``), its plan knobs
(``plan``), layers and attention, the MoE block (``moe``), the RG-LRU
block of the hybrid family (``rglru``, ``transformer.RecurrentSublayer``),
the RWKV-6 block of the SSM family (``rwkv``, ``transformer.RWKVBlock``)
and the JAX-parameter converters (``convert``)."""
from repro_torch.models.api import Model, build_model
from repro_torch.models.plan import OFFLOAD_PLAN, REFERENCE_PLAN, ExecPlan

__all__ = ["Model", "build_model", "ExecPlan", "OFFLOAD_PLAN",
           "REFERENCE_PLAN"]
