"""Port of ``repro/models``: the decoder-only LM of the dense and VLM
families (``transformer``, ``api``), its plan knobs (``plan``), layers and
attention, the RG-LRU sublayer of the hybrid family (``rglru``,
``transformer.RecurrentSublayer``) and the JAX-parameter converters
(``convert``)."""
from repro_torch.models.api import Model, build_model
from repro_torch.models.plan import OFFLOAD_PLAN, REFERENCE_PLAN, ExecPlan

__all__ = ["Model", "build_model", "ExecPlan", "OFFLOAD_PLAN",
           "REFERENCE_PLAN"]
