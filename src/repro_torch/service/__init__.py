"""Port of ``repro/service``: the persistent offload-planning service (the
daemon layer over the search stack): versioned plan store, request
coalescing, background GA refinement with atomic hot-swap."""
from repro_torch.service.service import (PlanService, ServedPlan,
                                         ServiceConfig, ServiceStats)
from repro_torch.service.store import (PlanMismatchError, PlanRecord,
                                       PlanStore, env_matches,
                                       environment_fingerprint,
                                       record_from_result)

__all__ = ["PlanService", "ServedPlan", "ServiceConfig", "ServiceStats",
           "PlanMismatchError", "PlanRecord", "PlanStore",
           "env_matches", "environment_fingerprint", "record_from_result"]
