"""Port of ``repro/core/frontends``: the ``torch.export`` frontend
(counterpart of the jaxpr frontend) behind the frontend registry.
Importing this package registers it under ``"export"``."""
from repro_torch.core.frontends import export_frontend
from repro_torch.core.frontends.registry import (FitnessBundle, Frontend,
                                                 OffloadConfig,
                                                 detect_frontend,
                                                 frontend_names,
                                                 get_frontend,
                                                 register_frontend)

register_frontend(export_frontend.ExportFrontend())

__all__ = ["export_frontend", "Frontend", "FitnessBundle", "OffloadConfig",
           "detect_frontend", "frontend_names", "get_frontend",
           "register_frontend"]
