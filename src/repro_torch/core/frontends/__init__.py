"""Port of ``repro/core/frontends``: the ``torch.export`` frontend
(counterpart of the jaxpr frontend) and the module frontend (architecture
configs) behind the frontend registry.  Importing this package registers
them under ``"export"`` and ``"module"``."""
from repro_torch.core.frontends import export_frontend, module_frontend
from repro_torch.core.frontends.registry import (FitnessBundle, Frontend,
                                                 OffloadConfig,
                                                 detect_frontend,
                                                 frontend_names,
                                                 get_frontend,
                                                 register_frontend)

register_frontend(export_frontend.ExportFrontend())
register_frontend(module_frontend.ModuleFrontend())

__all__ = ["export_frontend", "module_frontend", "Frontend", "FitnessBundle",
           "OffloadConfig",
           "detect_frontend", "frontend_names", "get_frontend",
           "register_frontend"]
