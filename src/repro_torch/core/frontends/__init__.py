"""Port of ``repro/core/frontends``: the Python-``ast`` frontend, the
``torch.export`` frontend (counterpart of the jaxpr frontend), the module
frontend (architecture configs) and the generic ``ir`` frontend behind the
frontend registry.  Importing this package registers them under
``"python_ast"``, ``"export"``, ``"module"`` and ``"ir"``."""
from repro_torch.core.frontends import (ast_frontend, export_frontend,
                                        module_frontend)
from repro_torch.core.frontends.registry import (FitnessBundle, Frontend,
                                                 IRFrontend, OffloadConfig,
                                                 detect_frontend,
                                                 frontend_names,
                                                 get_frontend,
                                                 register_frontend,
                                                 static_cost_fitness_factory)

register_frontend(ast_frontend.AstFrontend())
register_frontend(export_frontend.ExportFrontend())
register_frontend(module_frontend.ModuleFrontend())
register_frontend(IRFrontend())

__all__ = ["ast_frontend", "export_frontend", "module_frontend", "Frontend",
           "FitnessBundle", "IRFrontend", "OffloadConfig",
           "detect_frontend", "frontend_names", "get_frontend",
           "register_frontend", "static_cost_fitness_factory"]
