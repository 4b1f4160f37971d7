"""Port of ``repro/core``: the common offload core (Region IR, GA,
evaluator, pattern DB, substitution engine, pipeline) over PyTorch.

Unlike the reference's package init, this one imports nothing, so importing
``repro_torch.obs`` or one core module never pulls in the rest; the entry
point is :mod:`repro_torch.core.offload` (``Offloader``, ``plan``).
"""
