"""Port of ``repro/checkpoint``: step-indexed checkpoints with atomic
commits, async save and keep-last-k."""
from repro_torch.checkpoint.manager import (CheckpointManager, load_pytree,
                                            save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
