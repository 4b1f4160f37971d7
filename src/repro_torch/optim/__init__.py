"""Port of ``repro/optim``: AdamW, LR schedules and error-feedback int8
gradient compression."""
from repro_torch.optim.adamw import (AdamWState, OptimizerConfig, adamw_init,
                                     adamw_update)
from repro_torch.optim.compression import (CompressionState, compress_int8,
                                           decompress_int8,
                                           ef_compress_update, ef_init)
from repro_torch.optim.schedule import make_schedule

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "OptimizerConfig",
    "make_schedule",
    "CompressionState", "compress_int8", "decompress_int8",
    "ef_compress_update", "ef_init",
]
