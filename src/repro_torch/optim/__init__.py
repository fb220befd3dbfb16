"""Optimizer: AdamW and the learning-rate schedule, pure functions over the
port's params trees, and the cross-pod int8 all-reduce
(``compression.py``).  Port of ``repro/optim``."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule"]
