"""Optimizer: AdamW and the learning-rate schedule, pure functions over the
port's params trees.  Port of ``repro/optim`` (``compression.py``, the
cross-pod int8 all-reduce, waits for the multi-chip slice)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule"]
