"""Runtime policy around the training and serving steps (port of
``repro/runtime``; ``elastic.py`` waits for the multi-chip slice)."""
from repro_torch.runtime.fault_tolerance import (FailureDetector, StepRunner,
                                                 StragglerMonitor)

__all__ = ["FailureDetector", "StepRunner", "StragglerMonitor"]
