"""Runtime policy around the training and serving steps (port of
``repro/runtime``; ``elastic.py`` waits for the multi-chip slice)."""
from repro_torch.runtime.fault_tolerance import (Backoff, FailureDetector,
                                                 StepRunner, StragglerMonitor)

__all__ = ["Backoff", "FailureDetector", "StepRunner", "StragglerMonitor"]
