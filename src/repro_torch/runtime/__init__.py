"""Runtime policy around the training and serving steps (port of
``repro/runtime``): fault tolerance, and the elastic re-mesh."""
from repro_torch.runtime.fault_tolerance import (Backoff, FailureDetector,
                                                 StepRunner, StragglerMonitor)
from repro_torch.runtime.elastic import build_mesh, plan_remesh

__all__ = ["Backoff", "FailureDetector", "StepRunner", "StragglerMonitor",
           "build_mesh", "plan_remesh"]
