"""Serving, PyTorch port: the continuous-batching scheduler (transformers)
and the fault-tolerant shape-bucketed CNN serving tier with its seeded
chaos harness."""
from repro_torch.serving.chaos import (Arrival, ChaosConfig, ChaosFatalError,
                                       ChaosInjector, ChaosRetryableError,
                                       arrival_trace, corrupt_plan_cache_file,
                                       slice_net)
from repro_torch.serving.robust import (LADDER_REASONS, REJECT_REASONS,
                                        BucketSpec, InferenceRequest,
                                        LadderEvent, RobustCnnServer,
                                        SloReport, VirtualClock, WallClock)
from repro_torch.serving.scheduler import (ContinuousBatcher,
                                           DrainExhaustedWarning, DrainResult,
                                           Request, ServeEngine,
                                           StragglerTickWarning)

__all__ = [
    "Arrival", "BucketSpec", "ChaosConfig", "ChaosFatalError",
    "ChaosInjector", "ChaosRetryableError", "ContinuousBatcher",
    "DrainExhaustedWarning", "DrainResult", "InferenceRequest",
    "LADDER_REASONS", "LadderEvent", "REJECT_REASONS", "Request",
    "RobustCnnServer", "ServeEngine", "SloReport", "StragglerTickWarning",
    "VirtualClock", "WallClock", "arrival_trace", "corrupt_plan_cache_file",
    "slice_net",
]
