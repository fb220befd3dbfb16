"""Serving, PyTorch port: the continuous-batching scheduler."""
from repro_torch.serving.scheduler import (ContinuousBatcher,
                                           DrainExhaustedWarning, DrainResult,
                                           Request, ServeEngine,
                                           StragglerTickWarning)

__all__ = ["ContinuousBatcher", "DrainExhaustedWarning", "DrainResult",
           "Request", "ServeEngine", "StragglerTickWarning"]
