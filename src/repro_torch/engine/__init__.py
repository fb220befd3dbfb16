"""CNN graph engine, PyTorch port.

  spec     -- the layer-spec vocabulary (Conv/Pool/FC/Concat/Residual/Relu)
  program  -- the op set (ConvOp/PoolOp/FCOp/ConcatOp/ResidualAddOp/ReluOp)
  lower    -- the single spec walker
  engine   -- CnnEngine, bind-time parameter init, params_from_reference
"""
from repro_torch.engine.engine import (METHODS, CnnEngine, NoKernelSchedule,
                                       init_conv_params,
                                       params_from_reference)
from repro_torch.engine.lower import lower
from repro_torch.engine.program import (ConcatOp, ConvOp, FCOp, PoolOp,
                                        Program, ReluOp, ResidualAddOp)
from repro_torch.engine.spec import FC, Concat, Conv, Pool, Relu, Residual

__all__ = [
    "CnnEngine", "Concat", "ConcatOp", "Conv", "ConvOp", "FC", "FCOp",
    "METHODS", "NoKernelSchedule", "Pool", "PoolOp", "Program", "Relu",
    "ReluOp", "Residual", "ResidualAddOp", "init_conv_params", "lower",
    "params_from_reference",
]
