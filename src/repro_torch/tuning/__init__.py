"""Kernel-customization autotuner (paper §3.3-3.4), PyTorch port.

Per-layer method, tile and value-storage selection, measured on the card
(CUDA events) or priced by the card's roofline, persisted to a JSON plan
cache at the reference's schema:

  space    -- candidate enumeration over the card's axes (method x pad_to
              x fuse x pipeline x permute x tm x BCSR block x value dtype),
              pruned to what the CUDA kernels take at each geometry
  measure  -- wall-clock timing + roofline scoring of candidates, each
              method priced at the unit its kernel issues on
  cache    -- versioned JSON plan cache keyed on geometry / epilogue /
              sparsity / dtype / backend
  planner  -- plans the engine's lowered program into {layer: PlanEntry}
"""
from repro_torch.tuning.cache import (PlanCache, PlanEntry, layer_key,
                                      sparsity_bucket)
from repro_torch.tuning.measure import (candidate_cost, epilogue_bytes,
                                        measurable, measure_candidate,
                                        permute_bytes, roofline_estimate,
                                        staged_input_bytes, staging_stall_s,
                                        time_fn)
from repro_torch.tuning.planner import (apply_plan_to_params, format_plan,
                                        geometry_for, geometry_of_op,
                                        plan_layer, plan_network,
                                        plan_program, weight_structure_tag)
from repro_torch.tuning.space import (METHODS, PAD_TO_BUCKETS, VALUE_DTYPES,
                                      Candidate, ConvGeometry,
                                      allowed_value_dtypes, bsr_feasible,
                                      enumerate_candidates, pallas_feasible)

__all__ = [
    "Candidate", "ConvGeometry", "METHODS", "PAD_TO_BUCKETS", "PlanCache",
    "PlanEntry", "VALUE_DTYPES", "allowed_value_dtypes",
    "apply_plan_to_params", "bsr_feasible", "candidate_cost",
    "enumerate_candidates", "epilogue_bytes", "format_plan", "geometry_for",
    "geometry_of_op", "layer_key", "measurable", "measure_candidate",
    "pallas_feasible", "permute_bytes", "plan_layer", "plan_network",
    "plan_program", "roofline_estimate", "sparsity_bucket",
    "staged_input_bytes", "staging_stall_s", "time_fn",
    "weight_structure_tag",
]
