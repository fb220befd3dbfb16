"""Pre-flight static verifier: find serving-time surprises before deploy.

Port of ``repro/analysis``.  Four rule packs over four layers of the stack,
one diagnostic vocabulary:

  schedule_rules  replay the card's kernel schedule probes over every conv
                  a net can run, with the engine's own arguments: shared
                  memory budgets, the tiles and blocks the CUDA sources
                  instantiate, the pipelined schedule's demotion, halo
                  bounds, the f32 conv policy, value dtypes
  plan_rules      audit a plan-cache file without executing: schema and
                  migration chain, stale pre-v5 bsr entries, key grammar,
                  geometry consistency, structure tags, each entry's
                  schedule at its key's geometry
  program_rules   structural checks on the lowered op program: SSA form,
                  geometry chaining, epilogue signatures
  cuda_lints      read the CUDA kernel sources: no ``__syncthreads()``
                  under a thread-dependent branch, no allocation in a
                  kernel, f32 accumulators, async copies paired with
                  their waits

``python -m repro_torch.analysis check`` runs everything;
``CnnEngine(..., strict=True)`` runs the bind-scoped subset and raises
:class:`PreflightError` on errors.
"""
from repro_torch.analysis.diagnostics import (REASON_RULES, Diagnostic,
                                              PreflightError, Report)

__all__ = ["Diagnostic", "PreflightError", "REASON_RULES", "Report"]
