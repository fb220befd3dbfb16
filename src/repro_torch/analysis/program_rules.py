"""Program rules: structural verification of a lowered op program.

Port of ``repro/analysis/program_rules.py``: pure Python over the port's
``Program`` (a copy of the reference's), the same rules and ids.

``engine.lower`` emits a flat SSA-style program (value 0 = network input,
each op reads ``src`` ids and defines ``out``); the executor replays it as
pure dataflow without ever inspecting shapes.  That only works if the
program's static geometry actually chains — these rules re-derive every
op's input shape from its producers and check the recorded geometry against
it, plus the SSA discipline the executor assumes.

Rules:

  prog.ssa_form            an out id defined twice, or a src used before
                           (or without) definition
  prog.out_undefined       the program's result id is never defined
  prog.geometry_chain      an op's recorded input/output geometry does not
                           match what its producer actually yields
  prog.epilogue_signature  a fused epilogue operand (the bottleneck
                           shortcut ``res``) has the wrong shape for the
                           conv output it is added to
  prog.dead_value          an op's result is never consumed (warning)
  prog.unfused_relu        a ReluOp directly consumes a ConvOp output --
                           lowering should have fused it (warning)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.direct_conv import out_spatial
from repro_torch.engine.program import (
    ConcatOp,
    ConvOp,
    FCOp,
    PoolOp,
    Program,
    ReluOp,
    ResidualAddOp,
)

RULES = {
    "prog.ssa_form": (
        "error",
        "value id defined twice or used before definition",
    ),
    "prog.out_undefined": (
        "error",
        "program result id is never defined",
    ),
    "prog.geometry_chain": (
        "error",
        "op geometry does not match its producer's output",
    ),
    "prog.epilogue_signature": (
        "error",
        "fused epilogue operand shape mismatch",
    ),
    "prog.dead_value": (
        "warning",
        "op result is never consumed",
    ),
    "prog.unfused_relu": (
        "warning",
        "ReLU on a conv output that lowering should have fused",
    ),
}

Shape = Tuple[int, int, int]  # (C, H, W)


def _srcs(op) -> List[int]:
    if isinstance(op, ConcatOp):
        return list(op.srcs)
    if isinstance(op, ResidualAddOp):
        return [op.a, op.b]
    srcs = [op.src]
    if isinstance(op, ConvOp) and op.res is not None:
        srcs.append(op.res)
    return srcs


def check_program(
    program: Program, *, net: Optional[str] = None
) -> List[Diagnostic]:
    """Structurally verify one lowered program (no execution)."""
    out: List[Diagnostic] = []
    shapes: Dict[int, Shape] = {0: tuple(program.in_shape)}
    producer: Dict[int, object] = {}
    consumed: Dict[int, int] = {}

    def err(rule: str, op, message: str, severity: str = "error") -> None:
        out.append(
            Diagnostic(
                rule=rule,
                severity=severity,
                message=message,
                net=net,
                layer=getattr(op, "name", None),
                location=f"op:{type(op).__name__}@{op.out}",
            )
        )

    for op in program.ops:
        if op.out in shapes:
            err(
                "prog.ssa_form",
                op,
                f"value {op.out} defined more than once",
            )
            continue
        missing = [s for s in _srcs(op) if s not in shapes]
        if missing:
            err(
                "prog.ssa_form",
                op,
                f"src value(s) {missing} used before definition",
            )
            continue
        for s in _srcs(op):
            consumed[s] = consumed.get(s, 0) + 1
        if isinstance(op, ConvOp):
            c, h, w = shapes[op.src]
            if (c, h, w) != (op.c, op.h, op.w):
                err(
                    "prog.geometry_chain",
                    op,
                    f"recorded input {(op.c, op.h, op.w)} but producer "
                    f"yields {(c, h, w)}",
                )
            e, f = out_spatial(op.h, op.w, op.k, op.k, op.stride, op.pad)
            if (e, f) != (op.e, op.f):
                err(
                    "prog.geometry_chain",
                    op,
                    f"recorded output {op.e}x{op.f} but conv arithmetic "
                    f"yields {e}x{f}",
                )
            if op.res is not None:
                rshape = shapes[op.res]
                if rshape != (op.m, op.e, op.f):
                    err(
                        "prog.epilogue_signature",
                        op,
                        f"fused shortcut shape {rshape} != conv output "
                        f"{(op.m, op.e, op.f)}",
                    )
            shapes[op.out] = (op.m, op.e, op.f)
        elif isinstance(op, PoolOp):
            c, h, w = shapes[op.src]
            if op.kind == "gap":
                e, f = 1, 1
            else:
                e, f = out_spatial(h, w, op.k, op.k, op.stride, op.pad)
            if (e, f) != (op.e, op.f):
                err(
                    "prog.geometry_chain",
                    op,
                    f"recorded pool output {op.e}x{op.f} but arithmetic "
                    f"yields {e}x{f}",
                )
            shapes[op.out] = (c, op.e, op.f)
        elif isinstance(op, ConcatOp):
            ss = [shapes[s] for s in op.srcs]
            if len({(h, w) for _, h, w in ss}) > 1:
                err(
                    "prog.geometry_chain",
                    op,
                    f"concat branches disagree spatially: "
                    f"{[(h, w) for _, h, w in ss]}",
                )
            shapes[op.out] = (sum(c for c, _, _ in ss), ss[0][1], ss[0][2])
        elif isinstance(op, ResidualAddOp):
            if shapes[op.a] != shapes[op.b]:
                err(
                    "prog.geometry_chain",
                    op,
                    f"residual add operands disagree: {shapes[op.a]} vs "
                    f"{shapes[op.b]}",
                )
            shapes[op.out] = shapes[op.a]
        elif isinstance(op, ReluOp):
            if isinstance(producer.get(op.src), ConvOp):
                err(
                    "prog.unfused_relu",
                    op,
                    f"ReLU on conv "
                    f"{producer[op.src].name!r} output; lowering should "
                    f"have fused it into the conv epilogue",
                    severity="warning",
                )
            shapes[op.out] = shapes[op.src]
        elif isinstance(op, FCOp):
            c, h, w = shapes[op.src]
            if op.in_f != c * h * w:
                err(
                    "prog.geometry_chain",
                    op,
                    f"recorded fan-in {op.in_f} but producer yields "
                    f"{c}x{h}x{w} = {c * h * w}",
                )
            shapes[op.out] = (op.out_f, 1, 1)
        else:
            err("prog.ssa_form", op, f"unknown op type {type(op).__name__}")
            shapes[op.out] = shapes.get(op.out, (0, 0, 0))
        producer[op.out] = op
    if program.out not in shapes:
        out.append(
            Diagnostic(
                rule="prog.out_undefined",
                severity="error",
                message=f"program result id {program.out} is never defined",
                net=net,
            )
        )
    for vid, op in producer.items():
        if vid != program.out and not consumed.get(vid):
            out.append(
                Diagnostic(
                    rule="prog.dead_value",
                    severity="warning",
                    message=f"value {vid} is never consumed",
                    net=net,
                    layer=getattr(op, "name", None),
                    location=f"op:{type(op).__name__}@{vid}",
                )
            )
    return out
