"""Lints over the port's CUDA kernel sources: kernel hygiene, statically.

The counterpart of the reference's ``ast_lints.py``, which parses its
Pallas kernel bodies.  The port's kernel bodies are the ``__global__``
functions of ``src/repro_torch/kernels/*/csrc/*.cu``; each is checked
together with the same file's ``__device__`` helpers it calls (by name,
transitively), since the inline PTX lives in small helpers.  No C++ parser:
comments are stripped, string literals set aside (the inline PTX is read
from them), and statements and blocks are found by matching braces.  The
four rule ids are the reference's, each in its CUDA form:

  lint.traced_branch  a ``__syncthreads()`` (or a call of a helper that
                      reaches one) under a branch or loop whose condition
                      reads ``threadIdx`` or a name derived from it (lane,
                      warp, thread ids): threads that skip the barrier
                      deadlock or race the ones that wait.  Named barriers
                      (``bar.sync id, n``) synchronise a chosen set of
                      warps and are exempt.
  lint.grid_alloc     ``malloc``/``new`` in a kernel body: a device-heap
                      allocation per thread per launch.
  lint.accum_dtype    an ``mma``/``wgmma`` instruction whose accumulator
                      type is not ``.f32`` (the repo's policy: narrow
                      operands, f32 sums).
  lint.dma_pairing    ``cp.async`` copies committed (or issued) with no
                      ``cp.async.wait_group``/``wait_all``, or a wait with
                      no copy; a bulk copy or ``mbarrier.arrive.expect_tx``
                      with no ``mbarrier.try_wait``, or the reverse: an
                      unwaited copy races its destination, a wait with no
                      copy never returns.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.diagnostics import Diagnostic

RULES = {
    "lint.traced_branch": (
        "error",
        "__syncthreads() under a branch on thread/lane/warp ids",
    ),
    "lint.grid_alloc": (
        "error",
        "malloc/new inside a kernel body",
    ),
    "lint.accum_dtype": (
        "error",
        "mma/wgmma accumulator not f32",
    ),
    "lint.dma_pairing": (
        "error",
        "async copy issued with no wait (or a wait with no copy) in a kernel",
    ),
}

_ID = re.compile(r"[A-Za-z_]\w*")
_ASSIGN = re.compile(r"\b([A-Za-z_]\w*)\s*(?:\[[^\]]*\]\s*)?=(?!=)")
_MMA = re.compile(r"\b(wgmma\.mma_async|mma\.sync)((?:\.[A-Za-z0-9_:]+)*)")
_TYPES = ("f16", "bf16", "f32", "tf32", "f64", "s32", "s8", "u8", "s4", "u4",
          "e4m3", "e5m2", "b1")


@dataclasses.dataclass
class _Source:
    """A source with comments removed and string literals blanked (their
    contents kept by offset), and its line starts."""

    path: str
    code: str
    strings: List[Tuple[int, str]]
    line_starts: List[int]

    def line(self, pos: int) -> int:
        return bisect.bisect_right(self.line_starts, pos)

    def ptx(self, start: int, end: int) -> str:
        """The string literals (inline PTX) between two offsets."""
        return "\n".join(t for p, t in self.strings if start <= p < end)


def _scan(path: str, text: str) -> _Source:
    """Strip comments and preprocessor lines, blank string and character
    literals to spaces (same length, so offsets and lines hold)."""
    out = []
    strings: List[Tuple[int, str]] = []
    i, n = 0, len(text)
    line_start = True
    while i < n:
        c = text[i]
        if line_start and c == "#":
            j = text.find("\n", i)
            j = n if j < 0 else j
            while text[j - 1] == "\\" and j < n:   # continued directive
                j = text.find("\n", j + 1)
                j = n if j < 0 else j
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
            continue
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
            continue
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            body = text[i + 1:j]
            if c == '"':
                strings.append((i, body.replace("\\n", "\n")))
            out.append(c + re.sub(r"[^\n]", " ", body) + c)
            i = j + 1
            continue
        out.append(c)
        if c == "\n":
            line_start = True
        elif not c.isspace():
            line_start = False
        i += 1
    code = "".join(out)
    starts = [0] + [m.end() for m in re.finditer(r"\n", code)]
    return _Source(path, code, strings, starts)


def _match(code: str, i: int, open_: str, close: str) -> int:
    """Offset just past the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(code)):
        if code[j] == open_:
            depth += 1
        elif code[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(code)


@dataclasses.dataclass
class _Function:
    name: str
    kind: str           # "__global__" or "__device__"
    start: int          # offset of the qualifier
    body: Tuple[int, int]  # offsets of "{" and just past "}"


def _functions(src: _Source) -> List[_Function]:
    """The ``__global__`` and ``__device__`` function definitions."""
    code = src.code
    out: List[_Function] = []
    for m in re.finditer(r"\b(__global__|__device__)\b", code):
        i = m.end()
        name = None
        while i < len(code):
            ch = code[i]
            if ch in ";{=":
                break   # a declaration or a variable, not a definition
            if ch == "(":
                before = _ID.findall(code[m.end():i])
                if before and before[-1] == "__launch_bounds__":
                    i = _match(code, i, "(", ")")
                    continue
                name = before[-1] if before else None
                break
            i += 1
        if name is None or i >= len(code) or code[i] != "(":
            continue
        j = _match(code, i, "(", ")")
        k = j
        while k < len(code) and code[k] not in "{;":
            k += 1
        if k >= len(code) or code[k] != "{":
            continue
        if any(f.body[0] <= m.start() < f.body[1] for f in out):
            continue   # a qualifier inside a body already found
        out.append(_Function(name, m.group(1), m.start(),
                             (k, _match(code, k, "{", "}"))))
    return out


@dataclasses.dataclass
class _Node:
    """A statement or a control structure of a body."""

    pos: int
    text: str = ""                  # a simple statement
    cond: Optional[str] = None      # a control structure's condition
    children: List["_Node"] = dataclasses.field(default_factory=list)


def _skip_ws(code: str, i: int, end: int) -> int:
    while i < end and code[i].isspace():
        i += 1
    return i


def _statement(code: str, i: int, end: int) -> Tuple[_Node, int]:
    """Parse one statement at ``i``; returns it and the offset past it."""
    i = _skip_ws(code, i, end)
    m = _ID.match(code, i)
    word = m.group(0) if m else ""
    if code.startswith("{", i):
        j = _match(code, i, "{", "}")
        return _Node(i, children=_block(code, i + 1, j - 1)), j
    if word in ("if", "while", "for", "switch"):
        p = _skip_ws(code, m.end(), end)
        q = _match(code, p, "(", ")")
        cond = code[p + 1:q - 1]
        body, j = _statement(code, q, end)
        node = _Node(i, cond=cond, children=[body])
        if word == "if":
            w = _ID.match(code, _skip_ws(code, j, end))
            if w and w.group(0) == "else":
                els, j = _statement(code, w.end(), end)
                # the else branch runs under the same condition
                node.children.append(els)
        return node, j
    if word == "do":
        body, j = _statement(code, m.end(), end)
        k = _skip_ws(code, j, end)
        w = _ID.match(code, k)
        if w and w.group(0) == "while":
            p = _skip_ws(code, w.end(), end)
            q = _match(code, p, "(", ")")
            j = code.find(";", q, end) + 1 or end
            return _Node(i, cond=code[p + 1:q - 1], children=[body]), j
        return body, j
    # a simple statement: to the ";" outside any bracket
    depth = 0
    j = i
    while j < end:
        ch = code[j]
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == ";" and depth == 0:
            j += 1
            break
        j += 1
    return _Node(i, text=code[i:j]), j


def _block(code: str, i: int, end: int) -> List[_Node]:
    out = []
    while True:
        i = _skip_ws(code, i, end)
        if i >= end:
            return out
        node, j = _statement(code, i, end)
        out.append(node)
        i = max(j, i + 1)


def _tainted(text: str) -> Set[str]:
    """Names assigned (anywhere in ``text``) from ``threadIdx`` or from a
    name so assigned: a fixpoint over the assignments."""
    assigns = []
    for m in _ASSIGN.finditer(text):
        stop = len(text)
        depth = 0
        for j in range(m.end(), len(text)):
            ch = text[j]
            if ch in "([{":
                depth += 1
            elif ch in ")]}":
                if depth == 0:
                    stop = j
                    break
                depth -= 1
            elif ch in ";," and depth == 0:
                stop = j
                break
        assigns.append((m.group(1), text[m.end():stop]))
    tainted: Set[str] = set()
    grew = True
    while grew:
        grew = False
        for name, rhs in assigns:
            if name in tainted:
                continue
            ids = set(_ID.findall(rhs))
            if "threadIdx" in ids or ids & tainted:
                tainted.add(name)
                grew = True
    return tainted


def _reads_thread(cond: str, tainted: Set[str]) -> bool:
    ids = set(_ID.findall(cond))
    return "threadIdx" in ids or bool(ids & tainted)


def _calls(text: str, names: Iterable[str]) -> Set[str]:
    ids = set(_ID.findall(text))
    return {n for n in names if n in ids}


def _reach(fn: _Function, by_name: Dict[str, List[_Function]],
           src: _Source) -> List[_Function]:
    """``fn`` and the same file's ``__device__`` helpers it calls,
    transitively."""
    seen = {id(fn)}
    order = [fn]
    todo = [fn]
    while todo:
        f = todo.pop()
        text = src.code[f.body[0]:f.body[1]]
        for name in _calls(text, by_name):
            for g in by_name[name]:
                if g.kind == "__device__" and id(g) not in seen:
                    seen.add(id(g))
                    order.append(g)
                    todo.append(g)
    return order


def _sync_helpers(fns: List[_Function], src: _Source) -> Set[str]:
    """Helpers that reach a ``__syncthreads()``."""
    out: Set[str] = set()
    grew = True
    while grew:
        grew = False
        for f in fns:
            if f.kind != "__device__" or f.name in out:
                continue
            text = src.code[f.body[0]:f.body[1]]
            if "__syncthreads" in text or _calls(text, out):
                out.add(f.name)
                grew = True
    return out


def _branch_syncs(nodes: List[_Node], tainted: Set[str], syncs: Set[str],
                  under: Optional[str]) -> List[Tuple[int, str]]:
    """(offset, condition) of each sync point under a thread-dependent
    condition."""
    out = []
    for node in nodes:
        if node.cond is not None:
            cond = under
            if cond is None and _reads_thread(node.cond, tainted):
                cond = node.cond
            out += _branch_syncs(node.children, tainted, syncs, cond)
        elif node.children:
            out += _branch_syncs(node.children, tainted, syncs, under)
        elif under is not None and ("__syncthreads" in node.text
                                    or _calls(node.text, syncs)):
            out.append((node.pos, under))
    return out


def _accum_type(name: str, suffix: str) -> Tuple[str, ...]:
    """The accumulator types an mma/wgmma instruction names: D (and C for
    ``mma.sync``, whose C type is last)."""
    types = [t for t in suffix.split(".") if t in _TYPES]
    if not types:
        return ()
    if name == "mma.sync":
        return (types[0], types[-1])
    return (types[0],)


def check_kernel(fn: _Function, fns: List[_Function], src: _Source,
                 syncs: Set[str]) -> List[Diagnostic]:
    """All four lints over one ``__global__`` kernel and its helpers."""
    out: List[Diagnostic] = []
    by_name: Dict[str, List[_Function]] = {}
    for f in fns:
        by_name.setdefault(f.name, []).append(f)
    reached = _reach(fn, by_name, src)

    def diag(rule: str, pos: int, message: str) -> None:
        out.append(Diagnostic(rule=rule, severity="error", message=message,
                              layer=fn.name,
                              location=f"{src.path}:{src.line(pos)}"))

    # lint.traced_branch, in the kernel and in each helper it reaches
    for f in reached:
        text = src.code[f.body[0]:f.body[1]]
        tainted = _tainted(text)
        nodes = _block(src.code, f.body[0] + 1, f.body[1] - 1)
        for pos, cond in _branch_syncs(nodes, tainted, syncs, None):
            diag("lint.traced_branch", pos,
                 f"__syncthreads() under `{' '.join(cond.split())}`, which "
                 f"reads the thread's id (in {f.name}); threads that skip it "
                 f"deadlock the block: hoist it, or use a named barrier")

    # lint.grid_alloc
    for f in reached:
        text = src.code[f.body[0]:f.body[1]]
        for m in re.finditer(r"\bmalloc\s*\(|\bnew\b", text):
            diag("lint.grid_alloc", f.body[0] + m.start(),
                 f"`{m.group(0).rstrip('(').strip()}` in a kernel body (in "
                 f"{f.name}): size shared memory at launch instead")

    # lint.accum_dtype and lint.dma_pairing read the inline PTX
    ptx = [(f, src.ptx(f.body[0], f.body[1])) for f in reached]
    for f, text in ptx:
        for m in _MMA.finditer(text):
            acc = _accum_type(m.group(1), m.group(2))
            if any(t != "f32" for t in acc):
                diag("lint.accum_dtype", f.body[0],
                     f"`{m.group(0)}` accumulates in {'/'.join(acc)} (in "
                     f"{f.name}); kernel accumulators must be f32")
    allptx = "\n".join(t for _, t in ptx)
    copies = re.search(r"cp\.async\.(?:commit_group|c[ag]\b)", allptx)
    waits = re.search(r"cp\.async\.wait_(?:group|all)", allptx)
    if bool(copies) != bool(waits):
        diag("lint.dma_pairing", fn.body[0],
             "cp.async " + ("copies with no cp.async.wait_group/wait_all"
                            if copies else "wait with no copy issued"))
    bulk = re.search(r"cp\.async\.bulk|mbarrier\.arrive\.expect_tx", allptx)
    bwait = re.search(r"mbarrier\.try_wait", allptx)
    if bool(bulk) != bool(bwait):
        diag("lint.dma_pairing", fn.body[0],
             "bulk copy / expect_tx with no mbarrier.try_wait" if bulk
             else "mbarrier.try_wait with no bulk copy or expect_tx")
    return out


def check_source(path: str) -> List[Diagnostic]:
    """Lint one CUDA source; an unreadable file surfaces as a diagnostic."""
    try:
        with open(path) as fh:
            text = fh.read()
    except (OSError, UnicodeDecodeError) as exc:
        return [Diagnostic(rule="lint.traced_branch", severity="error",
                           message=f"cannot read {path}: {exc}",
                           location=path)]
    src = _scan(path, text)
    fns = _functions(src)
    syncs = _sync_helpers(fns, src)
    out: List[Diagnostic] = []
    for fn in fns:
        if fn.kind == "__global__":
            out += check_kernel(fn, fns, src, syncs)
    return out


def kernels_of(path: str) -> List[str]:
    """The names of a source's ``__global__`` kernels (what is linted)."""
    with open(path) as fh:
        src = _scan(path, fh.read())
    return [f.name for f in _functions(src) if f.kind == "__global__"]


def check_paths(paths: Iterable[str]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for p in paths:
        out += check_source(p)
    return out
