"""``tainted-size``: wire-derived values used as seek/read/slice/alloc
sizes without passing through ``util/parsers.py``.

The strict-int rule (PR 2) catches ``int(q.get("size"))`` at the parse
site; this rule catches what strict-int structurally cannot — a raw
request value handed *as-is* (or through helper functions) into an
offset/length position:

    n = q.get("offset")          # still a str, no int() to flag
    self._serve_from(f, n)       # helper does f.seek(n)

Sources are reads off request-shaped dicts (query params, headers,
parsed bodies — the same ``_REQUESTISH`` name set strict-int uses).
Sinks are ``.seek(x)`` / ``.read(x)`` / ``bytearray(x)`` calls and
slice bounds.  Sanitizers are the shared wire parsers
(``parse_ascii_uint``, ``tolerant_uint``, ``tolerant_ufloat``,
``parse_byte_range``, ``parse_content_length``) plus ``len``/``min``/
``max`` clamps.  Taint propagates through assignments inside a function
and through call arguments into project functions (bounded depth); an
interprocedural finding is reported at the *call site* where the wire
value escapes, naming the chain to the sink.

Scope: ``server/``, ``s3api/``, ``messaging/``, ``query/`` — the layers
that parse requests.  ``query/`` joined the scope when it grew the
SelectObjectContent protocol (select.py): Expression text and the
serialization fields come straight off the wire, and the event-stream
encoder computes frame lengths from them, so a raw request value
reaching a size position there is exactly the bug class this rule
exists for.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from . import Violation
from .callgraph import CallGraph, FuncInfo, Project
from .rules import _REQUESTISH, _terminal_name

_SCOPES = ("server/", "s3api/", "messaging/", "query/")

_SANITIZERS = frozenset(
    {
        "parse_ascii_uint",
        "tolerant_uint",
        "tolerant_ufloat",
        "parse_byte_range",
        "parse_content_length",
        "len",
        "min",
        "max",
    }
)

_SINK_METHODS = frozenset({"seek", "read"})
# bytes(x) is overwhelmingly the copy constructor in this codebase;
# bytearray(n) is the allocate-n-zeros idiom — only the latter is a
# size sink.
_SINK_CTORS = frozenset({"bytearray"})

MAX_DEPTH = 3


@dataclass(frozen=True)
class SinkHit:
    desc: str  # "f.seek(...)" etc.
    relpath: str
    line: int
    chain: str


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _is_source(node: ast.AST) -> bool:
    """``q.get(...)`` / ``headers[...]`` — a value straight off the wire."""
    if isinstance(node, ast.Call):
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "get"
            and _terminal_name(f.value) in _REQUESTISH
        ):
            return True
    if isinstance(node, ast.Subscript):
        if _terminal_name(node.value) in _REQUESTISH:
            return True
    return False


class _FnTaint:
    """Single-function forward taint pass."""

    def __init__(
        self,
        checker: "TaintChecker",
        fi: FuncInfo,
        tainted_params: frozenset[str] = frozenset(),
        seen: frozenset = frozenset(),
        depth: int = MAX_DEPTH,
    ):
        self.checker = checker
        self.fi = fi
        self.depth = depth
        self.seen = seen | {(fi.qualname, tainted_params)}
        self.tainted: set[str] = set(tainted_params)
        self.hits: list[SinkHit] = []
        self.env = checker.cg.local_types(fi)
        for stmt in fi.node.body:
            self._stmt(stmt)

    # -- expression taint -----------------------------------------------------
    def _expr_tainted(self, expr: ast.AST) -> bool:
        """True when the expression carries wire data that no sanitizer
        call wraps."""
        if expr is None:
            return False
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and _call_name(node) in _SANITIZERS:
                return False  # a sanitizer anywhere in the expr clamps it
        for node in ast.walk(expr):
            if _is_source(node):
                return True
            if isinstance(node, ast.Name) and node.id in self.tainted:
                return True
        return False

    # -- statements -----------------------------------------------------------
    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(stmt, ast.Assign):
            t = self._expr_tainted(stmt.value)
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    if t:
                        self.tainted.add(tgt.id)
                    else:
                        self.tainted.discard(tgt.id)
            self._scan_expr(stmt.value)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if isinstance(stmt.target, ast.Name):
                if self._expr_tainted(stmt.value):
                    self.tainted.add(stmt.target.id)
                else:
                    self.tainted.discard(stmt.target.id)
            self._scan_expr(stmt.value)
            return
        if isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name) and self._expr_tainted(stmt.value):
                self.tainted.add(stmt.target.id)
            self._scan_expr(stmt.value)
            return
        # compound statements: scan guard expressions, then bodies in order
        for field_name in ("test", "iter", "value", "exc"):
            sub = getattr(stmt, field_name, None)
            if isinstance(sub, ast.expr):
                self._scan_expr(sub)
        if isinstance(stmt, ast.Expr):
            self._scan_expr(stmt.value)
        for body_field in ("body", "orelse", "finalbody"):
            for sub in getattr(stmt, body_field, []) or []:
                if isinstance(sub, ast.stmt):
                    self._stmt(sub)
        for handler in getattr(stmt, "handlers", []) or []:
            for sub in handler.body:
                self._stmt(sub)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr)

    # -- sinks ----------------------------------------------------------------
    def _scan_expr(self, expr: ast.AST) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Slice
            ):
                for bound in (node.slice.lower, node.slice.upper, node.slice.step):
                    if bound is not None and self._expr_tainted(bound):
                        self.hits.append(
                            SinkHit(
                                "slice bound",
                                self.fi.relpath,
                                node.lineno,
                                "",
                            )
                        )
                        break

    def _check_call(self, call: ast.Call) -> None:
        name = _call_name(call)
        f = call.func
        # direct sinks
        if (
            isinstance(f, ast.Attribute)
            and name in _SINK_METHODS
            and call.args
            and self._expr_tainted(call.args[0])
        ):
            self.hits.append(
                SinkHit(
                    f".{name}() size/offset",
                    self.fi.relpath,
                    call.lineno,
                    "",
                )
            )
            return
        if (
            isinstance(f, ast.Name)
            and name in _SINK_CTORS
            and len(call.args) == 1
            and self._expr_tainted(call.args[0])
        ):
            self.hits.append(
                SinkHit(
                    f"{name}() allocation size",
                    self.fi.relpath,
                    call.lineno,
                    "",
                )
            )
            return
        # interprocedural: tainted arg into a project function
        if self.depth <= 1:
            return
        tainted_idx = [
            i for i, a in enumerate(call.args) if self._expr_tainted(a)
        ]
        if not tainted_idx:
            return
        callee = self.checker.cg.resolve_call(call, self.fi, self.env)
        if callee is None:
            return
        params = self.checker.param_names(callee)
        tainted_params = frozenset(
            params[i] for i in tainted_idx if i < len(params)
        )
        for kw in call.keywords:
            if kw.arg and kw.arg in params and self._expr_tainted(kw.value):
                tainted_params = tainted_params | {kw.arg}
        if not tainted_params:
            return
        for hit in self.checker.param_sinks(
            callee, tainted_params, self.seen, self.depth - 1
        ):
            chain = f"via {callee.name}" + (f" {hit.chain}" if hit.chain else "")
            self.hits.append(
                SinkHit(hit.desc, self.fi.relpath, call.lineno, chain)
            )


class TaintChecker:
    def __init__(self, project: Project, callgraph: Optional[CallGraph] = None):
        project.index()
        self.project = project
        self.cg = callgraph or CallGraph(project)
        self._param_cache: dict[tuple[str, frozenset], list[SinkHit]] = {}

    @staticmethod
    def param_names(fi: FuncInfo) -> list[str]:
        args = fi.node.args
        names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
        if names and names[0] in ("self", "cls"):
            names = names[1:]
            # positional args at a method call site don't count self
        return names

    def param_sinks(
        self,
        fi: FuncInfo,
        tainted_params: frozenset[str],
        seen: frozenset,
        depth: int,
    ) -> list[SinkHit]:
        key = (fi.qualname, tainted_params)
        if key in self._param_cache:
            return self._param_cache[key]
        if (fi.qualname, tainted_params) in seen or depth <= 0:
            return []
        pass_ = _FnTaint(self, fi, tainted_params, seen, depth)
        hits = pass_.hits
        if depth == MAX_DEPTH - 1:
            self._param_cache[key] = hits
        return hits

    def violations(self) -> list[Violation]:
        out: list[Violation] = []
        dedupe: set[tuple[str, int]] = set()
        for fi in sorted(self.project.functions.values(), key=lambda f: f.qualname):
            if not any(s in fi.relpath for s in _SCOPES):
                continue
            pass_ = _FnTaint(self, fi)
            for hit in pass_.hits:
                key = (hit.relpath, hit.line)
                if key in dedupe:
                    continue
                dedupe.add(key)
                where = f" ({hit.chain})" if hit.chain else ""
                out.append(
                    Violation(
                        "tainted-size",
                        hit.relpath,
                        hit.line,
                        f"wire-derived value reaches {hit.desc}{where} "
                        "without util/parsers.py; parse with "
                        "parse_ascii_uint/tolerant_uint first",
                    )
                )
        return out


def check_project(project: Project) -> list[Violation]:
    return TaintChecker(project).violations()
