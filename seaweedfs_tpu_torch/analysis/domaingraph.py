"""Execution-domain classification over the project call graph.

Since PR 18 every daemon runs three concurrency domains at once:

- ``loop``       — coroutines on the asyncio reactor (native GET routes,
  the reaper/lag-monitor/pump internals, the async transport) plus every
  sync function they call inline;
- ``handler``    — request handlers: ``JsonHandler`` ``_h_*`` methods
  and ``do_*`` verbs, which run on a per-connection thread under the
  threads core and on an ``aio-worker`` pool thread (via the
  ``copy_context().run`` + ``run_in_executor`` bridge) under the
  reactor;
- ``background`` — ``threading.Thread``/``Timer`` targets and plain
  executor submits: scrub, heartbeat, lifecycle, flume producers,
  replication drains.

This module computes, for every function the project indexes, the SET
of domains it can execute in, by seeding the known roots and
propagating forward through resolved call edges.  A function reachable
from more than one root kind is genuinely multi-domain — that is the
set the Eraser-style lockset rule (``racecheck.py``) intersects over.

Root seeds and bridge translations (the canonical domain map — also
documented in docs/LOCKS.md):

- every ``async def``                          → loop
- ``_h_*`` / ``do_*`` methods, ``_run_request`` → handler
- ``threading.Thread(target=f)`` / ``Timer``    → f background
- ``executor.submit(f, ...)``                   → f background
- ``loop.run_in_executor(pool, f, ...)``        → f handler (the pool
  is the reactor's bridged-handler pool; ``ctx.run`` wrappers unwrap)
- ``loop.call_soon*/call_later(f)``             → f loop
- ``ctx.run(f)`` called inline                  → ordinary call edge
  (``copy_context().run`` executes f in the CALLING domain; the bridge
  hop comes from the surrounding ``run_in_executor``)
- lambda targets: the calls inside the lambda body are rooted in the
  dispatch's domain

Like the rest of sweedlint the resolution is unsound-but-useful: an
unresolvable target contributes nothing, and an unreached function has
the empty domain set (the race rule skips it).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator, Optional

from .callgraph import CallGraph, FuncInfo, Project

LOOP = "loop"
HANDLER = "handler"
BACKGROUND = "background"

#: thread-dispatch constructors: Name/Attribute terminal → target style
_THREAD_CTORS = frozenset({"Thread", "Timer"})

#: handler-method name shapes (JsonHandler routing convention)
_HANDLER_NAMES = ("_h_",)
_HANDLER_VERBS = frozenset(
    {"do_GET", "do_HEAD", "do_POST", "do_PUT", "do_DELETE", "do_OPTIONS",
     "do_PATCH", "do_PROPFIND", "do_MKCOL", "do_MOVE", "do_COPY"}
)


@dataclass(frozen=True)
class Dispatch:
    """One site handing a callable to another execution domain."""

    kind: str            # "thread" | "submit" | "run_in_executor" | "call_soon"
    domain: str          # domain the target will run in
    call: ast.Call       # the dispatching call expression
    target: Optional[FuncInfo]   # resolved target, if any
    target_expr: Optional[ast.expr]  # the callable expression as written
    arg_exprs: tuple     # payload argument expressions riding along


@dataclass
class DomainGraph:
    """qualname → domains, plus the root evidence for diagnostics."""

    domains: dict[str, frozenset] = field(default_factory=dict)
    roots: dict[str, list] = field(default_factory=dict)  # qualname → [(domain, why)]

    def domains_of(self, qualname: str) -> frozenset:
        return self.domains.get(qualname, frozenset())

    def label(self, qualname: str) -> str:
        d = self.domains_of(qualname)
        if not d:
            return "unreached"
        if len(d) > 1:
            return "multi(" + "+".join(sorted(d)) + ")"
        return next(iter(d))


def _callable_name(expr: ast.expr) -> str:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


def _is_ctx_run(expr: ast.expr) -> bool:
    """``ctx.run`` / ``copy_context().run`` as a callable value."""
    return isinstance(expr, ast.Attribute) and expr.attr == "run"


def _resolve_callable(
    cg: CallGraph, fi: FuncInfo, env: dict, expr: ast.expr
) -> Optional[FuncInfo]:
    """FuncInfo a callable-valued expression denotes (``self._scrub``,
    a local/nested function name, a module function)."""
    p = cg.project
    mi = p.modules[fi.modname]
    if isinstance(expr, ast.Name):
        # nested def inside this function (thread targets commonly are)
        nested = p.functions.get(f"{fi.qualname}.{expr.id}")
        if nested is not None:
            return nested
        kind_target = mi.symbols.get(expr.id)
        if kind_target and kind_target[0] == "symbol":
            target = kind_target[1]
            if target in p.functions:
                return p.functions[target]
            if target in p.classes:
                return p.lookup_method(target, "__call__")
        return None
    if isinstance(expr, ast.Attribute):
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and fi.class_qualname:
            return p.lookup_method(fi.class_qualname, expr.attr)
        mod = p._expr_module(expr.value, mi)
        if mod is not None:
            return p.functions.get(f"{mod}.{expr.attr}")
        t = cg.expr_type(expr.value, fi, env)
        if t.cls:
            return p.lookup_method(t.cls, expr.attr)
    return None


def _dispatch_target(
    args: list, start: int
) -> tuple[Optional[ast.expr], tuple]:
    """(callable expr, payload args) starting at ``args[start]``,
    unwrapping one ``ctx.run`` indirection (``run_in_executor(pool,
    ctx.run, real_target, *a)``)."""
    if start >= len(args):
        return None, ()
    target = args[start]
    rest = tuple(args[start + 1:])
    if _is_ctx_run(target) and rest:
        return rest[0], tuple(rest[1:])
    return target, rest


def iter_dispatches(
    cg: CallGraph, fi: FuncInfo, env: Optional[dict] = None
) -> Iterator[Dispatch]:
    """Every domain-crossing dispatch site lexically inside ``fi``."""
    if env is None:
        env = cg.local_types(fi)
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Call):
            continue
        name = _callable_name(node.func)
        target_expr: Optional[ast.expr] = None
        payload: tuple = ()
        kind = domain = None
        if name in _THREAD_CTORS:
            # threading.Thread(target=f, args=(...)) / Timer(delay, f)
            for kw in node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
                elif kw.arg == "args" and isinstance(
                    kw.value, (ast.Tuple, ast.List)
                ):
                    payload = tuple(kw.value.elts)
            if target_expr is None and name == "Timer" and len(node.args) >= 2:
                target_expr = node.args[1]
                payload = tuple(node.args[2:])
            if target_expr is None:
                continue
            kind, domain = "thread", BACKGROUND
        elif name == "submit" and node.args:
            target_expr, payload = _dispatch_target(node.args, 0)
            kind, domain = "submit", BACKGROUND
        elif name == "run_in_executor" and len(node.args) >= 2:
            target_expr, payload = _dispatch_target(node.args, 1)
            kind, domain = "run_in_executor", HANDLER
        elif name in ("call_soon", "call_soon_threadsafe", "call_later",
                      "call_at"):
            start = 1 if name in ("call_later", "call_at") else 0
            target_expr, payload = _dispatch_target(node.args, start)
            kind, domain = "call_soon", LOOP
        else:
            continue
        if target_expr is None:
            continue
        target = None
        if not isinstance(target_expr, ast.Lambda):
            target = _resolve_callable(cg, fi, env, target_expr)
        yield Dispatch(kind, domain, node, target, target_expr, payload)


def _lambda_callees(
    cg: CallGraph, fi: FuncInfo, env: dict, lam: ast.Lambda
) -> list[FuncInfo]:
    out = []
    for node in ast.walk(lam.body):
        if isinstance(node, ast.Call):
            callee = cg.resolve_call(node, fi, env)
            if callee is None:
                callee = _resolve_callable(cg, fi, env, node.func)
            if callee is not None:
                out.append(callee)
    return out


def compute_domains(
    project: Project, callgraph: Optional[CallGraph] = None
) -> DomainGraph:
    project.index()
    cg = callgraph or CallGraph(project)
    dg = DomainGraph()
    domains: dict[str, set] = {}
    roots: dict[str, list] = {}

    def seed(fi: Optional[FuncInfo], domain: str, why: str) -> None:
        if fi is None:
            return
        domains.setdefault(fi.qualname, set()).add(domain)
        roots.setdefault(fi.qualname, []).append((domain, why))

    # -- roots ---------------------------------------------------------------
    funcs = sorted(project.functions.values(), key=lambda f: f.qualname)
    for fi in funcs:
        if isinstance(fi.node, ast.AsyncFunctionDef):
            seed(fi, LOOP, "async def")
        elif fi.class_qualname and (
            fi.name.startswith(_HANDLER_NAMES) or fi.name in _HANDLER_VERBS
        ):
            seed(fi, HANDLER, "request handler method")
        elif fi.name == "_run_request":
            seed(fi, HANDLER, "bridged-handler executor target")

    # dispatch sites (thread targets, submits, bridges, loop callbacks)
    envs: dict[str, dict] = {}
    for fi in funcs:
        env = envs.setdefault(fi.qualname, cg.local_types(fi))
        for d in iter_dispatches(cg, fi, env):
            if isinstance(d.target_expr, ast.Lambda):
                for callee in _lambda_callees(cg, fi, env, d.target_expr):
                    if not isinstance(callee.node, ast.AsyncFunctionDef):
                        seed(callee, d.domain,
                             f"lambda {d.kind} target callee")
                continue
            if d.target is not None and not isinstance(
                d.target.node, ast.AsyncFunctionDef
            ):
                seed(d.target, d.domain, f"{d.kind} target")

    # -- propagation ---------------------------------------------------------
    # one resolved-call edge list, then a worklist to the fixpoint.
    # async callees do not inherit the caller's domains: calling a
    # coroutine function only creates the coroutine — it executes on
    # the loop, which rule one already seeded.
    edges: dict[str, set] = {}
    for fi in funcs:
        outs = edges.setdefault(fi.qualname, set())
        env = envs[fi.qualname]
        for call, callee in cg.calls_in(fi):
            if callee is None:
                # inline context.run(f, ...): f runs right here
                if _is_ctx_run(call.func) and call.args:
                    t = _resolve_callable(cg, fi, env, call.args[0])
                    if t is not None and not isinstance(
                        t.node, ast.AsyncFunctionDef
                    ):
                        outs.add(t.qualname)
                continue
            if isinstance(callee.node, ast.AsyncFunctionDef):
                continue
            outs.add(callee.qualname)

    work = [qn for qn in domains]
    while work:
        qn = work.pop()
        d = domains.get(qn)
        if not d:
            continue
        for callee_qn in edges.get(qn, ()):
            cur = domains.setdefault(callee_qn, set())
            before = len(cur)
            cur |= d
            if len(cur) != before:
                work.append(callee_qn)

    dg.domains = {qn: frozenset(ds) for qn, ds in domains.items() if ds}
    dg.roots = roots
    return dg
