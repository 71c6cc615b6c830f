"""Lock-order graph + blocking-under-lock: the interprocedural
concurrency rules.

For every ``with <lock>:`` region in the project this module computes —
directly and transitively through the call graph, bounded depth — the
set of locks acquired inside it and the blocking operations reachable
from it.  Two rules come out of that one traversal:

- ``lock-order``          — the acquisition edges form a directed graph
  (L → M when M is taken while L is held); any cycle is a potential
  ABBA deadlock (RacerD's core check).  One violation per cycle,
  anchored at the lexically-first edge site.
- ``blocking-under-lock`` — a network/disk/sleep call (peer RPCs through
  the pooled transport, ``socket.*``, ``subprocess.*``, ``time.sleep``,
  ``Future.result``, ``os.fsync``) reachable while a lock is held turns
  that lock into a convoy: every other thread needing it waits out the
  RPC.  The step-down pattern (PR 2) is the fix — release, do the slow
  thing, re-take the lock and re-validate state.

Methods named ``*_locked`` follow the repo convention (documented in
``docs/ANALYSIS.md``): they are called with their class's locks already
held, so their bodies are analyzed as held regions and their own
acquisitions become edges from every class lock.

The computed :class:`LockGraph` is also the static half of the
``OrderedLock`` cross-check (``util/locks.py``): the tier-1 test runs
the concurrency suites under ``SWEED_LOCK_CHECK=1`` and asserts every
dynamically observed edge appears here (static ⊇ dynamic).  Node ids
therefore match the runtime names: the string literal passed to
``make_lock``/``make_rlock`` when present, ``Class.attr`` otherwise.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from . import Violation
from .callgraph import CallGraph, ClassInfo, FuncInfo, Project

#: factory name → lock kind; the ``make_*`` forms are the runtime
#: sanitizer wrappers in ``util/locks.py``.  ``asyncio.Lock`` resolves
#: to the *async* kinds below instead (same factory names, different
#: module): an asyncio lock participates in lock-order cycle detection
#: like any other node, but it only excludes coroutines on ONE loop —
#: it is no protection against a worker/background thread, which is why
#: the cross-domain race rule (``racecheck.py``) ignores async kinds
#: when intersecting locksets.
LOCK_FACTORIES = {
    "Lock": "lock",
    "RLock": "rlock",
    "make_lock": "lock",
    "make_rlock": "rlock",
    "OrderedLock": "lock",
}
#: asyncio.* equivalents — kind "alock"/"acond"
ASYNC_LOCK_KINDS = {
    "Lock": "alock",
    "Condition": "acond",
}
#: lock kinds that provide mutual exclusion across OS threads (the only
#: kinds a cross-domain lockset intersection may count)
THREAD_LOCK_KINDS = frozenset({"lock", "rlock"})
_CONDITION_FACTORIES = ("Condition", "make_condition")
#: factories whose module-level locks carry a sanitizer name (the node id)
_MODULE_LOCK_FACTORIES = ("make_lock", "make_rlock")

_SCOPES = ("cluster/", "server/", "storage/", "messaging/")

#: transitive traversal depth for acquisition / blocking summaries
MAX_DEPTH = 6

#: stdlib modules whose every call blocks (network / process / clock)
_BLOCKING_MODULES = ("socket", "subprocess")

#: pooled-transport entry points in server/http_util.py — every one of
#: them performs a network round-trip
_TRANSPORT_FUNCS = frozenset(
    {
        "http_json",
        "http_bytes",
        "http_bytes_headers",
        "http_stream_request",
        "http_stream_response",
        "_pooled_request",
    }
)

#: thread-bridge constructs a NATIVE-async handler (``async def
#: *_native``) must never touch: native routes exist to skip the
#: worker-thread hop, so re-introducing the flume/executor bridge inside
#: one silently pays the hop the route was split to remove. Flagged even
#: when awaited — awaiting a thread hop still schedules the thread.
_NATIVE_BRIDGE = frozenset(
    {"ThreadFlume", "run_in_executor", "_run_request"}
)

#: torch.distributed collectives: dispatching one is a synchronization
#: point for EVERY rank in the process group, so doing it while holding a
#: product lock convoys the whole fleet behind one node's lock (and
#: deadlocks outright if another rank needs that lock to reach its own
#: dispatch).  The process-group calls (init/destroy/new_group) block on
#: their peers the same way.
_COLLECTIVE_NAMES = frozenset(
    {
        "all_reduce",
        "all_gather",
        "all_gather_into_tensor",
        "all_gather_object",
        "broadcast",
        "broadcast_object_list",
        "reduce",
        "reduce_scatter",
        "reduce_scatter_tensor",
        "all_to_all",
        "all_to_all_single",
        "gather",
        "scatter",
        "send",
        "recv",
        "barrier",
        "monitored_barrier",
    }
)
_PROCESS_GROUP_NAMES = frozenset(
    {"init_process_group", "destroy_process_group", "new_group"}
)
_DIST_MODULE = "torch.distributed"


@dataclass(frozen=True)
class Site:
    relpath: str
    line: int
    chain: str  # "" for direct, "via _persist" etc. for transitive


@dataclass(frozen=True)
class LockDecl:
    node_id: str
    cls: str  # owning class qualname
    attr: str
    kind: str  # "lock" | "rlock"
    relpath: str
    line: int


class LockGraph:
    def __init__(self) -> None:
        self.decls: dict[str, LockDecl] = {}  # node_id → decl
        self.edges: dict[tuple[str, str], list[Site]] = {}

    def add_edge(self, a: str, b: str, site: Site) -> None:
        if a == b:
            return  # name-level granularity: reentrancy, not an order edge
        self.edges.setdefault((a, b), []).append(site)

    def edge_set(self) -> set[tuple[str, str]]:
        return set(self.edges)

    def cycles(self) -> list[list[str]]:
        """Strongly connected components with ≥ 2 nodes, each a potential
        ABBA deadlock, deterministically ordered."""
        graph: dict[str, set[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        counter = [0]
        sccs: list[list[str]] = []

        def strongconnect(v: str) -> None:
            # iterative Tarjan: (node, child-iterator) frames
            work = [(v, iter(sorted(graph[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(graph[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        return sorted(sccs)

    def to_dict(self) -> dict:
        return {
            "nodes": sorted(self.decls),
            "edges": sorted(
                [a, b, f"{s[0].relpath}:{s[0].line}"]
                for (a, b), s in self.edges.items()
            ),
        }


class LockGraphBuilder:
    """One pass over the project computing lock declarations, acquisition
    and blocking summaries, the lock-order graph, and both rules'
    violations."""

    def __init__(self, project: Project, callgraph: Optional[CallGraph] = None):
        project.index()
        self.project = project
        self.cg = callgraph or CallGraph(project)
        self.graph = LockGraph()
        # (class qualname, attr) → node_id (aliases resolved)
        self._decl_by_attr: dict[tuple[str, str], str] = {}
        # (module name, global name) → node_id of a module-level lock
        self._module_locks: dict[tuple[str, str], str] = {}
        self._acq_summaries: dict[str, dict[str, Site]] = {}
        self._blk_summaries: dict[str, dict[str, Site]] = {}
        self._lock_order_v: list[Violation] = []
        self._blocking_v: list[Violation] = []
        self._loop_v: list[Violation] = []
        self._collective_v: list[Violation] = []
        self._col_summaries: dict[str, dict[str, Site]] = {}
        self._collect_decls()
        self._build()
        self._build_loop_rule()

    # -- lock declarations ----------------------------------------------------
    def _is_asyncio_factory(self, call: ast.Call, mi) -> bool:
        """True when the factory call resolves into the asyncio module
        (``asyncio.Lock()``, ``aio.Condition()`` after ``import asyncio
        as aio``, ``Lock()`` after ``from asyncio import Lock``)."""
        f = call.func
        if isinstance(f, ast.Attribute):
            mod = self.project._expr_module(f.value, mi)
            return mod is not None and mod.split(".")[0] == "asyncio"
        if isinstance(f, ast.Name):
            kind_target = mi.symbols.get(f.id)
            return bool(
                kind_target
                and kind_target[0] == "symbol"
                and kind_target[1].startswith("asyncio.")
            )
        return False

    def _collect_decls(self) -> None:
        for mi in self.project.modules.values():
            # module-level sanitizer locks: ``_x = make_lock("mod._x")``
            for node in mi.tree.body:
                if not (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id in _MODULE_LOCK_FACTORIES
                ):
                    continue
                node_id = self._literal_name(node.value)
                if node_id is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.graph.decls.setdefault(
                            node_id,
                            LockDecl(
                                node_id, mi.modname, tgt.id,
                                LOCK_FACTORIES[node.value.func.id],
                                mi.relpath, node.lineno,
                            ),
                        )
                        self._module_locks[(mi.modname, tgt.id)] = node_id
        for ci in self.project.classes.values():
            mi = self.project.modules[ci.modname]
            pending_conditions: list[tuple[str, ast.Call, int]] = []
            for node in ast.walk(ci.node):
                if not isinstance(node, ast.Assign):
                    continue
                call = node.value
                if not isinstance(call, ast.Call):
                    continue
                fname = (
                    call.func.attr
                    if isinstance(call.func, ast.Attribute)
                    else call.func.id
                    if isinstance(call.func, ast.Name)
                    else ""
                )
                is_async = (
                    fname in ASYNC_LOCK_KINDS
                    and self._is_asyncio_factory(call, mi)
                )
                for tgt in node.targets:
                    if not (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        continue
                    if is_async:
                        # asyncio primitives carry no name argument; the
                        # node id is always Class.attr
                        node_id = f"{ci.name}.{tgt.attr}"
                        decl = LockDecl(
                            node_id, ci.qualname, tgt.attr,
                            ASYNC_LOCK_KINDS[fname], ci.relpath, node.lineno,
                        )
                        self.graph.decls.setdefault(node_id, decl)
                        self._decl_by_attr[(ci.qualname, tgt.attr)] = node_id
                    elif fname in LOCK_FACTORIES:
                        node_id = self._literal_name(call) or f"{ci.name}.{tgt.attr}"
                        decl = LockDecl(
                            node_id, ci.qualname, tgt.attr,
                            LOCK_FACTORIES[fname], ci.relpath, node.lineno,
                        )
                        self.graph.decls.setdefault(node_id, decl)
                        self._decl_by_attr[(ci.qualname, tgt.attr)] = node_id
                    elif fname in _CONDITION_FACTORIES:
                        pending_conditions.append((tgt.attr, call, node.lineno))
            for attr, call, line in pending_conditions:
                # Condition(self.X) shares X's underlying lock: alias it
                alias = None
                if call.args:
                    a0 = call.args[0]
                    if (
                        isinstance(a0, ast.Attribute)
                        and isinstance(a0.value, ast.Name)
                        and a0.value.id == "self"
                    ):
                        alias = self._decl_by_attr.get((ci.qualname, a0.attr))
                if alias is None:
                    alias = self._literal_name(call) or f"{ci.name}.{attr}"
                    self.graph.decls.setdefault(
                        alias,
                        LockDecl(alias, ci.qualname, attr, "lock", ci.relpath, line),
                    )
                self._decl_by_attr[(ci.qualname, attr)] = alias

    def _module_lock_for(self, name: str, fi: FuncInfo) -> Optional[str]:
        node_id = self._module_locks.get((fi.modname, name))
        if node_id is not None:
            return node_id
        kind_target = self.project.modules[fi.modname].symbols.get(name)
        if kind_target and kind_target[0] == "symbol":
            mod, _, sym = kind_target[1].rpartition(".")
            return self._module_locks.get((mod, sym))
        return None

    @staticmethod
    def _literal_name(call: ast.Call) -> Optional[str]:
        for a in call.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
        return None

    def _lock_node_for(
        self, expr: ast.expr, fi: FuncInfo, env: dict
    ) -> Optional[str]:
        """Node id when ``expr`` is a lock attribute (``self._lock``,
        ``layout._lock`` with ``layout`` typed) or a module-level
        sanitizer lock (``_x = make_lock("mod._x")``, here or imported)."""
        if isinstance(expr, ast.Name):
            return self._module_lock_for(expr.id, fi)
        if not isinstance(expr, ast.Attribute):
            return None
        base_cls: Optional[str] = None
        if isinstance(expr.value, ast.Name) and expr.value.id == "self":
            base_cls = fi.class_qualname
        else:
            t = self.cg.expr_type(expr.value, fi, env)
            base_cls = t.cls
        if base_cls is None:
            return None
        for ci in self.project.mro(base_cls):
            node_id = self._decl_by_attr.get((ci.qualname, expr.attr))
            if node_id is not None:
                return node_id
        return None

    # -- summaries ------------------------------------------------------------
    def _acquired_in(self, fi: FuncInfo, depth: int, seen: frozenset) -> dict[str, Site]:
        """node_id → first site where ``fi`` (transitively) acquires it."""
        if fi.qualname in self._acq_summaries:
            return self._acq_summaries[fi.qualname]
        if depth <= 0 or fi.qualname in seen:
            return {}
        seen = seen | {fi.qualname}
        out: dict[str, Site] = {}
        env = self.cg.local_types(fi)

        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        node_id = self._lock_node_for(item.context_expr, fi, env)
                        if node_id is not None:
                            out.setdefault(
                                node_id, Site(fi.relpath, item.context_expr.lineno, "")
                            )
                if isinstance(child, ast.Call):
                    callee = self.cg.resolve_call(child, fi, env)
                    if callee is not None and callee.qualname not in seen:
                        for node_id, s in self._acquired_in(
                            callee, depth - 1, seen
                        ).items():
                            chain = f"via {callee.name}" + (
                                f" {s.chain}" if s.chain else ""
                            )
                            out.setdefault(
                                node_id, Site(fi.relpath, child.lineno, chain)
                            )
                visit(child)

        visit(fi.node)
        if depth == MAX_DEPTH:  # only cache complete summaries
            self._acq_summaries[fi.qualname] = out
        return out

    def _is_blocking_call(self, call: ast.Call, fi: FuncInfo, env: dict) -> Optional[str]:
        """Short description when the call itself blocks, else None."""
        p = self.project
        mi = p.modules[fi.modname]
        f = call.func
        if isinstance(f, ast.Attribute):
            mod = p._expr_module(f.value, mi)
            if mod is not None:
                top = mod.split(".")[0]
                if top == "time" and f.attr == "sleep":
                    return "time.sleep"
                if top in _BLOCKING_MODULES:
                    return f"{top}.{f.attr}"
                if top == "os" and f.attr == "fsync":
                    return "os.fsync"
                if mod == "urllib.request" and f.attr == "urlopen":
                    return "urllib.request.urlopen"
            if f.attr == "result" and len(call.args) <= 1:
                return "Future.result"
        elif isinstance(f, ast.Name):
            kind_target = mi.symbols.get(f.id)
            if kind_target and kind_target[0] == "symbol":
                target = kind_target[1]
                if target == "time.sleep":
                    return "time.sleep"
                if target == "os.fsync":
                    return "os.fsync"
                mod, _, name = target.rpartition(".")
                if mod.split(".")[0] in _BLOCKING_MODULES:
                    return target
        # pooled transport helpers, wherever they were imported from
        callee = self.cg.resolve_call(call, fi, env)
        if (
            callee is not None
            and callee.name in _TRANSPORT_FUNCS
            and callee.modname.endswith("http_util")
        ):
            return f"pooled transport {callee.name}"
        return None

    def _is_collective_call(
        self, call: ast.Call, fi: FuncInfo, env: dict
    ) -> Optional[str]:
        """Short description when the call dispatches a torch.distributed
        collective / process-group synchronization point, else None."""
        p = self.project
        mi = p.modules[fi.modname]
        f = call.func
        name = None
        if isinstance(f, ast.Attribute):
            if p._expr_module(f.value, mi) == _DIST_MODULE:
                name = f.attr
        elif isinstance(f, ast.Name):
            kind_target = mi.symbols.get(f.id)
            if kind_target and kind_target[0] == "symbol":
                mod, _, sym = kind_target[1].rpartition(".")
                if mod == _DIST_MODULE:
                    name = sym
        if name in _COLLECTIVE_NAMES or name in _PROCESS_GROUP_NAMES:
            return f"{_DIST_MODULE}.{name}"
        return None

    def _collective_in(
        self, fi: FuncInfo, depth: int, seen: frozenset
    ) -> dict[str, Site]:
        """description → first site of a collective dispatch reachable
        from fi (the collective mirror of :meth:`_blocking_in`)."""
        if fi.qualname in self._col_summaries:
            return self._col_summaries[fi.qualname]
        if depth <= 0 or fi.qualname in seen:
            return {}
        seen = seen | {fi.qualname}
        out: dict[str, Site] = {}
        env = self.cg.local_types(fi)

        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(child, ast.Call):
                    desc = self._is_collective_call(child, fi, env)
                    if desc is not None:
                        out.setdefault(desc, Site(fi.relpath, child.lineno, ""))
                    else:
                        callee = self.cg.resolve_call(child, fi, env)
                        if callee is not None and callee.qualname not in seen:
                            for desc, s in self._collective_in(
                                callee, depth - 1, seen
                            ).items():
                                chain = f"via {callee.name}" + (
                                    f" {s.chain}" if s.chain else ""
                                )
                                out.setdefault(
                                    desc, Site(fi.relpath, child.lineno, chain)
                                )
                visit(child)

        visit(fi.node)
        if depth == MAX_DEPTH:
            self._col_summaries[fi.qualname] = out
        return out

    def _blocking_in(self, fi: FuncInfo, depth: int, seen: frozenset) -> dict[str, Site]:
        """description → first site of a blocking op reachable from fi."""
        if fi.qualname in self._blk_summaries:
            return self._blk_summaries[fi.qualname]
        if depth <= 0 or fi.qualname in seen:
            return {}
        seen = seen | {fi.qualname}
        out: dict[str, Site] = {}
        env = self.cg.local_types(fi)

        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(child, ast.Call):
                    desc = self._is_blocking_call(child, fi, env)
                    if desc is not None:
                        out.setdefault(desc, Site(fi.relpath, child.lineno, ""))
                    else:
                        callee = self.cg.resolve_call(child, fi, env)
                        if callee is not None and callee.qualname not in seen:
                            for desc, s in self._blocking_in(
                                callee, depth - 1, seen
                            ).items():
                                chain = f"via {callee.name}" + (
                                    f" {s.chain}" if s.chain else ""
                                )
                                out.setdefault(
                                    desc, Site(fi.relpath, child.lineno, chain)
                                )
                visit(child)

        visit(fi.node)
        if depth == MAX_DEPTH:
            self._blk_summaries[fi.qualname] = out
        return out

    # -- regions + edges ------------------------------------------------------
    def _build(self) -> None:
        blocking_seen: set[tuple[str, int, str]] = set()
        for fi in sorted(self.project.functions.values(), key=lambda f: f.qualname):
            held0: list[str] = []
            if fi.class_qualname and "_locked" in fi.name:
                ci = self.project.classes.get(fi.class_qualname)
                if ci is not None:
                    held0 = sorted(
                        {
                            node_id
                            for (cls, _a), node_id in self._decl_by_attr.items()
                            if any(m.qualname == cls for m in self.project.mro(ci.qualname))
                        }
                    )
            env = self.cg.local_types(fi)
            self._walk_region(fi, fi.node, held0, env, blocking_seen)

    def _walk_region(
        self,
        fi: FuncInfo,
        node: ast.AST,
        held: list[str],
        env: dict,
        blocking_seen: set,
    ) -> None:
        for child in ast.iter_child_nodes(node):
            self._visit_node(fi, child, held, env, blocking_seen)

    def _visit_node(
        self,
        fi: FuncInfo,
        child: ast.AST,
        held: list[str],
        env: dict,
        blocking_seen: set,
    ) -> None:
        if isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            # nested def = thread target/callback: runs later, locks
            # held NOW are not held THEN (it is analyzed on its own)
            return
        if isinstance(child, (ast.With, ast.AsyncWith)):
            acquired: list[str] = []
            for item in child.items:
                node_id = self._lock_node_for(item.context_expr, fi, env)
                if node_id is not None:
                    site = Site(fi.relpath, item.context_expr.lineno, "")
                    for h in held:
                        self.graph.add_edge(h, node_id, site)
                    acquired.append(node_id)
                else:
                    self._walk_region(
                        fi, item.context_expr, held, env, blocking_seen
                    )
            inner = held + [a for a in acquired if a not in held]
            # visit the body statements THEMSELVES (a with nested directly
            # in another with must register its acquisition), not just
            # their children
            for stmt in child.body:
                self._visit_node(fi, stmt, inner, env, blocking_seen)
            return
        if isinstance(child, ast.Call) and held:
            self._check_call(fi, child, held, env, blocking_seen)
        self._walk_region(fi, child, held, env, blocking_seen)

    def _check_call(
        self, fi: FuncInfo, call: ast.Call, held: list[str], env: dict,
        blocking_seen: set,
    ) -> None:
        in_scope = any(s in fi.relpath for s in _SCOPES)
        desc = self._is_blocking_call(call, fi, env)
        if desc is not None:
            if in_scope:
                key = (fi.relpath, call.lineno, desc)
                if key not in blocking_seen:
                    blocking_seen.add(key)
                    self._blocking_v.append(
                        Violation(
                            "blocking-under-lock",
                            fi.relpath,
                            call.lineno,
                            f"{desc} while holding {held[-1]}; release the "
                            "lock around the slow call and re-validate "
                            "state after (docs/LOCKS.md)",
                        )
                    )
            return
        cdesc = self._is_collective_call(call, fi, env)
        if cdesc is not None:
            if in_scope:
                key = (fi.relpath, call.lineno, cdesc)
                if key not in blocking_seen:
                    blocking_seen.add(key)
                    self._collective_v.append(
                        Violation(
                            "collective-under-lock",
                            fi.relpath,
                            call.lineno,
                            f"{cdesc} while holding {held[-1]}; a mesh "
                            "collective synchronizes EVERY process, so one "
                            "node's lock convoys the fleet (deadlock if a "
                            "peer needs the lock to reach its own "
                            "dispatch) — dispatch outside the lock "
                            "(docs/ANALYSIS.md)",
                        )
                    )
            return
        callee = self.cg.resolve_call(call, fi, env)
        if callee is None:
            return
        for node_id, s in self._acquired_in(
            callee, MAX_DEPTH - 1, frozenset({fi.qualname})
        ).items():
            chain = f"via {callee.name}" + (f" {s.chain}" if s.chain else "")
            for h in held:
                self.graph.add_edge(h, node_id, Site(fi.relpath, call.lineno, chain))
        if in_scope and not callee.name.endswith("_locked"):
            # a *_locked callee is analyzed as lock-holding in its own
            # right — it reports (or waives) its blocking calls at the
            # precise site; re-reporting at every caller is noise
            blocking = self._blocking_in(
                callee, MAX_DEPTH - 1, frozenset({fi.qualname})
            )
            for desc, s in sorted(blocking.items()):
                key = (fi.relpath, call.lineno, desc)
                if key in blocking_seen:
                    continue
                blocking_seen.add(key)
                chain = f"{callee.name}" + (f" {s.chain}" if s.chain else "")
                self._blocking_v.append(
                    Violation(
                        "blocking-under-lock",
                        fi.relpath,
                        call.lineno,
                        f"{desc} (via {chain}, {s.relpath}:{s.line}) "
                        f"reachable while holding {held[-1]}; release the "
                        "lock around the slow call and re-validate state "
                        "after (docs/LOCKS.md)",
                    )
                )
            collectives = self._collective_in(
                callee, MAX_DEPTH - 1, frozenset({fi.qualname})
            )
            for desc, s in sorted(collectives.items()):
                key = (fi.relpath, call.lineno, desc)
                if key in blocking_seen:
                    continue
                blocking_seen.add(key)
                chain = f"{callee.name}" + (f" {s.chain}" if s.chain else "")
                self._collective_v.append(
                    Violation(
                        "collective-under-lock",
                        fi.relpath,
                        call.lineno,
                        f"{desc} (via {chain}, {s.relpath}:{s.line}) "
                        f"reachable while holding {held[-1]}; a mesh "
                        "collective synchronizes EVERY process, so one "
                        "node's lock convoys the fleet — dispatch outside "
                        "the lock (docs/ANALYSIS.md)",
                    )
                )

    # -- blocking-on-loop ------------------------------------------------------
    def _build_loop_rule(self) -> None:
        """``blocking-on-loop``: the event-loop mirror of
        blocking-under-lock. A blocking call (socket, fsync, sleep,
        pooled HTTP, ``Future.result``) executed inside an ``async def``
        — directly or transitively through sync project callees — runs
        ON the reactor thread and stalls every connection the loop
        serves, not just one request. Awaited expressions yield to the
        loop and are exempt (their coroutine bodies are analyzed as
        their own async defs); nested defs/lambdas run elsewhere
        (executor targets, callbacks) and are exempt too."""
        seen: set[tuple[str, int, str]] = set()
        for fi in sorted(
            self.project.functions.values(), key=lambda f: f.qualname
        ):
            if not isinstance(fi.node, ast.AsyncFunctionDef):
                continue
            if not any(s in fi.relpath for s in _SCOPES):
                continue
            env = self.cg.local_types(fi)
            self._loop_walk(fi, fi.node, env, seen)
            if fi.name.endswith("_native"):
                self._native_bridge_walk(fi, seen)

    def _native_bridge_walk(self, fi: FuncInfo, seen: set) -> None:
        """Native-async handlers (``async def *_native``) must stay on
        the loop end to end: ThreadFlume construction, executor
        dispatch, or the bridged ``_run_request`` inside one re-adds the
        worker-thread hop the native route exists to remove. Unlike the
        base walk, awaited calls are NOT exempt here — awaiting a
        thread hop still schedules the thread."""
        for child in ast.walk(fi.node):
            if not isinstance(child, ast.Call):
                continue
            f = child.func
            name = (
                f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute)
                else None
            )
            if name not in _NATIVE_BRIDGE:
                continue
            key = (fi.relpath, child.lineno, f"native-bridge {name}")
            if key in seen:
                continue
            seen.add(key)
            self._loop_v.append(
                Violation(
                    "blocking-on-loop",
                    fi.relpath,
                    child.lineno,
                    f"thread-bridge {name} inside native-async handler "
                    f"{fi.name}: native routes exist to skip the "
                    "worker-thread hop — stay on the loop or return "
                    "NATIVE_FALLBACK so the bridged route serves it "
                    "(docs/ANALYSIS.md)",
                )
            )

    def _loop_walk(
        self, fi: FuncInfo, node: ast.AST, env: dict, seen: set
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue  # runs off-loop (executor target / callback)
            if isinstance(child, ast.Await) and isinstance(
                child.value, ast.Call
            ):
                # the awaited call itself yields to the loop; its
                # ARGUMENT expressions still execute inline — check them
                for sub in ast.iter_child_nodes(child.value):
                    self._loop_walk(fi, sub, env, seen)
                continue
            if isinstance(child, ast.Call):
                self._loop_check_call(fi, child, env, seen)
            self._loop_walk(fi, child, env, seen)

    def _loop_check_call(
        self, fi: FuncInfo, call: ast.Call, env: dict, seen: set
    ) -> None:
        desc = self._is_blocking_call(call, fi, env)
        if desc is not None:
            key = (fi.relpath, call.lineno, desc)
            if key not in seen:
                seen.add(key)
                self._loop_v.append(
                    Violation(
                        "blocking-on-loop",
                        fi.relpath,
                        call.lineno,
                        f"{desc} inside async def {fi.name} runs on the "
                        "event loop and stalls every connection it "
                        "serves; await an async equivalent or offload "
                        "via run_in_executor (docs/ANALYSIS.md)",
                    )
                )
            return
        callee = self.cg.resolve_call(call, fi, env)
        if callee is None or isinstance(callee.node, ast.AsyncFunctionDef):
            return  # async callees are analyzed as their own scopes
        blocking = self._blocking_in(
            callee, MAX_DEPTH - 1, frozenset({fi.qualname})
        )
        for desc, s in sorted(blocking.items()):
            key = (fi.relpath, call.lineno, desc)
            if key in seen:
                continue
            seen.add(key)
            chain = f"{callee.name}" + (f" {s.chain}" if s.chain else "")
            self._loop_v.append(
                Violation(
                    "blocking-on-loop",
                    fi.relpath,
                    call.lineno,
                    f"{desc} (via {chain}, {s.relpath}:{s.line}) reachable "
                    f"from async def {fi.name} without await/executor "
                    "offload; the loop stalls every connection while it "
                    "runs (docs/ANALYSIS.md)",
                )
            )

    # -- violations -----------------------------------------------------------
    def violations(self) -> list[Violation]:
        out = (
            list(self._blocking_v)
            + list(self._loop_v)
            + list(self._collective_v)
        )
        for cycle in self.graph.cycles():
            cyc = set(cycle)
            sites: list[tuple[str, int, str]] = []
            for (a, b), slist in self.graph.edges.items():
                if a in cyc and b in cyc:
                    s = slist[0]
                    label = f"{a} -> {b} at {s.relpath}:{s.line}"
                    if s.chain:
                        label += f" ({s.chain})"
                    sites.append((s.relpath, s.line, label))
            sites.sort()
            if not sites or not any(
                any(sc in s[0] for sc in _SCOPES) for s in sites
            ):
                continue
            anchor = next(s for s in sites if any(sc in s[0] for sc in _SCOPES))
            detail = "; ".join(lbl for _, _, lbl in sites[:4])
            out.append(
                Violation(
                    "lock-order",
                    anchor[0],
                    anchor[1],
                    "lock-order cycle (potential ABBA deadlock): "
                    f"{' -> '.join(cycle)} -> {cycle[0]} [{detail}]; pick "
                    "one order and document it in docs/LOCKS.md",
                )
            )
        return out


def compute_lock_graph(project: Project) -> LockGraph:
    """The statically computed lock-order graph — also consumed by the
    tier-1 OrderedLock cross-check (static ⊇ dynamic)."""
    return LockGraphBuilder(project).graph


def check_project(project: Project) -> list[Violation]:
    return LockGraphBuilder(project).violations()
