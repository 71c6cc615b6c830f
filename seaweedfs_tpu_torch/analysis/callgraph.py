"""Project-wide AST call graph for the interprocedural sweedlint rules.

The per-file rules (PR 2) see one ``ast.Module`` at a time; the
concurrency bug classes this repo has actually shipped — a beat RPC
issued with the election lock held, an ABBA inversion between the
topology and layout locks — are *cross-function* properties.  This
module gives the interprocedural rules (``lockgraph``, ``taint``) the
three things they need:

- ``Project``    — every parsed module of one analysis run, indexed by
  module name and repo-relative path;
- ``CallGraph``  — best-effort call-site resolution: ``self.method``
  (with inherited-method lookup through project base classes),
  module-level functions, aliased and relative imports, constructor
  calls, and ``obj.method`` through a light type inference described
  below;
- type inference — enough to answer "what class is ``layout`` here":
  constructor assignments (``self.topo = Topology(...)``), parameter and
  return annotations (including string annotations), ``Optional``/union
  unwrapping, and container value types (``dict[tuple, TopicPartition]``
  → iterating ``.values()`` yields ``TopicPartition``).

Resolution is deliberately unsound-but-useful (RacerD's compromise):
when a receiver cannot be typed, a method name defined by exactly one
project class resolves to it (unless the name is on the common-name
stoplist); anything still ambiguous resolves to nothing and the
interprocedural rules simply see no summary for that call.  False
silence is possible; false edges are rare — the right trade for a gate
that must stay zero-noise.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Iterable, Optional

#: receiver-less fallback resolution skips these: they name stdlib/dict/
#: str/file methods so often that "defined by exactly one project class"
#: would still mis-resolve (``q.get``, ``", ".join``, ``f.read``).
_COMMON_METHOD_NAMES = frozenset(
    {
        "get", "put", "read", "write", "close", "flush", "open", "stop",
        "start", "run", "send", "join", "split", "strip", "result",
        "items", "values", "keys", "append", "add", "pop", "remove",
        "submit", "acquire", "release", "wait", "notify", "notify_all",
        "update", "clear", "copy", "stats", "url", "encode", "decode",
        "seek", "tell", "name", "set", "discard", "count", "index",
        "sort", "format", "replace", "search", "match", "group",
        # stdlib objects the tree holds untyped (sqlite3 connections,
        # http handlers) share these with project classes
        "commit", "rollback", "execute", "cursor", "fetchone",
        "fetchall", "request", "getresponse", "connect", "shutdown",
    }
)


@dataclass
class TypeRef:
    """Best-effort type of an expression: ``cls`` is a project class
    qualname; ``elem`` is the value/element class for containers (what
    iterating or subscripting yields)."""

    cls: Optional[str] = None
    elem: Optional[str] = None

    @property
    def empty(self) -> bool:
        return self.cls is None and self.elem is None


_NOTHING = TypeRef()


@dataclass
class FuncInfo:
    qualname: str  # "pkg.mod.Class.method" or "pkg.mod.func"
    name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    modname: str
    relpath: str
    class_qualname: Optional[str] = None  # owning class, if a method


@dataclass
class ClassInfo:
    qualname: str  # "pkg.mod.Class"
    name: str
    node: ast.ClassDef
    modname: str
    relpath: str
    base_exprs: list[ast.expr] = field(default_factory=list)
    bases: list[str] = field(default_factory=list)  # resolved, project-only
    methods: dict[str, FuncInfo] = field(default_factory=dict)
    attr_types: dict[str, TypeRef] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    modname: str
    relpath: str
    tree: ast.Module
    src_lines: list[str]
    # name → ("module", modname) | ("symbol", "modname.Name")
    symbols: dict[str, tuple[str, str]] = field(default_factory=dict)
    functions: dict[str, FuncInfo] = field(default_factory=dict)
    classes: dict[str, ClassInfo] = field(default_factory=dict)


def modname_for_relpath(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".").replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


class Project:
    """All modules of one analysis run plus the indexes the
    interprocedural rules share."""

    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.by_relpath: dict[str, ModuleInfo] = {}
        self.classes: dict[str, ClassInfo] = {}  # qualname → info
        self.functions: dict[str, FuncInfo] = {}  # qualname → info
        self._methods_by_name: dict[str, list[FuncInfo]] = {}
        self._indexed = False

    def add_module(
        self, relpath: str, tree: ast.Module, src_lines: list[str]
    ) -> ModuleInfo:
        modname = modname_for_relpath(relpath)
        mi = ModuleInfo(modname, relpath, tree, src_lines)
        self.modules[modname] = mi
        self.by_relpath[relpath] = mi
        self._indexed = False
        return mi

    # -- indexing -------------------------------------------------------------
    def index(self) -> None:
        if self._indexed:
            return
        self._indexed = True
        self.classes.clear()
        self.functions.clear()
        self._methods_by_name.clear()
        for mi in self.modules.values():
            self._index_module(mi)
        for mi in self.modules.values():
            self._resolve_imports(mi)
        self._chase_reexports()
        for ci in self.classes.values():
            ci.bases = [
                b
                for b in (
                    self._resolve_symbol_to_class(e, self.modules[ci.modname])
                    for e in ci.base_exprs
                )
                if b
            ]
        for ci in self.classes.values():
            self._infer_attr_types(ci)

    def _index_module(self, mi: ModuleInfo) -> None:
        mi.functions.clear()
        mi.classes.clear()

        def walk(body: Iterable[ast.stmt], prefix: str, cls: Optional[ClassInfo]):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{prefix}.{node.name}"
                    fi = FuncInfo(
                        qn, node.name, node, mi.modname, mi.relpath,
                        cls.qualname if cls else None,
                    )
                    self.functions[qn] = fi
                    if cls is not None:
                        cls.methods.setdefault(node.name, fi)
                        self._methods_by_name.setdefault(node.name, []).append(fi)
                    elif prefix == mi.modname:
                        mi.functions[node.name] = fi
                    # nested defs (thread targets) are independent functions
                    walk(node.body, qn, cls)
                elif isinstance(node, ast.ClassDef):
                    qn = f"{prefix}.{node.name}"
                    ci = ClassInfo(
                        qn, node.name, node, mi.modname, mi.relpath,
                        base_exprs=list(node.bases),
                    )
                    self.classes[qn] = ci
                    if prefix == mi.modname:
                        mi.classes[node.name] = ci
                    walk(node.body, qn, ci)

        walk(mi.tree.body, mi.modname, None)

    def _resolve_imports(self, mi: ModuleInfo) -> None:
        mi.symbols.clear()
        for name, ci in mi.classes.items():
            mi.symbols[name] = ("symbol", ci.qualname)
        for name, fi in mi.functions.items():
            mi.symbols[name] = ("symbol", fi.qualname)
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    mi.symbols[bound] = ("module", target)
            elif isinstance(node, ast.ImportFrom):
                is_pkg = mi.relpath.endswith("__init__.py")
                base = self._resolve_from_base(mi.modname, node, is_pkg)
                if base is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    bound = alias.asname or alias.name
                    target = f"{base}.{alias.name}" if base else alias.name
                    if target in self.modules:
                        mi.symbols[bound] = ("module", target)
                    else:
                        mi.symbols[bound] = ("symbol", target)

    @staticmethod
    def _resolve_from_base(
        modname: str, node: ast.ImportFrom, is_pkg: bool = False
    ) -> Optional[str]:
        if node.level == 0:
            return node.module or ""
        # A package __init__'s own name counts as one level: `from .core
        # import X` inside pkg/__init__.py resolves against pkg itself.
        level = node.level - 1 if is_pkg else node.level
        parts = modname.split(".")
        if level > len(parts):
            return None
        parts = parts[: len(parts) - level] if level else parts
        if node.module:
            parts.append(node.module)
        return ".".join(parts)

    def _chase_reexports(self) -> None:
        """Follow package ``__init__`` re-exports so a symbol imported as
        ``pkg.Name`` lands on its defining module's qualname."""
        for mi in self.modules.values():
            for bound, (kind, target) in list(mi.symbols.items()):
                if kind != "symbol":
                    continue
                seen: set[str] = set()
                while (
                    target not in self.classes
                    and target not in self.functions
                    and target not in seen
                ):
                    seen.add(target)
                    owner, _, name = target.rpartition(".")
                    src = self.modules.get(owner)
                    nxt = src.symbols.get(name) if src else None
                    if not nxt or nxt[0] != "symbol" or nxt[1] == target:
                        break
                    target = nxt[1]
                mi.symbols[bound] = (kind, target)

    # -- symbol helpers -------------------------------------------------------
    def _resolve_symbol_to_class(
        self, expr: ast.expr, mi: ModuleInfo
    ) -> Optional[str]:
        """Class qualname for a base-class / annotation expression."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            try:
                expr = ast.parse(expr.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(expr, ast.Name):
            kind_target = mi.symbols.get(expr.id)
            if kind_target:
                kind, target = kind_target
                if kind == "symbol" and target in self.classes:
                    return target
            return None
        if isinstance(expr, ast.Attribute):
            mod = self._expr_module(expr.value, mi)
            if mod is not None:
                qn = f"{mod}.{expr.attr}"
                if qn in self.classes:
                    return qn
        return None

    def _expr_module(self, expr: ast.expr, mi: ModuleInfo) -> Optional[str]:
        """Module name an expression denotes (``t`` after ``import time as
        t``; ``a.b`` after ``import a.b``), else None."""
        parts: list[str] = []
        node = expr
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        kind_target = mi.symbols.get(node.id)
        root = None
        if kind_target and kind_target[0] == "module":
            root = kind_target[1]
        elif node.id in self.modules:
            root = node.id
        if root is None:
            return None
        full = ".".join([root] + list(reversed(parts)))
        return full

    def mro(self, class_qualname: str) -> list[ClassInfo]:
        """The class plus its project base classes, breadth-first."""
        out: list[ClassInfo] = []
        seen: set[str] = set()
        queue = [class_qualname]
        while queue:
            qn = queue.pop(0)
            if qn in seen:
                continue
            seen.add(qn)
            ci = self.classes.get(qn)
            if ci is None:
                continue
            out.append(ci)
            queue.extend(ci.bases)
        return out

    def lookup_method(self, class_qualname: str, name: str) -> Optional[FuncInfo]:
        for ci in self.mro(class_qualname):
            fi = ci.methods.get(name)
            if fi is not None:
                return fi
        return None

    # -- annotations → TypeRef ------------------------------------------------
    def type_from_annotation(
        self, ann: Optional[ast.expr], mi: ModuleInfo
    ) -> TypeRef:
        if ann is None:
            return _NOTHING
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return _NOTHING
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            # "DataNode | None": take whichever side resolves
            left = self.type_from_annotation(ann.left, mi)
            return left if not left.empty else self.type_from_annotation(ann.right, mi)
        if isinstance(ann, ast.Subscript):
            base = ann.value
            base_name = base.attr if isinstance(base, ast.Attribute) else (
                base.id if isinstance(base, ast.Name) else ""
            )
            args = (
                list(ann.slice.elts)
                if isinstance(ann.slice, ast.Tuple)
                else [ann.slice]
            )
            if base_name == "Optional" and args:
                return self.type_from_annotation(args[0], mi)
            if base_name in ("dict", "Dict", "defaultdict", "OrderedDict") and len(args) == 2:
                inner = self.type_from_annotation(args[1], mi)
                return TypeRef(elem=inner.cls)
            if base_name in ("list", "List", "set", "Set", "frozenset",
                             "deque", "Iterable", "Iterator", "Sequence",
                             "tuple", "Tuple", "AsyncIterable",
                             "AsyncIterator", "AsyncGenerator") and args:
                inner = self.type_from_annotation(args[0], mi)
                return TypeRef(elem=inner.cls)
            return _NOTHING
        cls = self._resolve_symbol_to_class(ann, mi)
        return TypeRef(cls=cls) if cls else _NOTHING

    def _infer_attr_types(self, ci: ClassInfo) -> None:
        mi = self.modules[ci.modname]
        for node in ast.walk(ci.node):
            if isinstance(node, ast.AnnAssign):
                tgt = node.target
                attr = None
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    attr = tgt.attr
                elif isinstance(tgt, ast.Name):
                    attr = tgt.id  # dataclass-style class-body annotation
                if attr:
                    t = self.type_from_annotation(node.annotation, mi)
                    if not t.empty:
                        ci.attr_types.setdefault(attr, t)
            elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                cls = self._resolve_symbol_to_class(node.value.func, mi)
                if cls is None:
                    continue
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        ci.attr_types.setdefault(tgt.attr, TypeRef(cls=cls))
        # `self._flume = flume` where flume is an annotated parameter:
        # the attribute inherits the parameter's declared type
        for m in ci.methods.values():
            args = m.node.args
            ann_by_name: dict[str, TypeRef] = {}
            for a in (
                list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
            ):
                if a.annotation is not None:
                    t = self.type_from_annotation(a.annotation, mi)
                    if not t.empty:
                        ann_by_name[a.arg] = t
            if not ann_by_name:
                continue
            for node in ast.walk(m.node):
                if not (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                ):
                    continue
                t = ann_by_name.get(node.value.id)
                if t is None:
                    continue
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        ci.attr_types.setdefault(tgt.attr, t)


class CallGraph:
    """Call-site resolution over a :class:`Project`."""

    def __init__(self, project: Project):
        project.index()
        self.project = project

    # -- local type environment ----------------------------------------------
    def local_types(self, fi: FuncInfo) -> dict[str, TypeRef]:
        """name → TypeRef for parameters and straightforwardly-typed
        locals of one function (pre-pass; last assignment wins)."""
        p = self.project
        mi = p.modules[fi.modname]
        env: dict[str, TypeRef] = {}
        node = fi.node
        args = node.args
        all_args = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        for a in all_args:
            if a.arg == "self" and fi.class_qualname:
                env["self"] = TypeRef(cls=fi.class_qualname)
            else:
                t = p.type_from_annotation(a.annotation, mi)
                if not t.empty:
                    env[a.arg] = t
        # two passes so a `for x in self._xs` before the assignment that
        # types `self._xs` (reading order artifacts) still resolves
        for _ in range(2):
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    tgt = stmt.targets[0]
                    if isinstance(tgt, ast.Name):
                        t = self.expr_type(stmt.value, fi, env)
                        if not t.empty:
                            env[tgt.id] = t
                elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    t = p.type_from_annotation(stmt.annotation, mi)
                    if not t.empty:
                        env[stmt.target.id] = t
                elif isinstance(stmt, (ast.For, ast.AsyncFor)) and isinstance(
                    stmt.target, ast.Name
                ):
                    t = self.expr_type(stmt.iter, fi, env)
                    if t.elem:
                        env[stmt.target.id] = TypeRef(cls=t.elem)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        if isinstance(item.optional_vars, ast.Name):
                            t = self.expr_type(item.context_expr, fi, env)
                            if not t.empty:
                                env[item.optional_vars.id] = t
        return env

    def expr_type(
        self, expr: ast.expr, fi: FuncInfo, env: dict[str, TypeRef]
    ) -> TypeRef:
        p = self.project
        if isinstance(expr, ast.Await):
            # `x = await self._afetch()` types as the coroutine's return
            # annotation — the await wrapper is transparent to the value
            return self.expr_type(expr.value, fi, env)
        if isinstance(expr, ast.Name):
            return env.get(expr.id, _NOTHING)
        if isinstance(expr, ast.Attribute):
            base = self.expr_type(expr.value, fi, env)
            if base.cls:
                for ci in p.mro(base.cls):
                    t = ci.attr_types.get(expr.attr)
                    if t is not None:
                        return t
            return _NOTHING
        if isinstance(expr, ast.Subscript):
            base = self.expr_type(expr.value, fi, env)
            return TypeRef(cls=base.elem) if base.elem else _NOTHING
        if isinstance(expr, ast.IfExp):
            t = self.expr_type(expr.body, fi, env)
            return t if not t.empty else self.expr_type(expr.orelse, fi, env)
        if isinstance(expr, ast.Call):
            f = expr.func
            # container.get(k) / container.values() keep the element type
            if isinstance(f, ast.Attribute):
                base = self.expr_type(f.value, fi, env)
                if base.elem and f.attr in ("get", "pop", "setdefault"):
                    return TypeRef(cls=base.elem)
                if base.elem and f.attr == "values":
                    return TypeRef(elem=base.elem)
            callee = self.resolve_call(expr, fi, env)
            if callee is None:
                # constructor without an explicit __init__?
                cls = self._callee_class(expr, fi, env)
                if cls:
                    return TypeRef(cls=cls)
                return _NOTHING
            if callee.name == "__init__" and callee.class_qualname:
                # a constructor call types as the class, not as
                # __init__'s (empty) return annotation
                return TypeRef(cls=callee.class_qualname)
            ret = getattr(callee.node, "returns", None)
            mi = p.modules[callee.modname]
            return p.type_from_annotation(ret, mi)
        return _NOTHING

    def _callee_class(
        self, call: ast.Call, fi: FuncInfo, env: dict[str, TypeRef]
    ) -> Optional[str]:
        """Class qualname when the call is a constructor invocation."""
        p = self.project
        mi = p.modules[fi.modname]
        return p._resolve_symbol_to_class(call.func, mi)

    # -- call resolution ------------------------------------------------------
    def resolve_call(
        self,
        call: ast.Call,
        fi: FuncInfo,
        env: Optional[dict[str, TypeRef]] = None,
    ) -> Optional[FuncInfo]:
        """FuncInfo the call lands in, or None when unresolvable.
        Constructor calls resolve to the class's ``__init__``."""
        p = self.project
        mi = p.modules[fi.modname]
        if env is None:
            env = self.local_types(fi)
        f = call.func
        if isinstance(f, ast.Name):
            kind_target = mi.symbols.get(f.id)
            if kind_target:
                kind, target = kind_target
                if kind == "symbol":
                    if target in p.functions:
                        return p.functions[target]
                    if target in p.classes:
                        return p.lookup_method(target, "__init__")
            return None
        if not isinstance(f, ast.Attribute):
            return None
        # super().m()
        if (
            isinstance(f.value, ast.Call)
            and isinstance(f.value.func, ast.Name)
            and f.value.func.id == "super"
            and fi.class_qualname
        ):
            ci = p.classes.get(fi.class_qualname)
            for base in ci.bases if ci else []:
                m = p.lookup_method(base, f.attr)
                if m is not None:
                    return m
            return None
        # module-qualified: util.glog.info, t.sleep
        mod = p._expr_module(f.value, mi)
        if mod is not None:
            qn = f"{mod}.{f.attr}"
            if qn in p.functions:
                return p.functions[qn]
            if qn in p.classes:
                return p.lookup_method(qn, "__init__")
            return None
        # typed receiver
        t = self.expr_type(f.value, fi, env)
        if t.cls:
            m = p.lookup_method(t.cls, f.attr)
            if m is not None:
                return m
            return None
        # fallback: a method name only one project class defines
        if f.attr not in _COMMON_METHOD_NAMES:
            cands = p._methods_by_name.get(f.attr, [])
            if len(cands) == 1:
                return cands[0]
        return None

    def calls_in(self, fi: FuncInfo) -> list[tuple[ast.Call, Optional[FuncInfo]]]:
        """Every call expression lexically inside ``fi`` (excluding nested
        function bodies, which run later) with its resolution."""
        env = self.local_types(fi)
        out: list[tuple[ast.Call, Optional[FuncInfo]]] = []

        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(child, ast.Call):
                    out.append((child, self.resolve_call(child, fi, env)))
                visit(child)

        visit(fi.node)
        return out
