"""repro-lint — AST static analysis with repo-specific rules.

Counterpart of ``repro/analysis/repro_lint.py``: the same analyser, rule
catalogue and suppression syntax (the same source gives the same
findings), with the port's tracers as roots beside ``jax.jit``.

The rules encode the failure modes this codebase has actually hit (or
is one refactor away from hitting): host↔device synchronization inside
jit-reachable code, Python control flow on traced values, jit caches
churned by unstable static arguments, host-object mutation under trace,
the removed ``pool.qos`` surface, and pool allocations that silently
drop tenant attribution in multi-tenant paths.

Analysis is per module (no cross-file resolution) and intentionally
conservative about taint: a value returned by an arbitrary free
function is treated as *host* data, so idioms like
``cos = make_cos_sin(...); if cos is not None:`` never flag.  Taint
only propagates where tracing actually does — through arithmetic,
indexing, ``jnp.``/``jax.``/``lax.``/``torch.``/``F.`` calls and methods
of traced values — and ``.shape``/``.ndim``/``.dtype`` reads are static
under jit, so they never taint.

Jit reachability = functions decorated with ``jax.jit`` (directly or
via ``functools.partial``), functions registered at a ``jax.jit(f,
...)`` call site, Pallas kernels passed to ``pallas_call``, and
everything they call by bare name within the same module (fixpoint).
Only decorated/registered *roots* carry parameter taint; plain
reachable helpers are checked for the unconditional hazards
(``.item()``, ``.tolist()``, ``.cpu()``, host-state mutation).

The port's tracers are roots too, with the same hazards: a function
decorated with ``torch.compile`` (directly, called, or via
``functools.partial``) or registered at a ``torch.compile(f, ...)`` or
``torch.cuda.make_graphed_callables(f, ...)`` call site (a host sync
there breaks the graph or fails the capture), and the body of a ``with
torch.cuda.graph(...)`` block inside a function: that body runs once,
at capture, so a host sync fails the capture, a branch on a tensor is
frozen into every replay, and a ``self.<attr>`` write happens at
capture, not per replay.  Within such a block the enclosing function's
parameters carry taint, and the functions the block calls by bare name
are reachable.  ``jit-unstable-static`` has no torch counterpart (no
static arguments) and checks ``jax.jit`` sources only.

Suppression: append ``# repro-lint: disable=<rule>[,<rule>...]`` (or
bare ``disable`` for all rules) to the offending line, or put the
comment alone on the line above.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.repro_lint src/repro_torch chip_smoke.py tools
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set

#: Rule catalog: name -> one-line rationale (DESIGN.md §9 has the long form).
RULES: Dict[str, str] = {
    "jit-host-sync": (
        "host<->device sync inside jit-reachable code (or a torch.compile "
        "root or CUDA-graph capture): .item(), .tolist(), .cpu(), "
        "int()/float()/bool() or np.asarray/np.array/np.fromiter on a "
        "traced value, or an assert on a traced value"
    ),
    "jit-traced-control-flow": (
        "Python if/while/for on a traced value inside a jit root — "
        "fails at trace time or silently specializes"
    ),
    "jit-unstable-static": (
        "static_argnames/argnums naming a parameter that is missing "
        "from the signature or has a mutable (unhashable) default"
    ),
    "jit-host-state-mutation": (
        "assignment to self.<attr> inside jit-reachable code — mutates "
        "host object state during tracing, not per call"
    ),
    "removed-pool-qos": (
        "use of the removed pool.qos hook surface; go through "
        "pool.control (TieringControl) instead"
    ),
    "missing-tenant": (
        "allocate/try_allocate_many/alloc_page without tenant "
        "attribution in a scope that handles tenants — the QoS ledger "
        "silently loses those pages"
    ),
    "assert-host-sync": (
        "assert containing .item() — a host sync on the hot path that "
        "vanishes under -O; suppress explicitly where intended"
    ),
}

#: Names whose presence in a scope marks it as multi-tenant aware.
TENANTISH = frozenset(
    {"tenant", "tenants", "tid", "tids", "tenant_id", "tenant_ids",
     "run_tids", "tenant_of"}
)

#: allocate-family callees -> positional arity at which tenant is covered.
_ALLOC_ARITY = {"allocate": 4, "try_allocate_many": 3, "alloc_page": 2}

#: numpy constructors that force a host copy of their argument.
_NP_HOST_FUNCS = frozenset({"asarray", "array", "fromiter", "copy", "copyto"})

#: builtins that return host scalars (flagged when fed a traced value).
_HOST_CASTS = frozenset({"int", "float", "bool"})

#: builtins whose results are host data regardless of arguments.
_HOST_BUILTINS = frozenset(
    {"len", "range", "isinstance", "issubclass", "getattr", "hasattr",
     "str", "repr", "print", "tuple", "list", "dict", "set", "sorted",
     "enumerate", "zip", "type", "id", "format", "callable"}
)

#: builtins that do propagate tracing (traced in -> traced out).
_PROPAGATING_BUILTINS = frozenset({"abs", "round", "pow", "sum", "divmod"})

#: attribute reads that are static under jit (never taint).
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size"})

#: array-namespace roots whose calls propagate taint from arguments.
_TRACED_NAMESPACES = frozenset({"jnp", "jax", "lax", "torch", "F"})

#: methods that copy a traced value to the host (a device->host sync).
_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu"})

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable(?:=([A-Za-z0-9_,\- ]+))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


# --------------------------------------------------------------------- #
# jit-root discovery
# --------------------------------------------------------------------- #
def _root_name(node: ast.AST) -> Optional[str]:
    """Base ``Name`` id of a dotted chain (``jax.nn.softmax`` → jax)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_jit_expr(node: ast.AST) -> bool:
    """Matches ``jit`` / ``jax.jit`` as an expression, or the port's
    ``torch.compile``."""
    if isinstance(node, ast.Name):
        return node.id == "jit"
    if not isinstance(node, ast.Attribute):
        return False
    return node.attr == "jit" or _is_torch_compile(node)


def _is_torch_compile(node: ast.AST) -> bool:
    """Matches ``torch.compile`` (not ``re.compile``)."""
    return (isinstance(node, ast.Attribute) and node.attr == "compile"
            and _root_name(node.value) == "torch")


def _is_graph_capture(node: ast.AST) -> bool:
    """Matches a ``torch.cuda.graph(...)`` capture context."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "graph"
            and isinstance(node.func.value, ast.Attribute)
            and node.func.value.attr == "cuda"
            and _root_name(node.func.value) == "torch")


def _captures(stmts: Sequence[ast.stmt]) -> List[ast.With]:
    """``with torch.cuda.graph(...)`` blocks among ``stmts`` and their
    nested statements (not inside nested defs)."""
    out: List[ast.With] = []
    todo = list(stmts)
    while todo:
        st = todo.pop()
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(st, ast.With) and any(_is_graph_capture(i.context_expr)
                                            for i in st.items):
            out.append(st)
        for field in ("body", "orelse", "finalbody", "handlers"):
            todo.extend(getattr(st, field, []) or [])
    return out


def _const_str_set(node: Optional[ast.AST]) -> Set[str]:
    """String constants out of ``"x"`` / ``("x", "y")`` / ``["x"]``."""
    out: Set[str] = set()
    if node is None:
        return out
    elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) else [node]
    for e in elts:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            out.add(e.value)
    return out


def _const_int_set(node: Optional[ast.AST]) -> Set[int]:
    out: Set[int] = set()
    if node is None:
        return out
    elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) else [node]
    for e in elts:
        if isinstance(e, ast.Constant) and isinstance(e.value, int):
            out.add(e.value)
    return out


def _positional_params(fnode: ast.AST) -> List[str]:
    a = fnode.args
    return [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]


def _all_params(fnode: ast.AST) -> List[str]:
    a = fnode.args
    names = _positional_params(fnode) + [p.arg for p in a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


@dataclasses.dataclass
class _FuncInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    name: str
    is_root: bool = False
    static: Set[str] = dataclasses.field(default_factory=set)
    jit_site_line: int = 0  # decorator/registration line for static checks
    # ``with torch.cuda.graph(...)`` blocks in the body: capture roots
    captures: List[ast.With] = dataclasses.field(default_factory=list)


class _Collector(ast.NodeVisitor):
    """Collect functions, jit roots, pallas kernels and registration sites."""

    def __init__(self) -> None:
        self.functions: List[_FuncInfo] = []
        self.by_name: Dict[str, List[_FuncInfo]] = {}
        # bare name -> static argnames from jax.jit(f, ...) call sites
        self.registered: Dict[str, Set[str]] = {}
        self.kernels: Set[str] = set()

    def _add(self, info: _FuncInfo) -> None:
        self.functions.append(info)
        self.by_name.setdefault(info.name, []).append(info)

    def _decorator_statics(self, fnode) -> Optional[Set[str]]:
        """None if not a jit root; else the static param-name set."""
        for dec in fnode.decorator_list:
            call = None
            if _is_jit_expr(dec):
                return set()
            if isinstance(dec, ast.Call):
                if _is_jit_expr(dec.func):
                    call = dec
                elif (
                    isinstance(dec.func, (ast.Name, ast.Attribute))
                    and (dec.func.attr if isinstance(dec.func, ast.Attribute)
                         else dec.func.id) == "partial"
                    and dec.args
                    and _is_jit_expr(dec.args[0])
                ):
                    call = dec
            if call is None:
                continue
            static: Set[str] = set()
            pos = _positional_params(fnode)
            for kw in call.keywords:
                if kw.arg == "static_argnames":
                    static |= _const_str_set(kw.value)
                elif kw.arg == "static_argnums":
                    for i in _const_int_set(kw.value):
                        if 0 <= i < len(pos):
                            static.add(pos[i])
            return static
        return None

    def _visit_func(self, node) -> None:
        static = self._decorator_statics(node)
        self._add(_FuncInfo(
            node=node, name=node.name, is_root=static is not None,
            static=static or set(), jit_site_line=node.lineno,
            captures=_captures(node.body),
        ))
        self.generic_visit(node)

    def _register(self, target: ast.AST) -> Optional[Set[str]]:
        """Mark the function ``target`` names as a registered root → its
        static-name set (None if ``target`` names no function)."""
        name = None
        if isinstance(target, ast.Name):
            name = target.id
        elif isinstance(target, ast.Attribute):
            name = target.attr
        return None if name is None else self.registered.setdefault(name, set())

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if _is_jit_expr(func) and node.args:
            statics = self._register(node.args[0])
            if statics is not None:
                for kw in node.keywords:
                    if kw.arg == "static_argnames":
                        statics |= _const_str_set(kw.value)
        elif (isinstance(func, ast.Attribute)
                and func.attr == "make_graphed_callables" and node.args):
            # one callable or a tuple of them, each captured as a graph
            target = node.args[0]
            for t in (target.elts if isinstance(target, (ast.Tuple, ast.List))
                      else [target]):
                self._register(t)
        elif (isinstance(func, ast.Attribute) and func.attr == "pallas_call"
                and node.args):
            target = node.args[0]
            if isinstance(target, ast.Name):
                self.kernels.add(target.id)
            elif isinstance(target, ast.Attribute):
                self.kernels.add(target.attr)
        self.generic_visit(node)


def _callees(fnode: ast.AST) -> Set[str]:
    """Bare names this function (or block) calls (``f(...)`` and
    ``self.f(...)``)."""
    out: Set[str] = set()
    for node in ast.walk(fnode):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("self", "cls")):
                out.add(f.attr)
    return out


# --------------------------------------------------------------------- #
# per-function taint checker
# --------------------------------------------------------------------- #
class _FunctionChecker:
    """Single forward pass over one jit-reachable function.  With
    ``capture_only`` (a function that is not reachable but holds
    ``torch.cuda.graph`` blocks) its parameters carry taint and hazards
    are flagged only inside those blocks."""

    def __init__(self, info: _FuncInfo, is_root: bool, static: Set[str],
                 path: str, findings: List[Finding],
                 capture_only: bool = False) -> None:
        self.node = info.node
        self.is_root = is_root or capture_only
        self.static = static
        self.path = path
        self.findings = findings
        self.tainted: Set[str] = set()
        self.flagging = not capture_only

    def run(self) -> None:
        if self.is_root:
            self.tainted = (
                set(_all_params(self.node)) - self.static - {"self", "cls"}
            )
        self._stmts(self.node.body)

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        if not self.flagging:
            return
        self.findings.append(Finding(
            self.path, node.lineno, node.col_offset, rule, message
        ))

    # ---------------- taint evaluation ---------------- #
    def _t(self, e: Optional[ast.AST]) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            return self._t(e.value)
        if isinstance(e, ast.Subscript):
            return self._t(e.value) or self._t(e.slice)
        if isinstance(e, ast.Slice):
            return self._t(e.lower) or self._t(e.upper) or self._t(e.step)
        if isinstance(e, ast.BinOp):
            return self._t(e.left) or self._t(e.right)
        if isinstance(e, ast.UnaryOp):
            return self._t(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self._t(v) for v in e.values)
        if isinstance(e, ast.Compare):
            # `is None` / `in container` produce host booleans (identity
            # and membership never trace) — they cannot carry taint.
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return self._t(e.left) or any(self._t(c) for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self._t(e.body) or self._t(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self._t(v) for v in e.elts)
        if isinstance(e, ast.Starred):
            return self._t(e.value)
        if isinstance(e, ast.NamedExpr):
            if self._t(e.value):
                self.tainted.add(e.target.id)
                return True
            return False
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return (self._t(e.elt)
                    or any(self._t(g.iter) for g in e.generators))
        if isinstance(e, ast.Call):
            return self._call_tainted(e)
        return False

    def _call_tainted(self, e: ast.Call) -> bool:
        f = e.func
        args_tainted = (any(self._t(a) for a in e.args)
                        or any(self._t(kw.value) for kw in e.keywords))
        if isinstance(f, ast.Attribute):
            if f.attr in _HOST_SYNC_METHODS:
                return False  # result is host data (the sync is flagged)
            root = _root_name(f.value)
            if root in _TRACED_NAMESPACES:
                return args_tainted
            if root == "np":
                return False  # numpy results are host data
            # method of a traced value stays traced (x.reshape, x.sum, …)
            return self._t(f.value)
        if isinstance(f, ast.Name):
            if f.id in _PROPAGATING_BUILTINS:
                return args_tainted
            # Free function results are treated as host data: without
            # cross-function analysis, propagating here would flag every
            # `helper(x)` result used in host control flow.
            return False
        return False

    # ---------------- hazard scanning ---------------- #
    def _scan(self, e: Optional[ast.AST]) -> None:
        if e is None:
            return
        for node in ast.walk(e):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_SYNC_METHODS:
                self._flag(node, "jit-host-sync",
                           f".{f.attr}() forces a device->host sync under "
                           "jit or a capture")
            elif isinstance(f, ast.Name) and f.id in _HOST_CASTS:
                if any(self._t(a) for a in node.args):
                    self._flag(node, "jit-host-sync",
                               f"{f.id}() on a traced value concretizes it "
                               "on the host")
            elif (isinstance(f, ast.Attribute)
                    and f.attr in _NP_HOST_FUNCS
                    and _root_name(f.value) == "np"):
                if (any(self._t(a) for a in node.args)
                        or any(self._t(kw.value) for kw in node.keywords)):
                    self._flag(node, "jit-host-sync",
                               f"np.{f.attr}() on a traced value forces a "
                               "host copy under jit")

    # ---------------- statement walk ---------------- #
    def _stmts(self, body: Sequence[ast.stmt]) -> None:
        for st in body:
            self._stmt(st)

    def _assign_target(self, tgt: ast.AST, tainted: bool,
                       mutation_check: bool = True) -> None:
        if isinstance(tgt, ast.Name):
            if tainted:
                self.tainted.add(tgt.id)
            else:
                self.tainted.discard(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._assign_target(e, tainted, mutation_check)
        elif isinstance(tgt, ast.Starred):
            self._assign_target(tgt.value, tainted, mutation_check)
        elif isinstance(tgt, ast.Attribute):
            if mutation_check and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self":
                self._flag(tgt, "jit-host-state-mutation",
                           f"assignment to self.{tgt.attr} inside "
                           "jit-reachable code mutates host state at trace "
                           "time, not per call")
        elif isinstance(tgt, ast.Subscript):
            base = tgt.value
            if mutation_check and isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self":
                self._flag(tgt, "jit-host-state-mutation",
                           f"in-place write to self.{base.attr}[...] inside "
                           "jit-reachable code mutates host state at trace "
                           "time, not per call")

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs are analyzed as their own functions
        if isinstance(st, ast.Assign):
            self._scan(st.value)
            t = self._t(st.value)
            for tgt in st.targets:
                self._assign_target(tgt, t)
        elif isinstance(st, ast.AnnAssign):
            self._scan(st.value)
            self._assign_target(st.target, self._t(st.value))
        elif isinstance(st, ast.AugAssign):
            self._scan(st.value)
            t = self._t(st.value) or self._t(st.target)
            self._assign_target(st.target, t)
        elif isinstance(st, (ast.If, ast.While)):
            self._scan(st.test)
            if self._t(st.test):
                kind = "if" if isinstance(st, ast.If) else "while"
                self._flag(st, "jit-traced-control-flow",
                           f"`{kind}` on a traced value — use jnp.where / "
                           "lax.cond / lax.while_loop (torch.where, or keep "
                           "the branch outside the capture), or mark the "
                           "argument static")
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.For):
            self._scan(st.iter)
            it = self._t(st.iter)
            if it:
                self._flag(st, "jit-traced-control-flow",
                           "`for` over a traced value — use lax.fori_loop / "
                           "lax.scan, or iterate a static length")
            self._assign_target(st.target, it, mutation_check=False)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.With):
            for item in st.items:
                self._scan(item.context_expr)
            capture = any(_is_graph_capture(i.context_expr) for i in st.items)
            outer, self.flagging = self.flagging, self.flagging or capture
            self._stmts(st.body)
            self.flagging = outer
        elif isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)
        elif isinstance(st, ast.Assert):
            self._scan(st.test)
            if self._t(st.test):
                self._flag(st, "jit-host-sync",
                           "assert on a traced value concretizes it on the "
                           "host (and vanishes under -O)")
        elif isinstance(st, ast.Return):
            self._scan(st.value)
        elif isinstance(st, ast.Expr):
            self._scan(st.value)
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._scan(child)


# --------------------------------------------------------------------- #
# module-level passes
# --------------------------------------------------------------------- #
def _check_removed_pool_qos(tree: ast.AST, path: str,
                            findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Attribute) and node.attr == "qos"):
            continue
        base = node.value
        is_pool = (
            (isinstance(base, ast.Name) and base.id == "pool")
            or (isinstance(base, ast.Attribute) and base.attr == "pool")
        )
        if is_pool:
            findings.append(Finding(
                path, node.lineno, node.col_offset, "removed-pool-qos",
                "pool.qos was removed; attach a TieringControl via "
                "pool.control (see DESIGN.md §8)",
            ))


def _check_assert_host_sync(tree: ast.AST, path: str,
                            findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assert):
            continue
        for sub in ast.walk(node.test):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "item"):
                findings.append(Finding(
                    path, node.lineno, node.col_offset, "assert-host-sync",
                    "assert calls .item() — a host sync that disappears "
                    "under python -O; suppress if intentional",
                ))
                break


def _check_missing_tenant(tree: ast.AST, path: str,
                          findings: List[Finding]) -> None:
    for fnode in ast.walk(tree):
        if not isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        names = set(_all_params(fnode))
        for node in ast.walk(fnode):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
            elif isinstance(node, ast.For):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        if not (names & TENANTISH):
            continue
        for node in ast.walk(fnode):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _ALLOC_ARITY):
                continue
            kw_names = {kw.arg for kw in node.keywords}
            if {"tenant", "tenants"} & kw_names or None in kw_names:
                continue  # attributed (or forwarded via **kwargs)
            if len(node.args) >= _ALLOC_ARITY[node.func.attr]:
                continue  # tenant passed positionally
            findings.append(Finding(
                path, node.lineno, node.col_offset, "missing-tenant",
                f"{node.func.attr}() without tenant= in a tenant-aware "
                "scope — the QoS ledger loses this page's attribution",
            ))


def _check_unstable_static(info: _FuncInfo, path: str,
                           findings: List[Finding]) -> None:
    if not info.static:
        return
    fnode = info.node
    params = _all_params(fnode)
    missing = info.static - set(params)
    for name in sorted(missing):
        findings.append(Finding(
            path, info.jit_site_line, fnode.col_offset, "jit-unstable-static",
            f"static arg {name!r} is not a parameter of {info.name}() — "
            "typo'd static names silently trace the argument instead",
        ))
    # mutable defaults on static params: unhashable at the jit cache key
    a = fnode.args
    pos = _positional_params(fnode)
    defaults = dict(zip(pos[len(pos) - len(a.defaults):], a.defaults))
    defaults.update({
        p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None
    })
    for name in sorted(info.static & set(defaults)):
        d = defaults[name]
        mutable = isinstance(d, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                 ast.DictComp, ast.SetComp))
        if (not mutable and isinstance(d, ast.Call)
                and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set")):
            mutable = True
        if mutable:
            findings.append(Finding(
                path, d.lineno, d.col_offset, "jit-unstable-static",
                f"static arg {name!r} has a mutable default — unhashable "
                "as a jit cache key (TypeError at call time)",
            ))


# --------------------------------------------------------------------- #
# suppression comments
# --------------------------------------------------------------------- #
def _suppressions(src: str) -> Dict[int, Optional[Set[str]]]:
    """line -> suppressed rule set (None = all rules)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for lineno, line in enumerate(src.splitlines(), 1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        spec = m.group(1)
        rules: Optional[Set[str]] = None
        if spec:
            rules = {r.strip() for r in spec.split(",") if r.strip()}
        out[lineno] = rules
        if line.lstrip().startswith("#"):
            # a standalone suppression comment covers the next line
            out[lineno + 1] = rules
    return out


def _suppressed(f: Finding, sup: Dict[int, Optional[Set[str]]]) -> bool:
    if f.line not in sup:
        return False
    rules = sup[f.line]
    return rules is None or f.rule in rules


# --------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------- #
def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source; returns suppression-filtered findings."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        # a file that cannot parse must fail the lint lane, not crash it
        return [Finding(path, exc.lineno or 1, (exc.offset or 1) - 1,
                        "syntax-error", exc.msg or "invalid syntax")]
    findings: List[Finding] = []

    collector = _Collector()
    collector.visit(tree)
    for name, statics in collector.registered.items():
        for info in collector.by_name.get(name, []):
            info.is_root = True
            info.static |= statics

    # jit reachability over bare names (same-module fixpoint)
    reachable: Set[str] = set(collector.kernels)
    frontier = [fi.name for fi in collector.functions if fi.is_root]
    frontier += list(collector.kernels)
    reachable.update(fi.name for fi in collector.functions if fi.is_root)
    # functions a CUDA-graph capture block calls are captured too
    for fi in collector.functions:
        for block in fi.captures:
            for callee in _callees(ast.Module(body=block.body, type_ignores=[])):
                if callee in collector.by_name and callee not in reachable:
                    reachable.add(callee)
                    frontier.append(callee)
    while frontier:
        name = frontier.pop()
        for info in collector.by_name.get(name, []):
            for callee in _callees(info.node):
                if callee in collector.by_name and callee not in reachable:
                    reachable.add(callee)
                    frontier.append(callee)

    for info in collector.functions:
        if info.is_root:
            _check_unstable_static(info, path, findings)
        if info.is_root or info.name in reachable:
            _FunctionChecker(
                info, info.is_root, info.static, path, findings
            ).run()
        elif info.captures:
            _FunctionChecker(
                info, False, set(), path, findings, capture_only=True
            ).run()

    _check_removed_pool_qos(tree, path, findings)
    _check_assert_host_sync(tree, path, findings)
    _check_missing_tenant(tree, path, findings)

    sup = _suppressions(src)
    out = [f for f in findings if not _suppressed(f, sup)]
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(
                    os.path.join(root, f) for f in files if f.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return sorted(out)


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(lint_file(path))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="repro-lint",
        description="AST static analysis with tiering-repo-specific rules.",
    )
    parser.add_argument("paths", nargs="*", help="files or directories")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)
    if args.list_rules:
        for name, desc in sorted(RULES.items()):
            print(f"{name}: {desc}")
        return 0
    if not args.paths:
        parser.error("no paths given")
    findings = lint_paths(args.paths)
    for f in findings:
        print(f)
    n_files = len(iter_py_files(args.paths))
    status = "clean" if not findings else f"{len(findings)} finding(s)"
    print(f"repro-lint: {n_files} file(s), {status}", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
