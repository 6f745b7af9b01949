"""Layer-1 AST rules for the port (``repro.lint.rules``' port).

Each rule is a small class with an ``applies(relpath)`` path filter and
a ``check(tree, src, relpath)`` generator of :class:`Finding`s. Rules
are conservative by construction: they flag only patterns that are
unambiguous in the AST (a direct ``torch.median`` call, a
``repeat_interleave`` of a K/V-named tensor, a host read inside a
captured step) and leave the gray zone to the layer-2 auditor, which
runs the port's entry points.

``repro``'s RL005 and RL006 read Pallas source; the port's kernels are
CUDA C++ under ``kernels/csrc/``, so they have no counterpart here
(``catalog.NOT_PORTED``).

Everything here is stdlib-only: the AST layer runs where torch is not
installed.
"""
from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .catalog import info
from .findings import Finding

__all__ = ["Rule", "RULES", "rule_ids"]


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('torch.median', 'x.item')."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _base_name(node: ast.AST) -> ast.AST:
    """``k[:, None]`` -> ``k``: the tensor a subscript chain reads."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


class Rule:
    """Base: subclasses set ``id`` and implement ``check``."""

    id: str = ""

    @property
    def name(self) -> str:
        return info(self.id).name

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.AST, src: str, relpath: str,
              path: Optional[str] = None) -> Iterator[Finding]:
        """Findings for one parsed file; ``path`` (the file on disk, when
        known) lets a rule read the modules the file imports."""
        raise NotImplementedError

    def finding(self, relpath: str, line: int, message: str) -> Finding:
        return Finding(rule_id=self.id, path=relpath, line=line,
                       message=message)


# ---------------------------------------------------------------------------
# RL001 — robust aggregation must route through core/estimator
# ---------------------------------------------------------------------------

class DirectAggregationRule(Rule):
    """DESIGN §7: the Estimator layer is the single dispatch site. A
    call site computing ``torch.median`` over a worker/replica stack, or
    reaching into ``core.aggregators`` directly, bypasses backend
    dispatch (the B1/B4 kernels), the spec's validation (trimmed_mean
    beta, the coordinatewise gate) and the hashable spec that keys the
    caches. Host-side numpy and ``statistics`` calls are not on a device
    path, and ``jnp``/``jax`` calls are ``repro``'s (its own lint reads
    them): both are left alone."""

    id = "RL001"

    # The estimator layer itself plus its numerical oracles.
    ALLOW = (
        "core/estimator.py",
        "core/aggregators.py",
        "core/adaptive.py",
        "core/vrmom.py",
        "core/__init__.py",
        "kernels/ref.py",
        "kernels/vrmom.py",
    )
    _AGG_FNS = ("median", "nanmedian", "quantile", "nanquantile")
    _AGG_MODULE_ALIASES = ("aggregators", "_A", "_agg", "AGG", "AG")
    _OTHER_MODULES = ("np", "numpy", "statistics", "math", "jnp", "jax")

    def applies(self, relpath: str) -> bool:
        return not relpath.endswith(self.ALLOW)

    def _call(self, relpath: str, node: ast.Call) -> Optional[Finding]:
        d = _dotted(node.func)
        if isinstance(node.func, ast.Attribute):
            mod, attr = _dotted(node.func.value), node.func.attr
        else:
            mod, attr = "", d
        if mod in self._AGG_MODULE_ALIASES:
            return self.finding(
                relpath, node.lineno,
                f"direct `{d}` call bypasses the Estimator dispatch "
                f"layer; aggregator functions must not be called outside "
                f"core/estimator")
        if attr not in self._AGG_FNS or not isinstance(node.func,
                                                        ast.Attribute):
            return None
        if mod in ("torch", "torch.Tensor"):
            return self.finding(
                relpath, node.lineno,
                f"direct `{d}` call bypasses the Estimator dispatch layer "
                f"(core/estimator, DESIGN §7); use "
                f"Estimator(method=...).apply(x, axis)")
        if mod.split(".")[0] in self._OTHER_MODULES:
            return None
        return self.finding(
            relpath, node.lineno,
            f"`Tensor.{attr}` method call bypasses the Estimator dispatch "
            f"layer (core/estimator, DESIGN §7); use "
            f"Estimator(method=...).apply(x, axis)")

    def check(self, tree, src, relpath, path=None):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = self._call(relpath, node)
                if f is not None:
                    yield f
            elif isinstance(node, ast.ImportFrom):
                module = node.module or ""
                if module.endswith("aggregators"):
                    yield self.finding(
                        relpath, node.lineno,
                        "importing from core.aggregators outside the "
                        "estimator layer — route through "
                        "core.estimator.Estimator instead")
                elif any(a.name == "aggregators" for a in node.names):
                    yield self.finding(
                        relpath, node.lineno,
                        "importing core.aggregators outside the "
                        "estimator layer — route through "
                        "core.estimator.Estimator instead")


# ---------------------------------------------------------------------------
# RL002 — no repeat of K/V head dims in models/ and kernels/
# ---------------------------------------------------------------------------

class KVRepeatRule(Rule):
    """DESIGN §8: GQA is computed grouped; repeating K/V to the query
    head count multiplies cache read traffic by H/Hkv. Flags
    ``repeat_interleave`` (function or method), ``.repeat`` and
    ``.expand(...).reshape/.view/.flatten`` of a K/V-named tensor. Name-
    based on the repeated tensor (k/v/cache.k/...) so the SSM group
    expansion in mamba2 (``B.repeat_interleave``: no KV cache) is not
    dragged in."""

    id = "RL002"

    _KV_NAMES = frozenset((
        "k", "v", "ck", "cv", "kf", "vf", "kk", "vv", "k2", "v2",
        "key", "value", "keys", "values", "k_cache", "v_cache",
    ))
    _FLATTEN = frozenset(("reshape", "view", "flatten"))

    def applies(self, relpath: str) -> bool:
        return "models/" in relpath or "kernels/" in relpath

    def _kv_name(self, node: ast.expr) -> Optional[str]:
        node = _base_name(node)
        if isinstance(node, ast.Name) and node.id.lower() in self._KV_NAMES:
            return node.id
        if isinstance(node, ast.Attribute) and \
                node.attr.lower() in self._KV_NAMES:
            return _dotted(node)
        return None

    def _repeated(self, node: ast.Call) -> Optional[Tuple[str, str]]:
        """(the K/V name, the call's spelling) of a K/V repeat, or None."""
        func = node.func
        d = _dotted(func)
        if d in ("torch.repeat_interleave",) and node.args:
            name = self._kv_name(node.args[0])
            return (name, "torch.repeat_interleave") if name else None
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr in ("repeat_interleave", "repeat"):
            name = self._kv_name(func.value)
            return (name, f".{func.attr}") if name else None
        inner = func.value
        if func.attr in self._FLATTEN and isinstance(inner, ast.Call) and \
                isinstance(inner.func, ast.Attribute) and \
                inner.func.attr == "expand":
            name = self._kv_name(inner.func.value)
            return (name, f".expand(...).{func.attr}") if name else None
        return None

    def check(self, tree, src, relpath, path=None):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            hit = self._repeated(node)
            if hit is not None:
                yield self.finding(
                    relpath, node.lineno,
                    f"`{hit[1]}` of `{hit[0]}` materializes K/V at the "
                    f"query-head count — GQA must stay grouped (B2/B3 "
                    f"read K/V at Hkv, DESIGN §8)")


# ---------------------------------------------------------------------------
# RL003 — nothing in a captured step reads the host
# ---------------------------------------------------------------------------

def _index(tree):
    """(functions by name at any depth, module-level functions by name,
    methods by (class, name), the enclosing class of every def)."""
    fns: Dict[str, List[ast.FunctionDef]] = {}
    top: Dict[str, List[ast.FunctionDef]] = {}
    methods: Dict[Tuple[str, str], ast.FunctionDef] = {}
    owner: Dict[ast.AST, Optional[str]] = {}

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                owner[child] = cls
                if isinstance(node, ast.ClassDef):
                    methods[(cls, child.name)] = child
                else:
                    fns.setdefault(child.name, []).append(child)
                    if node is tree:
                        top.setdefault(child.name, []).append(child)
                visit(child, cls)
            else:
                visit(child, cls)

    visit(tree, None)
    return fns, top, methods, owner


def _module_of(path: str) -> Tuple[str, str, bool]:
    """(dotted module name, the directory its top package sits in, whether
    it is a package's ``__init__``) of a source file."""
    d, base = os.path.split(os.path.abspath(path))
    stem = os.path.splitext(base)[0]
    parts = [] if stem == "__init__" else [stem]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, pkg = os.path.split(d)
        parts.insert(0, pkg)
    return ".".join(parts), d, stem == "__init__"


class _Module:
    """One parsed source file: its defs and the names its imports bind
    (``aliases``: a local name -> a module; ``froms``: a local name ->
    (module, attribute)), found anywhere in the file."""

    def __init__(self, tree, path: Optional[str] = None,
                 cache: Optional[dict] = None):
        self.tree, self.path = tree, path
        # the modules parsed while one file is checked, by path
        self.cache = {} if cache is None else cache
        self.fns, self.top, self.methods, self.owner = _index(tree)
        self.name = self.root = None
        self.aliases: Dict[str, str] = {}
        self.froms: Dict[str, Tuple[str, str]] = {}
        if path is None:
            return
        self.name, self.root, is_init = _module_of(path)
        package = self.name if is_init else self.name.rpartition(".")[0]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name] = a.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg = package.split(".") if package else []
                    pkg = pkg[:len(pkg) - (node.level - 1)]
                    base = ".".join(pkg + ([base] if base else []))
                for a in node.names:
                    self.froms[a.asname or a.name] = (base, a.name)


class CaptureUnsafePythonRule(Rule):
    """A CUDA graph records device work only. Inside a captured step a
    read of a device value on the host (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``int()``/``float()``/``bool()`` of a
    tensor, an ``if``/``while`` on one) or a host-to-device copy
    (``torch.tensor``, ``torch.as_tensor``, ``torch.from_numpy``) makes
    the capture raise, or bakes one step's value into every replay.

    Roots: the functions called in the body of a ``with
    torch.cuda.graph(...)`` block, whose own statements are checked too.
    From the roots the rule follows, transitively, the calls it can resolve:
    ``self.<method>`` in the enclosing class, names bound by a ``def`` in
    the same file, and, when the file is linted from disk, functions of
    ``repro_torch`` (or of the file's own package) reached through an
    import: ``M.decode_step`` after ``from ..models import model as M``,
    ``serve_diag`` after ``from ..obs.diag import serve_diag``. It does
    not resolve a call through a value (``stack_module(cfg).decode_step``,
    ``rcfg.estimator.apply_sample``): what a value's type is, an AST does
    not say; the card's capture (``ServeEngine`` raises when a step
    cannot be captured) covers those. A finding in another file is
    reported at the line of the capturing file whose call leads there,
    naming the far line, so its waiver sits beside the capture.

    Tensor-valued names: a root's parameters, except ``self``, those with
    a constant default, and those annotated with a scalar
    (``bool``/``int``/``float``/``str``) or a config-like spec type
    (``*Config``/``*Spec``/``Estimator``/``Sampling``/``*Setup``, the
    hashable specs of RL004); a followed callee's parameters that its
    call site passes a tensor-valued expression, under the same
    exemptions; and locals assigned from a tensor-valued expression or a
    ``torch.*`` call. ``.shape``/``.ndim``/``.dtype``/``.device`` reads,
    ``.size()``/``.dim()``/``.numel()`` calls and ``is None`` tests are
    static and exempt."""

    id = "RL003"

    _HOST_READS = frozenset(("item", "tolist", "cpu", "numpy"))
    _H2D = frozenset(("torch.tensor", "torch.as_tensor", "torch.from_numpy"))
    _STATIC_ATTRS = frozenset(("shape", "ndim", "dtype", "device", "is_cuda",
                               "layout", "requires_grad"))
    _STATIC_METHODS = frozenset(("size", "dim", "numel", "element_size",
                                 "is_contiguous", "stride", "data_ptr",
                                 "get_device", "is_floating_point"))
    _STATIC_FNS = frozenset(("len", "isinstance", "getattr", "hasattr",
                             "type", "callable", "id", "torch.is_tensor"))
    _CASTS = frozenset(("int", "float", "bool"))
    _SCALARS = frozenset(("bool", "int", "float", "str"))
    _SPEC_NAME = re.compile(r"(Config|Spec|Specs|Estimator|Sampling|Setup)$")
    # packages whose functions the rule follows, beside the file's own
    _FOLLOW = ("repro_torch",)

    # -- resolution --------------------------------------------------------

    def _file_of(self, module: str, roots: Sequence[str]) -> Optional[str]:
        rel = module.replace(".", os.sep)
        for root in roots:
            for cand in (os.path.join(root, rel + ".py"),
                         os.path.join(root, rel, "__init__.py")):
                if os.path.isfile(cand):
                    return cand
        return None

    def _load(self, module: str, near: _Module) -> Optional[_Module]:
        """The parsed module ``module``, looked up beside ``near``'s top
        package and on ``sys.path`` (parsed once a check, in ``near.cache``);
        None outside the followed packages or when it cannot be found or
        parsed."""
        if near.root is None or module.split(".")[0] not in (
                self._FOLLOW + (near.name.split(".")[0],)):
            return None
        path = self._file_of(module, [near.root] + [
            p for p in sys.path if p and os.path.isdir(p)])
        if path is None:
            return None
        if path not in near.cache:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    near.cache[path] = _Module(ast.parse(fh.read()), path,
                                               near.cache)
            except (OSError, SyntaxError, UnicodeDecodeError):
                near.cache[path] = None
        return near.cache[path]

    def _attr(self, module: str, attr: str, near: _Module, hops: int = 3
              ) -> List[Tuple[_Module, ast.FunctionDef]]:
        """Module-level functions ``attr`` of ``module``, through up to
        ``hops`` re-exports."""
        sub = self._load(f"{module}.{attr}", near)
        mod = self._load(module, near)
        if mod is None or sub is not None:
            return []
        if attr in mod.top:
            return [(mod, fn) for fn in mod.top[attr]]
        if attr in mod.froms and hops:
            return self._attr(*mod.froms[attr], mod, hops - 1)
        return []

    def _resolve(self, call: ast.Call, mod: _Module, cls: Optional[str]
                 ) -> List[Tuple[_Module, ast.FunctionDef]]:
        f = call.func
        if isinstance(f, ast.Attribute):
            base = _dotted(f.value)
            if base == "self":
                m = mod.methods.get((cls, f.attr)) if cls else None
                return [(mod, m)] if m is not None else []
            target = mod.aliases.get(base)
            if target is None and base in mod.froms:
                pkg, name = mod.froms[base]
                target = f"{pkg}.{name}" if pkg else name
                if self._load(target, mod) is None:
                    target = None
            if target is None:
                return []
            other = self._load(target, mod)
            if other is None:
                return []
            return [(other, fn) for fn in other.top.get(f.attr, ())]
        if isinstance(f, ast.Name):
            if f.id in mod.fns:
                return [(mod, fn) for fn in mod.fns[f.id]]
            if f.id in mod.froms:
                return self._attr(*mod.froms[f.id], mod)
        return []

    # -- tensor-valued names -----------------------------------------------

    def _static_param(self, arg: ast.arg, default) -> bool:
        if arg.arg in ("self", "cls"):
            return True
        if isinstance(default, ast.Constant):
            return True
        ann = arg.annotation
        if ann is None:
            return False
        name = _dotted(ann) if not isinstance(ann, ast.Constant) else \
            str(ann.value)
        name = name.rsplit(".", 1)[-1]
        return name in self._SCALARS or bool(self._SPEC_NAME.search(name))

    def _params(self, fn) -> List[Tuple[ast.arg, Optional[ast.expr]]]:
        a = fn.args
        pos = a.posonlyargs + a.args
        defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
        out = list(zip(pos, defaults))
        out += list(zip(a.kwonlyargs, a.kw_defaults))
        return out

    def _own(self, fn) -> Set[str]:
        """A root's tensor-valued parameters."""
        return {a.arg for a, d in self._params(fn)
                if not self._static_param(a, d)}

    def _uses(self, expr: ast.AST, tainted: Set[str]) -> Optional[str]:
        """The first tensor-valued name ``expr`` reads outside a static
        read, or None."""
        if isinstance(expr, ast.Attribute):
            if expr.attr in self._STATIC_ATTRS:
                return None
            return self._uses(expr.value, tainted)
        if isinstance(expr, ast.Name):
            return expr.id if expr.id in tainted else None
        if isinstance(expr, ast.Call):
            f = expr.func
            if _dotted(f) in self._STATIC_FNS:
                return None
            if isinstance(f, ast.Attribute) and \
                    f.attr in self._STATIC_METHODS:
                return None
            for sub in [f] + list(expr.args) + [k.value
                                               for k in expr.keywords]:
                hit = self._uses(sub, tainted)
                if hit:
                    return hit
            return None
        if isinstance(expr, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return None
        if isinstance(expr, (ast.Lambda, ast.FunctionDef)):
            return None
        for child in ast.iter_child_nodes(expr):
            hit = self._uses(child, tainted)
            if hit:
                return hit
        return None

    def _makes_tensor(self, expr: ast.AST, tainted: Set[str]) -> bool:
        if self._uses(expr, tainted):
            return True
        return any(isinstance(n, ast.Call) and
                   _dotted(n.func).startswith("torch.")
                   for n in ast.walk(expr))

    @staticmethod
    def _targets(node) -> List[ast.expr]:
        if isinstance(node, ast.Assign):
            return node.targets
        if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            return [node.target]
        if isinstance(node, (ast.For, ast.AsyncFor)):
            return [node.target]
        if isinstance(node, ast.withitem) and node.optional_vars is not None:
            return [node.optional_vars]
        if isinstance(node, ast.NamedExpr):
            return [node.target]
        return []

    @staticmethod
    def _value(node):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            return node.iter
        if isinstance(node, ast.withitem):
            return node.context_expr
        return getattr(node, "value", None)

    def _taint(self, body: Sequence[ast.AST], tainted: Set[str]) -> Set[str]:
        """``tainted`` grown by the locals the statements assign from
        tensor-valued expressions, to a fixed point (loops)."""
        tainted = set(tainted)
        nodes = [n for stmt in body for n in ast.walk(stmt)
                 if self._targets(n)]
        changed = True
        while changed:
            changed = False
            for n in nodes:
                value = self._value(n)
                if value is None or not self._makes_tensor(value, tainted):
                    continue
                for t in self._targets(n):
                    for name in ast.walk(t):
                        if isinstance(name, ast.Name) and \
                                name.id not in tainted:
                            tainted.add(name.id)
                            changed = True
        return tainted

    def _passed(self, call: ast.Call, callee, tainted: Set[str]) -> Set[str]:
        """The callee's parameters that ``call`` passes a tensor-valued
        expression, less those static by annotation or default."""
        params = self._params(callee)
        names = [a.arg for a, _ in params]
        offset = 1 if names[:1] in (["self"], ["cls"]) and isinstance(
            call.func, ast.Attribute) else 0
        passed: Set[str] = set()
        for i, arg in enumerate(call.args):
            if i + offset < len(names) and self._uses(arg, tainted):
                passed.add(names[i + offset])
        for kw in call.keywords:
            if kw.arg in names and self._uses(kw.value, tainted):
                passed.add(kw.arg)
        return passed - {a.arg for a, d in params
                         if self._static_param(a, d)}

    # -- the checks --------------------------------------------------------

    def _walk_own(self, body: Sequence[ast.AST]) -> Iterator[ast.AST]:
        """Every node of ``body`` outside nested defs and lambdas."""
        stack = list(reversed(body))
        while stack:
            node = stack.pop()
            yield node
            for child in reversed(list(ast.iter_child_nodes(node))):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda, ast.ClassDef)):
                    stack.append(child)

    def _check_body(self, body, tainted, where: str):
        for node in self._walk_own(body):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                hit = self._uses(node.test, tainted)
                if hit:
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "conditional expression"}[type(node)]
                    yield node.lineno, (
                        f"Python `{kind}` on `{hit}`, a tensor, in "
                        f"{where} — reads a device value on the host; "
                        f"use torch.where or make it static")
            elif isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in self._H2D:
                    yield node.lineno, (
                        f"`{d}(...)` in {where} copies host to device, "
                        f"which a capture cannot record; build it before "
                        f"the capture or on the device")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in self._HOST_READS:
                    yield node.lineno, (
                        f"`.{node.func.attr}()` in {where} reads a device "
                        f"value on the host, which a capture cannot "
                        f"record")
                elif isinstance(node.func, ast.Name) and \
                        node.func.id in self._CASTS:
                    for a in node.args:
                        hit = self._uses(a, tainted)
                        if hit:
                            yield node.lineno, (
                                f"`{node.func.id}()` of `{hit}`, a "
                                f"tensor, in {where} — reads a device "
                                f"value on the host")
                            break

    def _roots(self, mod: _Module):
        """(enclosing def or None, the captured statements, line) of every
        ``with torch.cuda.graph(...)`` block."""
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

        def enclosing(node):
            while node in parents:
                node = parents[node]
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    return node
            return None

        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call) and
                    _dotted(it.context_expr.func) in ("torch.cuda.graph",
                                                      "cuda.graph")
                    for it in node.items):
                yield enclosing(node), node.body, node.lineno

    def check(self, tree, src, relpath, path=None):
        root = _Module(tree, path)
        reported: Set[Tuple[int, str]] = set()
        done: Set[Tuple[int, frozenset]] = set()

        def emit(mod, line, msg, site, anchor):
            if mod is not root:
                far = os.path.relpath(mod.path, mod.root).replace(os.sep, "/")
                msg, line = f"{msg} [{far}:{line}]", anchor
            if (line, msg) not in reported:
                reported.add((line, msg))
                yield self.finding(relpath, line,
                                   f"{msg} (captured at line {site})")

        def visit(mod, fn, body, tainted, where, site, anchor):
            for line, msg in self._check_body(body, tainted, where):
                yield from emit(mod, line, msg, site, anchor)
            cls = mod.owner.get(fn) if fn is not None else None
            for node in self._walk_own(body):
                if not isinstance(node, ast.Call):
                    continue
                for other, callee in self._resolve(node, mod, cls):
                    taint = frozenset(self._passed(node, callee, tainted))
                    if (id(callee), taint) in done:
                        continue
                    done.add((id(callee), taint))
                    name = (callee.name if other is root
                            else f"{other.name}.{callee.name}")
                    yield from visit(
                        other, callee, callee.body,
                        self._taint(callee.body, set(taint)), f"`{name}`",
                        site, anchor if mod is not root else node.lineno)

        for fn, body, line in self._roots(root):
            tainted = self._taint(tree.body if fn is None else fn.body,
                                  set() if fn is None else self._own(fn))
            where = ("a captured block" if fn is None
                     else f"the captured block of `{fn.name}`")
            yield from visit(root, fn, body, tainted, where, line, line)


# ---------------------------------------------------------------------------
# RL004 — config-like statics must be hashable
# ---------------------------------------------------------------------------

class UnhashableStaticRule(Rule):
    """Specs key the port's caches (captured steps by ``Sampling``, the
    kernels' tables by their spec) by hash/eq. An unfrozen dataclass is
    unhashable; a hashable spec with a list/dict field hashes by content
    that can mutate. Name-scoped to config-like classes so host-side
    mutable records (scheduler bookkeeping, buffers) stay legal."""

    id = "RL004"

    _CONFIG_NAME = re.compile(r"(Config|Spec|Specs|Estimator|Sampling|Setup)$")
    _MUTABLE_TYPES = frozenset((
        "list", "dict", "set", "List", "Dict", "Set", "MutableMapping",
        "bytearray", "ndarray", "Tensor",
    ))

    def _dataclass_dec(self, cls: ast.ClassDef) -> Optional[ast.expr]:
        for dec in cls.decorator_list:
            d = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
            if d in ("dataclass", "dataclasses.dataclass"):
                return dec
        return None

    def _is_frozen(self, dec: ast.expr) -> bool:
        if not isinstance(dec, ast.Call):
            return False
        return any(kw.arg == "frozen" and isinstance(kw.value, ast.Constant)
                   and kw.value.value is True for kw in dec.keywords)

    def _is_namedtuple(self, cls: ast.ClassDef) -> bool:
        return any(_dotted(b) in ("NamedTuple", "typing.NamedTuple")
                   for b in cls.bases)

    def _mutable_ann(self, ann: ast.expr) -> Optional[str]:
        for node in ast.walk(ann):
            if isinstance(node, ast.Name) and node.id in self._MUTABLE_TYPES:
                return node.id
            if isinstance(node, ast.Attribute) and \
                    node.attr in self._MUTABLE_TYPES:
                return node.attr
        return None

    def check(self, tree, src, relpath, path=None):
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not self._CONFIG_NAME.search(node.name):
                continue
            dec = self._dataclass_dec(node)
            hashable_spec = self._is_namedtuple(node) or (
                dec is not None and self._is_frozen(dec))
            if dec is not None and not self._is_frozen(dec):
                yield self.finding(
                    relpath, node.lineno,
                    f"config-like dataclass `{node.name}` is not "
                    f"frozen=True: unhashable, so it cannot key a cache "
                    f"(DESIGN §7)")
            if hashable_spec or dec is not None:
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign):
                        bad = self._mutable_ann(stmt.annotation)
                        if bad:
                            field = (stmt.target.id
                                     if isinstance(stmt.target, ast.Name)
                                     else "<field>")
                            yield self.finding(
                                relpath, stmt.lineno,
                                f"`{node.name}.{field}` is typed "
                                f"`{bad}` — unhashable field in a "
                                f"static spec; use a tuple / frozen type")


# ---------------------------------------------------------------------------
# RL007 — wall-clock reads route through the obs layer
# ---------------------------------------------------------------------------

class WallClockOutsideObsRule(Rule):
    """DESIGN §11: ``obs.metrics.now()`` is the port's single wall-clock
    site. A stray ``time.time()``/``perf_counter()`` in library code is
    dead telemetry (drained into no registry) or a host sync hiding
    beside a device path that no profiler span attributes. Scoped to
    ``src/repro_torch/`` (scripts, ``chip_smoke.py`` and tests time
    things as they like); the body of ``now`` in ``obs/metrics.py`` is
    the one allowed caller."""

    id = "RL007"

    _CLOCK_FNS = frozenset(("time", "perf_counter", "monotonic",
                            "process_time", "perf_counter_ns",
                            "monotonic_ns", "time_ns"))

    def applies(self, relpath: str) -> bool:
        return "src/repro_torch/" in relpath or \
            relpath.startswith("repro_torch/")

    def check(self, tree, src, relpath, path=None):
        allowed: Set[ast.AST] = set()
        if relpath.endswith("obs/metrics.py"):
            for node in ast.walk(tree):
                if isinstance(node, ast.FunctionDef) and node.name == "now":
                    allowed.update(ast.walk(node))
        for node in ast.walk(tree):
            if node in allowed:
                continue
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                mod, _, attr = d.rpartition(".")
                if mod == "time" and attr in self._CLOCK_FNS:
                    yield self.finding(
                        relpath, node.lineno,
                        f"direct `{d}()` call outside obs.metrics.now() — "
                        f"library code reads the wall clock through "
                        f"repro_torch.obs.metrics.now() (DESIGN §11)")
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "") == "time":
                    bad = [a.name for a in node.names
                           if a.name in self._CLOCK_FNS]
                    if bad:
                        yield self.finding(
                            relpath, node.lineno,
                            f"importing {', '.join(bad)} from time "
                            f"outside obs.metrics.now() — use "
                            f"repro_torch.obs.metrics.now() (DESIGN §11)")


RULES: Sequence[Rule] = (
    DirectAggregationRule(),
    KVRepeatRule(),
    CaptureUnsafePythonRule(),
    UnhashableStaticRule(),
    WallClockOutsideObsRule(),
)


def rule_ids() -> Tuple[str, ...]:
    return tuple(r.id for r in RULES)
