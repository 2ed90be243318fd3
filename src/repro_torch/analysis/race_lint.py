"""GBA-RACE: AST lock-discipline lint for the serving-thread modules.

Counterpart of ``repro.analysis.race_lint``, which has no framework in it:
the same pass, over the port's serving modules and hot-ID cache
(:data:`DEFAULT_MODULES`, read from ``repro_torch``'s own path).

The serving path runs a daemon sync thread (``LiveSource._loop``)
and listener callbacks (``add_listener``) against engine code running on
the request thread.  The shipped concurrency contract is:

* shared mutable state is written under the instance lock, **or**
  published as a single plain assignment of an immutable snapshot
  (``self._snap = Snapshot(...)``) that readers grab with ONE attribute
  read;
* a consistent multi-field view (e.g. version+step) is only obtainable
  under the lock;
* listener callbacks are invoked with NO lock held.

This lint proves the contract per class, with inherited methods merged
in (``LiveSource`` inherits ``ParamSource._notify``):

* **RACE-001** an attribute that is lock-guarded anywhere in its class
  (written at least once under a lock), or in-place-mutated by a
  sync-thread-reachable method, is mutated somewhere WITHOUT the lock.
  A plain attribute rebind of a never-in-place-mutated attr is blessed
  as a snapshot swap.
* **RACE-002** a method outside the sync set reads >= 2 distinct
  lock-guarded attributes outside the lock — it can observe a torn
  pair.  Reads of guarded attrs of *other* analyzed classes through a
  typed attribute (``self.channel.last_step`` where
  ``channel: UpdateChannel``) count toward the pair.  A single unlocked
  guarded read (the snapshot idiom) is blessed.
* **RACE-003** a notifier (a method that calls stored listener
  callables, transitively) is reached from inside a ``with self._lock:``
  region — shared state escapes through the callback while the lock is
  held.

Thread entries are found structurally: ``threading.Thread(target=
self.M)`` and ``<anything>.add_listener(self.M)``.  The sync set is the
self-call closure of the entries.  ``__init__`` is construction-time
and exempt from access accounting.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.rules import Finding, finding

DEFAULT_MODULES = (
    "serving/config.py",
    "serving/sources.py",
    "serving/engine.py",
    "serving/recsys.py",
    "embeddings/hot_cache.py",
)

_LOCK_CTORS = {"Lock", "RLock"}
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "clear",
             "add", "discard", "update", "setdefault", "popitem",
             "appendleft", "popleft", "sort", "reverse"}


@dataclass
class Access:
    attr: str
    kind: str            # "read" | "write" | "mutate"
    locked: bool
    lineno: int
    via: str | None = None   # typed-attr chain: access to other_class.attr


@dataclass
class ClassInfo:
    name: str
    module: str
    methods: dict = field(default_factory=dict)     # name -> FunctionDef
    lock_attrs: set = field(default_factory=set)
    attr_types: dict = field(default_factory=dict)  # attr -> class name
    entries: set = field(default_factory=set)       # thread-entry methods
    calls: dict = field(default_factory=dict)       # method -> {self-calls}
    accesses: dict = field(default_factory=dict)    # method -> [Access]
    notify_roots: set = field(default_factory=set)  # direct callback callers
    locked_calls: dict = field(default_factory=dict)  # method -> {self-calls
    #                                                    made under a lock}
    locked_regions: int = 0
    bases: list = field(default_factory=list)

    def site(self, method: str) -> str:
        return f"serving/{self.module}:{self.name}.{method}"


def _is_self_attr(node) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _self_attr_chain(node):
    """``self.a.b`` -> ("a", "b"); ``self.a`` -> ("a", None); else None."""
    if _is_self_attr(node):
        return node.attr, None
    if (isinstance(node, ast.Attribute) and _is_self_attr(node.value)):
        return node.value.attr, node.attr
    return None


def _call_name(node):
    """Callee name of a Call: ``threading.Thread`` -> "Thread",
    ``Lock()`` -> "Lock"."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


class _MethodScan(ast.NodeVisitor):
    """Collect accesses / self-calls / callback invocations of one
    method, tracking lexical ``with self.<lock>:`` depth."""

    def __init__(self, info: ClassInfo, method: str):
        self.info = info
        self.method = method
        self.depth = 0
        self.accesses: list[Access] = []
        self.calls: set = set()
        self.locked_calls: set = set()
        self.callback_vars: set = set()
        self.calls_callback = False
        self._store_ctx: list = []

    # -- lock regions ---------------------------------------------------

    def visit_With(self, node):
        lock_items = sum(
            1 for item in node.items
            if (chain := _self_attr_chain(item.context_expr)) is not None
            and chain[1] is None and chain[0] in self.info.lock_attrs)
        for item in node.items:
            self.visit(item.context_expr)
        if lock_items:
            self.info.locked_regions += 1
        self.depth += lock_items
        for stmt in node.body:
            self.visit(stmt)
        self.depth -= lock_items

    # -- stores / mutations ---------------------------------------------

    def _record(self, attr, kind, lineno, via=None):
        self.accesses.append(Access(attr, kind, self.depth > 0, lineno,
                                    via))

    def visit_Assign(self, node):
        self.visit(node.value)
        for tgt in node.targets:
            self._store(tgt, node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self.visit(node.value)
            self._store(node.target, node)

    def visit_AugAssign(self, node):
        self.visit(node.value)
        chain = _self_attr_chain(node.target)
        if chain and chain[1] is None:
            self._record(chain[0], "mutate", node.lineno)

    def _store(self, tgt, node):
        if (chain := _self_attr_chain(tgt)) is not None:
            attr, sub = chain
            if sub is None:
                self._record(attr, "write", node.lineno)
            else:
                self._record(attr, "mutate", node.lineno)  # self.a.b = ...
        elif isinstance(tgt, ast.Subscript):
            if (chain := _self_attr_chain(tgt.value)) is not None \
                    and chain[1] is None:
                self._record(chain[0], "mutate", node.lineno)
            else:
                self.visit(tgt.value)
            self.visit(tgt.slice)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._store(el, node)

    def visit_Delete(self, node):
        for tgt in node.targets:
            base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
            if (chain := _self_attr_chain(base)) is not None:
                self._record(chain[0], "mutate", node.lineno)

    # -- calls / reads ----------------------------------------------------

    def visit_Call(self, node):
        name = _call_name(node)
        fn = node.func

        # self.method(...) — a self-call, not an attribute read
        if _is_self_attr(fn):
            if fn.attr in self.info.methods:
                self.calls.add(fn.attr)
                if self.depth > 0:
                    self.locked_calls.add(fn.attr)
            else:
                self._record(fn.attr, "read", node.lineno)
        # self.a.b(...): mutator methods mutate self.a; others read it
        elif (isinstance(fn, ast.Attribute)
              and (chain := _self_attr_chain(fn.value)) is not None
              and chain[1] is None):
            kind = "mutate" if fn.attr in _MUTATORS else "read"
            self._record(chain[0], kind, node.lineno)
        # loop_var(...) where loop_var came from iterating stored state
        elif isinstance(fn, ast.Name) and fn.id in self.callback_vars:
            self.calls_callback = True
        else:
            self.visit(fn)

        for a in node.args:
            self.visit(a)
        for kw in node.keywords:
            self.visit(kw.value)

        # thread entries: Thread(target=self.M) / x.add_listener(self.M)
        entry_args = []
        if name == "Thread":
            entry_args = [kw.value for kw in node.keywords
                          if kw.arg == "target"]
        elif name == "add_listener":
            entry_args = list(node.args)
        for a in entry_args:
            if _is_self_attr(a) and a.attr in self.info.methods:
                self.info.entries.add(a.attr)

    def visit_For(self, node):
        # ``for fn in self._listeners: fn(...)`` — fn is a stored callable
        src = node.iter
        chain = None
        if isinstance(src, ast.Call) and _call_name(src) in (
                "list", "tuple", "getattr"):
            # getattr(self, "_listeners", []) names the attr as a string
            if (_call_name(src) == "getattr" and len(src.args) >= 2
                    and isinstance(src.args[0], ast.Name)
                    and src.args[0].id == "self"
                    and isinstance(src.args[1], ast.Constant)
                    and isinstance(src.args[1].value, str)):
                chain = (src.args[1].value, None)
            else:
                for a in src.args:
                    if (c := _self_attr_chain(a)) is not None \
                            and c[1] is None:
                        chain = c
                        break
        elif (c := _self_attr_chain(src)) is not None and c[1] is None:
            chain = c
        if chain is not None and isinstance(node.target, ast.Name):
            self.callback_vars.add(node.target.id)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if isinstance(node.ctx, ast.Load):
            if _is_self_attr(node):
                self._record(node.attr, "read", node.lineno)
                return
            if (chain := _self_attr_chain(node)) is not None:
                attr, sub = chain
                self._record(attr, "read", node.lineno, via=sub)
                return
        self.generic_visit(node)


def _scan_class(node: ast.ClassDef, module: str,
                base_methods: dict | None = None) -> ClassInfo:
    info = ClassInfo(name=node.name, module=module)
    if base_methods:
        info.methods.update(base_methods)   # inherited, overridable
    for item in node.body:
        if isinstance(item, ast.FunctionDef):
            info.methods[item.name] = item

    # pass 0: lock attrs + typed attrs, from any method body
    for meth in info.methods.values():
        for sub in ast.walk(meth):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                chain = _self_attr_chain(tgt)
                if chain is None or chain[1] is not None:
                    continue
                attr = chain[0]
                v = sub.value
                if isinstance(v, ast.Call):
                    cname = _call_name(v)
                    if cname in _LOCK_CTORS:
                        info.lock_attrs.add(attr)
                    elif cname:
                        info.attr_types.setdefault(attr, cname)
                elif isinstance(v, ast.IfExp):
                    for arm in (v.body, v.orelse):
                        if isinstance(arm, ast.Call) \
                                and (cn := _call_name(arm)):
                            info.attr_types.setdefault(attr, cn)
                elif isinstance(v, ast.Name):
                    info.attr_types.setdefault(attr, f"${v.id}")
        # constructor params annotated with a class type
        if meth.name == "__init__":
            for arg in meth.args.args + meth.args.kwonlyargs:
                ann = arg.annotation
                tname = None
                if isinstance(ann, ast.Name):
                    tname = ann.id
                elif isinstance(ann, ast.Constant) \
                        and isinstance(ann.value, str):
                    tname = ann.value
                if tname:
                    for sub in ast.walk(meth):
                        if (isinstance(sub, ast.Assign)
                                and isinstance(sub.value, ast.Name)
                                and sub.value.id == arg.arg):
                            for tgt in sub.targets:
                                c = _self_attr_chain(tgt)
                                if c and c[1] is None:
                                    info.attr_types[c[0]] = tname

    # pass 1: per-method accesses / calls
    for name, meth in info.methods.items():
        scan = _MethodScan(info, name)
        for stmt in meth.body:
            scan.visit(stmt)
        info.accesses[name] = scan.accesses
        info.calls[name] = scan.calls
        info.locked_calls[name] = scan.locked_calls
        if scan.calls_callback:
            info.notify_roots.add(name)
    return info


def _closure(seeds, edges) -> set:
    out = set(seeds)
    frontier = list(seeds)
    while frontier:
        m = frontier.pop()
        for callee in edges.get(m, ()):
            if callee not in out:
                out.add(callee)
                frontier.append(callee)
    return out


def analyze_classes(sources: dict) -> dict:
    """``{module_name: source_text}`` -> ``{class_name: ClassInfo}``.
    Name-based inheritance: a subclass of another analyzed class is
    scanned with the base's method ASTs merged in, so inherited methods
    (``LiveSource._notify``) participate in the sync-reachability and
    notifier analyses of the subclass."""
    raw: dict[str, tuple] = {}
    for module, src in sources.items():
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                raw[node.name] = (node, module)

    def methods_of(name, seen=()):
        if name not in raw or name in seen:
            return {}
        node, _ = raw[name]
        merged: dict = {}
        for b in node.bases:
            if isinstance(b, ast.Name):
                merged.update(methods_of(b.id, seen + (name,)))
        merged.update({item.name: item for item in node.body
                       if isinstance(item, ast.FunctionDef)})
        return merged

    classes: dict[str, ClassInfo] = {}
    for name, (node, module) in raw.items():
        base_methods = {}
        for b in node.bases:
            if isinstance(b, ast.Name):
                base_methods.update(methods_of(b.id))
        info = _scan_class(node, module, base_methods)
        info.bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
        classes[name] = info
    return classes


def _guarded_attrs(info: ClassInfo) -> set:
    """Attrs with at least one locked write/mutate anywhere in the
    class (outside __init__ the lock is the only sanctioned writer)."""
    out = set()
    for name, accs in info.accesses.items():
        for a in accs:
            if a.kind in ("write", "mutate") and a.locked:
                out.add(a.attr)
    return out - info.lock_attrs


def lint_classes(classes: dict) -> list[Finding]:
    findings: list[Finding] = []
    for info in classes.values():
        sync = _closure(info.entries, info.calls)
        guarded = _guarded_attrs(info)
        # attrs ever mutated in place (not a plain snapshot rebind)
        inplace = {a.attr for name, accs in info.accesses.items()
                   for a in accs
                   if a.kind == "mutate" and name != "__init__"}

        # RACE-001: unlocked mutation of guarded / sync-shared state
        for name, accs in info.accesses.items():
            if name == "__init__":
                continue
            for a in accs:
                if a.locked or a.kind == "read":
                    continue
                shared = a.attr in guarded or (
                    name in sync and a.attr in inplace)
                blessed_swap = (a.kind == "write"
                                and a.attr not in inplace
                                and a.attr not in guarded)
                if shared and not blessed_swap:
                    findings.append(finding(
                        "GBA-RACE-001", info.site(name),
                        f"'{a.attr}' is lock-guarded elsewhere in "
                        f"{info.name} but {a.kind}d here (line "
                        f"{a.lineno}) without the lock"))

        # RACE-002: torn multi-attribute unlocked reads
        for name, accs in info.accesses.items():
            if name == "__init__" or name in sync:
                continue
            torn: dict[str, int] = {}
            for a in accs:
                if a.locked or a.kind != "read":
                    continue
                if a.attr in guarded:
                    # a chained self.a.b read still reads guarded self.a
                    torn.setdefault(a.attr, a.lineno)
                elif a.via is not None:
                    tname = info.attr_types.get(a.attr)
                    other = classes.get(tname) if tname else None
                    if other is not None and a.via in _guarded_attrs(other):
                        torn.setdefault(f"{a.attr}.{a.via}", a.lineno)
            if len(torn) >= 2:
                findings.append(finding(
                    "GBA-RACE-002", info.site(name),
                    f"reads {sorted(torn)} outside the lock — the pair "
                    f"can be torn by a concurrent sync (first reads at "
                    f"lines {sorted(torn.values())})"))

        # RACE-003: callback invoked while holding the lock.  A method
        # reaches-notify if its self-call chain ends in a notify root.
        reaches_notify = set(info.notify_roots)
        changed = True
        while changed:
            changed = False
            for m, callees in info.calls.items():
                if m not in reaches_notify and callees & reaches_notify:
                    reaches_notify.add(m)
                    changed = True
        for name, locked_callees in info.locked_calls.items():
            hot = locked_callees & reaches_notify
            if hot:
                findings.append(finding(
                    "GBA-RACE-003", info.site(name),
                    f"calls {sorted(hot)} (which invokes stored listener "
                    f"callbacks) while holding the lock — callbacks must "
                    f"run lock-free"))
    return findings


def lint_sources(sources: dict) -> tuple[list[Finding], dict]:
    """``{module: source}`` -> (findings, stats)."""
    classes = analyze_classes(sources)
    findings = lint_classes(classes)
    stats = {
        "race_classes": len(classes),
        "race_entries": sum(len(c.entries) for c in classes.values()),
        "race_guarded_attrs": sum(len(_guarded_attrs(c))
                                  for c in classes.values()),
        "race_locked_regions": sum(c.locked_regions
                                   for c in classes.values()),
    }
    return findings, stats


def lint_default() -> tuple[list[Finding], dict]:
    """Lint the port's serving modules + the hot-ID cache."""
    import repro_torch
    root = Path(next(iter(repro_torch.__path__)))
    sources = {Path(rel).stem: (root / rel).read_text()
               for rel in DEFAULT_MODULES}
    return lint_sources(sources)
