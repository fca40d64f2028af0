"""Host-sync linter for the event loops and the static-gate purity check
(port of ``repro/analysis/lint.py``).

**AST pass** (``lint_paths``).  The reference lints functions reachable
from traced code; the port has no tracing, and what its loops must keep
out is the host waiting on the card.  The pass finds it in code *on the
loop path*, not by naive pattern matching: set-up before a loop, the
end-of-run decoding and host-side schedule builders are legitimate.

  loop roots      the host event loops: the ``while`` bodies of
                  ``core/sim.simulate_host`` and
                  ``core/lanes.simulate_lanes_host`` (``LOOP_ROOTS``; the
                  dispatchers ``simulate`` and ``simulate_lanes`` hold no
                  loop, and the ``tlm_loop`` kernel reads nothing back
                  until its run ends) and the lambdas those functions
                  define (``simulate_host``'s handler table); plus
                  everything they call, propagated to a fixpoint across
                  the analysed file set, import-alias aware (``EQ._tree_commit_`` in sim.py
                  and ``from repro_torch.core.sim import _detect`` in
                  lanes.py both reach eventq.py / sim.py), and the nested
                  ``def``s of a function on the path.

  host-sync       ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
                  ``torch.cuda.synchronize()``, and ``float()`` /
                  ``int()`` / ``bool()`` on a tensor-derived local: each
                  waits for the card.
  tensor-branch   ``if`` / ``while`` whose test mentions a tensor-derived
                  local (``bool()`` of a tensor: a sync).
  host-call       ``time.*`` clocks, ``random.*`` and ``np.random.*`` on
                  the loop path (nondeterministic or sync-forcing).
  static-unhashable  frozen-dataclass fields with unhashable annotations
                  (list/dict/set/ndarray) or mutable default factories:
                  the shapes and policies are dictionary keys.

A tensor-derived local is a name assigned (transitively) from a
``torch.*`` call, from the state dict (``st[...]``) or from another such
name; a value a host sync returns (``.tolist()``, ``int(...)``) is a host
value.  Allowlist pragmas: ``# lint: allow(rule)`` at the end of the
flagged line silences that rule there (the loops' one packed read an
event, ``sim.py``, and a step, ``lanes.py``); ``# lint: host-module`` in
the first 20 lines exempts a host-side module from the loop-path rules.

**Gate purity** (``gate_purity_report``): the "exact no-op when off"
claims of faults and the trace, checked on what a run dispatches: the
OFF programs' final state holds no gated key, no op of an OFF program
makes a tensor of the trace buffers' prime shapes (the spec is built
with prime dims, so no other tensor can match), and the OFF program
dispatches strictly fewer aten ops than the ON programs.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass

PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([\w,\- ]+)\)")
HOST_MODULE_PRAGMA = re.compile(r"#\s*lint:\s*host-module")

# the event loops: module -> functions whose ``while`` bodies (and
# lambdas) are the roots of the loop path
LOOP_ROOTS = {"repro_torch.core.sim": ("simulate_host",),
              "repro_torch.core.lanes": ("simulate_lanes_host",)}

HOST_TIME_FNS = {"time", "perf_counter", "monotonic", "sleep",
                 "process_time", "thread_time", "time_ns",
                 "perf_counter_ns", "monotonic_ns"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# calls whose result lives on the host
HOST_RESULT_CALLS = {"int", "float", "bool", "len", "str", "range", "max",
                     "min", "any", "all", "sum", "tuple", "list", "set",
                     "sorted", "isinstance"}
# a tensor's host-side metadata: reading it waits for nothing
META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout"}
META_METHODS = {"dim", "numel", "size", "stride", "element_size",
                "data_ptr", "is_contiguous"}
UNHASHABLE_ANNOTATIONS = {"list", "dict", "set", "bytearray", "ndarray",
                          "List", "Dict", "Set"}


@dataclass
class Finding:
    rule: str
    file: str
    line: int
    detail: str

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "detail": self.detail}


def _dotted(node) -> str:
    """'a.b.c' for Attribute/Name chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _Module:
    def __init__(self, path: str, tree: ast.Module, src: str):
        self.path = path
        self.tree = tree
        self.lines = src.splitlines()
        self.host_module = any(HOST_MODULE_PRAGMA.search(ln)
                               for ln in self.lines[:20])
        self.aliases: dict[str, str] = {}     # local name -> dotted target
        self.functions: dict[str, ast.AST] = {}   # qualname -> def node
        self.parent: dict[str, str] = {}      # nested qualname -> parent
        self._index()

    def _index(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qn = f"{prefix}{child.name}"
                    self.functions[qn] = child
                    if prefix:
                        self.parent[qn] = prefix[:-1]
                    visit(child, f"{qn}.")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)
        visit(self.tree, "")

    def allowed(self, lineno: int, rule: str) -> bool:
        if 1 <= lineno <= len(self.lines):
            m = PRAGMA_RE.search(self.lines[lineno - 1])
            if m:
                allowed = {r.strip() for r in m.group(1).split(",")}
                return rule in allowed or "all" in allowed
        return False

    def target(self, dotted: str) -> str:
        """``dotted`` with its first name resolved through the imports."""
        root, _, rest = dotted.partition(".")
        t = self.aliases.get(root, root)
        return f"{t}.{rest}" if rest else t


def _module_name(path: str) -> str:
    """src/repro_torch/core/sim.py -> repro_torch.core.sim"""
    p = path.replace("\\", "/")
    if "/src/" in p:
        p = p.split("/src/", 1)[1]
    elif p.startswith("src/"):
        p = p[4:]
    return p.removesuffix(".py").replace("/", ".")


def _root_regions(node) -> list:
    """The loop path inside a root function: its ``while`` statements
    (outermost) and its lambdas."""
    out = []

    def visit(n):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.While, ast.Lambda)):
                out.append(child)
            elif not isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                visit(child)
    visit(node)
    return out


def _call_edges(mod: _Module, nodes) -> set:
    """-> {(module name or None, function name)} called from ``nodes``;
    None means local to ``mod``."""
    edges = set()
    for node in nodes:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = _dotted(sub.func)
            if not fn:
                continue
            target = mod.target(fn)
            if target.startswith("repro_torch."):
                tmod, _, name = target.rpartition(".")
                edges.add((tmod, name))
            elif "." not in fn:
                edges.add((None, fn))
    return edges


def _loop_closure(mods: dict, roots_by_module: dict) -> tuple:
    """Fixpoint of the loop path across the file set.  -> (regions,
    reached): ``regions`` {(module, qualname): [root region nodes]} for
    the roots, ``reached`` {module: set of qualnames linted whole}."""
    regions, reached = {}, {name: set() for name in mods}
    work = []
    for name, roots in roots_by_module.items():
        if name not in mods:
            continue
        m = mods[name]
        for qn in roots:
            if qn in m.functions:
                regs = _root_regions(m.functions[qn])
                regions[(name, qn)] = regs
                work.append((name, regs))

    def add(tmod, fname):
        m = mods[tmod]
        for cand in m.functions:
            if cand.rsplit(".", 1)[-1] == fname \
                    and cand not in reached[tmod] \
                    and (tmod, cand) not in regions:
                reached[tmod].add(cand)
                work.append((tmod, [m.functions[cand]]))

    while work:
        name, nodes = work.pop()
        m = mods[name]
        for tmod, fname in _call_edges(m, nodes):
            if tmod is None:
                add(name, fname)
            elif tmod in mods:
                add(tmod, fname)
        # nested defs of a function on the path are on it
        for qn, par in m.parent.items():
            if par in reached[name] and qn not in reached[name]:
                reached[name].add(qn)
                work.append((name, [m.functions[qn]]))
    return regions, reached


def _torch_rooted(mod: _Module, dotted: str) -> bool:
    return mod.target(dotted).split(".")[0] == "torch"


def _derived_locals(mod: _Module, fn_node) -> set:
    """Names assigned (transitively) from torch expressions, the state
    dict or other such names inside this function: the values that are
    tensors at run time."""
    derived: set = set()

    def host_result(expr) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        if isinstance(expr.func, ast.Attribute):
            return expr.func.attr in SYNC_METHODS
        return isinstance(expr.func, ast.Name) \
            and expr.func.id in HOST_RESULT_CALLS

    def expr_derived(expr) -> bool:
        if host_result(expr) or _host_only(expr) or isinstance(
                expr, (ast.ListComp, ast.SetComp, ast.DictComp, ast.List,
                       ast.Dict, ast.Set)):
            return False
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func)
            if d and _torch_rooted(mod, d):
                return True
        elif isinstance(expr, ast.Name):
            return expr.id in derived
        elif isinstance(expr, ast.Subscript) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "st":
            return True
        return any(expr_derived(c) for c in ast.iter_child_nodes(expr)
                   if isinstance(c, ast.expr))

    def pairs(target, value):
        """(name, value expression) of each name an assignment binds:
        tuples unpacked element by element where both sides are tuples;
        attribute and item targets bind no local."""
        if isinstance(target, ast.Name):
            yield target.id, value
        elif isinstance(target, ast.Starred):
            yield from pairs(target.value, value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    yield from pairs(t, v)
            else:
                for t in target.elts:
                    yield from pairs(t, value)

    changed = True
    while changed:
        changed = False
        for sub in ast.walk(fn_node):
            if isinstance(sub, ast.Assign):
                targets, value = sub.targets, sub.value
            elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)) \
                    and sub.value is not None:
                targets, value = [sub.target], sub.value
            elif isinstance(sub, (ast.For, ast.comprehension)):
                targets, value = [sub.target], sub.iter
            else:
                continue
            for t in targets:
                for name, v in pairs(t, value):
                    if name not in derived and expr_derived(v):
                        derived.add(name)
                        changed = True
    return derived


def _host_only(node) -> bool:
    """A sub-expression that reads no tensor's values: an identity test
    (``x is None``), a tensor's metadata (``x.shape``, ``x.dim()``), a
    length or a type test."""
    if isinstance(node, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
    if isinstance(node, ast.Attribute):
        return node.attr in META_ATTRS
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute):
            return node.func.attr in META_METHODS
        return isinstance(node.func, ast.Name) \
            and node.func.id in ("len", "isinstance", "type")
    return False


def _mentions(expr, names: set) -> str | None:
    """The first tensor-derived name whose values ``expr`` reads."""
    if _host_only(expr):
        return None
    if isinstance(expr, ast.Name):
        return expr.id if expr.id in names else None
    for child in ast.iter_child_nodes(expr):
        hit = _mentions(child, names)
        if hit:
            return hit
    return None


def _lint_nodes(mod: _Module, qualname: str, fn_node, nodes,
                findings: list):
    derived = _derived_locals(mod, fn_node)

    def emit(rule, lineno, detail):
        if not mod.allowed(lineno, rule):
            findings.append(Finding(rule, mod.path, lineno,
                                    f"{qualname}: {detail}"))

    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn = _dotted(sub.func)
                target = mod.target(fn) if fn else ""
                leaf = fn.rsplit(".", 1)[-1] if fn else ""
                root = target.split(".")[0]
                if isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in SYNC_METHODS \
                        and root not in ("np", "numpy"):
                    emit("host-sync", sub.lineno,
                         f"`.{sub.func.attr}()` waits for the card")
                elif target == "torch.cuda.synchronize":
                    emit("host-sync", sub.lineno,
                         "`torch.cuda.synchronize()` on the loop path")
                elif root == "time" and leaf in HOST_TIME_FNS:
                    emit("host-call", sub.lineno,
                         f"host clock `{fn}()` on the loop path")
                elif root == "random":
                    emit("host-call", sub.lineno,
                         f"host RNG `{fn}()` on the loop path")
                elif root == "numpy" and ".random." in f".{target}.":
                    emit("host-call", sub.lineno,
                         f"host RNG `{fn}()` on the loop path")
                elif fn in ("bool", "int", "float") and sub.args:
                    arg = _mentions(sub.args[0], derived)
                    if arg:
                        emit("host-sync", sub.lineno,
                             f"`{fn}()` on tensor `{arg}` waits for the "
                             "card")
            elif isinstance(sub, (ast.If, ast.While)):
                arg = _mentions(sub.test, derived)
                if arg:
                    kind = "if" if isinstance(sub, ast.If) else "while"
                    emit("tensor-branch", sub.lineno,
                         f"Python `{kind}` on tensor `{arg}` (a host sync; "
                         "use torch.where or a host mirror)")


def _lint_dataclasses(mod: _Module, findings: list):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        frozen = False
        for dec in node.decorator_list:
            d = _dotted(dec if not isinstance(dec, ast.Call) else dec.func)
            if d.rsplit(".", 1)[-1] == "dataclass" \
                    and isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "frozen" \
                            and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is True:
                        frozen = True
        if not frozen:
            continue
        for stmt in node.body:
            if not isinstance(stmt, ast.AnnAssign) \
                    or not isinstance(stmt.target, ast.Name):
                continue
            ann = ast.unparse(stmt.annotation)
            ann_leaf = ann.split("[")[0].rsplit(".", 1)[-1]
            bad = ann_leaf in UNHASHABLE_ANNOTATIONS
            if stmt.value is not None:
                for subv in ast.walk(stmt.value):
                    if isinstance(subv, ast.keyword) \
                            and subv.arg == "default_factory" \
                            and _dotted(subv.value) in ("list", "dict",
                                                        "set"):
                        bad = True
                    if isinstance(subv, (ast.List, ast.Dict, ast.Set)):
                        bad = True
            if bad and not mod.allowed(stmt.lineno, "static-unhashable"):
                findings.append(Finding(
                    "static-unhashable", mod.path, stmt.lineno,
                    f"frozen dataclass {node.name}.{stmt.target.id}: "
                    f"`{ann}` is unhashable (the shapes and policies are "
                    "dictionary keys)"))


def _parse(paths: list) -> dict:
    mods: dict[str, _Module] = {}
    for path in paths:
        with open(path) as f:
            src = f.read()
        mods[_module_name(path)] = _Module(path, ast.parse(src), src)
    return mods


def loop_path(paths: list, roots: dict = LOOP_ROOTS) -> dict:
    """{file path: sorted line numbers on the loop path}: the root
    regions' lines and the whole bodies of the functions they reach
    (host-module files included)."""
    mods = _parse(paths)
    regions, reached = _loop_closure(mods, roots)
    out: dict = {m.path: set() for m in mods.values()}

    def lines(node):
        return range(node.lineno, (node.end_lineno or node.lineno) + 1)
    for (name, _), regs in regions.items():
        for r in regs:
            out[mods[name].path].update(lines(r))
    for name, qns in reached.items():
        for qn in qns:
            out[mods[name].path].update(lines(mods[name].functions[qn]))
    return {p: sorted(v) for p, v in out.items()}


def lint_paths(paths: list, roots: dict = LOOP_ROOTS) -> list:
    """Lint a set of .py files; returns [Finding].  ``roots`` {module
    name: function names} are the loops (default: the port's two event
    loops)."""
    mods = _parse(paths)
    regions, reached = _loop_closure(mods, roots)
    findings: list[Finding] = []
    for name, mod in mods.items():
        _lint_dataclasses(mod, findings)
        if mod.host_module:
            continue
        for (rname, qn), regs in regions.items():
            if rname == name:
                _lint_nodes(mod, qn, mod.functions[qn], regs, findings)
        for qn in sorted(reached[name]):
            _lint_nodes(mod, qn, mod.functions[qn], [mod.functions[qn]],
                        findings)
    findings.sort(key=lambda f: (f.file, f.line))
    return findings


# --------------------------------------------------------------------------
# Gate purity: "exact no-op when off", on what a run dispatches.
# --------------------------------------------------------------------------

GATED_FAULT_KEYS = frozenset({
    "link_up", "gmn_alive", "link_down_t", "gmn_down_t", "msgs_lost",
    "reroutes", "downtime", "suspect", "susp_onsets", "susp_clears",
    "susp_false_pos", "det_floor", "retries_tx"})
GATED_TRACE_KEYS = frozenset({
    "th_mgmt", "th_resp", "tr_ring", "tr_n", "trace_dropped",
    "tl_t", "tl_busy", "tl_stale", "tl_load", "tl_qdepth", "tl_n"})

# prime-dimension spec: no other simulator tensor has these shapes, so
# one op making such a tensor in an OFF program is conclusive
_PRIME_TRACE = dict(ring_cap=89, sample_every=7, n_samples=31,
                    hist_bins=23, bins_per_octave=3)


def _op_counter():
    """A dispatch mode counting aten ops and the shapes they make."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n_ops = 0
            self.shapes: set = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.n_ops += 1
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.shapes.add(tuple(t.shape))
            return out

    return OpCount()


def gate_purity_report(m: int = 8, k: int = 2, device="cpu") -> dict:
    """Run the simulator at a small shape in four gate configurations
    (all off, trace on, faults on (with the trace), faults on with the
    trace off) and prove the OFF programs free of gated state."""
    import torch

    from repro_torch.core import faults as FLT
    from repro_torch.core import sim as S
    from repro_torch.core import workloads as W
    from repro_torch.core.trace import TraceSpec

    p = S.SimParams(m=m, k=k, n_childs=4, max_apps=8, queue_cap=64,
                    queue_impl="tree", batch_pop=4, topology="hier_tree")
    arr, gmn, lens = W.interference(p, sim_len=1e4, pair_period=3000.0,
                                    seed=0)[:3]
    args = (torch.as_tensor(arr, dtype=torch.float32).to(device),
            torch.as_tensor(gmn, dtype=torch.int32).to(device),
            torch.as_tensor(lens, dtype=torch.float32).to(device), 1e4)
    spec = TraceSpec(**_PRIME_TRACE)
    fault_sched = FLT.as_schedule(
        FLT.FaultSpec.poisson_links(rate=1e-4, seed=3), p.k, 1e4)

    def program(faults, trace):
        with _op_counter() as mode:
            st = S.simulate(p.shape, p.knobs.to(device), *args, p.policy,
                            p.topo, faults, trace)
        return set(st), mode

    checks = []

    def check(name, ok, detail):
        checks.append({"check": name, "ok": bool(ok), "detail": detail})

    off_keys, off = program(None, None)
    trace_keys, tr = program(None, spec)
    fault_keys, fa = program(fault_sched, None)
    both_keys, both = program(fault_sched, spec)

    leak_f = sorted(off_keys & GATED_FAULT_KEYS)
    leak_t = sorted((off_keys | fault_keys) & GATED_TRACE_KEYS)
    check("fault-off-keys", not leak_f,
          f"fault-off state leaks keys {leak_f}" if leak_f else
          "fault-off state carries no fault/detector state")
    check("trace-off-keys", not leak_t,
          f"trace-off state leaks keys {leak_t}" if leak_t else
          "trace-off states carry no trace state")
    check("fault-on-keys", GATED_FAULT_KEYS <= fault_keys
          and GATED_FAULT_KEYS <= both_keys,
          "fault-on programs carry the full detector state (positive "
          "control)")
    check("trace-on-keys", GATED_TRACE_KEYS <= trace_keys
          and GATED_TRACE_KEYS <= both_keys,
          "trace-on programs carry the full trace state (positive "
          "control)")

    prime_shapes = {(_PRIME_TRACE["ring_cap"], 6),
                    (_PRIME_TRACE["hist_bins"],),
                    (_PRIME_TRACE["n_samples"],),
                    (_PRIME_TRACE["n_samples"], k)}
    for label, mode in (("trace-off", off), ("fault-on-trace-off", fa)):
        hits = sorted(mode.shapes & prime_shapes)
        check(f"{label}-jaxpr-avals", not hits,
              (f"{label} program makes trace-buffer-shaped tensors {hits}"
               if hits else
               f"{label} program makes zero trace-buffer-shaped tensors"))
    # the positive control of the shape check: the trace-on programs
    # make every prime shape
    if not (prime_shapes <= tr.shapes and prime_shapes <= both.shapes):
        check("trace-on-keys", False,
              "a trace-on program makes no tensor of some trace-buffer "
              "shape: the prime-shape check sees nothing")

    # ops dispatched over one run of the same workload and horizon
    # (the reference counts jaxpr equations): each gate turned on adds
    # ops; faults on here means the trace on too
    n_off, n_trace, n_fault = off.n_ops, tr.n_ops, both.n_ops
    check("off-strictly-smaller",
          n_off < n_trace < n_fault and n_off < fa.n_ops,
          f"all-off program dispatches {n_off} ops vs {n_trace} trace-on "
          f"/ {n_fault} fault-on / {fa.n_ops} fault-on-trace-off (gates "
          "remove ops, not just zero them)")

    findings = [{"check": c["check"], "detail": c["detail"]}
                for c in checks if not c["ok"]]
    return {"checks": checks, "findings": findings,
            "eqns": {"off": n_off, "trace_on": n_trace,
                     "fault_on": n_fault, "fault_on_trace_off": fa.n_ops}}
