"""AST lint pass (pass 3 of ``repro_torch.analysis``): determinism hygiene
rules over the port's tree that hold by *convention* rather than by
running anything. The JAX package's four rules (``repro.analysis.lint``),
re-targeted at ``repro_torch`` and at PyTorch's idioms, with its codes:

``fold-python-coercion``
    No Python ``int()``/``float()``/``bool()``, and no ``.item()`` /
    ``.tolist()`` / ``.numpy()``, on values derived from a fold hook's
    arguments inside a ``Survey`` subclass's ``update``/``merge``/
    ``merge_epochs``: each one is a host sync in the fold's hot path,
    bakes a device value into host control flow, and fails the JAX
    package's trace of the same fold.

``float-scatter-accumulator``
    Inside a ``core`` directory, every scatter-add must be provably
    integer (counter64 limbs, CountingSet counts): ``index_add(_)``,
    ``scatter_add(_)``, ``scatter_reduce(_)`` with ``"sum"``/``"mean"``,
    ``index_put(_)(..., accumulate=True)`` and ``bincount(weights=...)``
    on a tensor. A float scatter-add folds colliding indices in an order
    the device picks and breaks every bitwise-identity contract. The
    evidence is read from the added operand (the weights of ``bincount``),
    as the JAX package reads it, and from the accumulator (the call's
    receiver) where the operand shows none. Host numpy planning is out of scope, as the JAX
    package's rule (which matches only ``.at[].add``) leaves it:
    ``np.bincount(..., weights=...)`` sums int64 wedge counts in float64
    (``core/pushpull.py`` and ``core/dodgr.py``), exact below 2⁵³.

``provenance-direct-compare``
    Provenance stamps (``sample_p``/``sample_seed``/``orient``/``epoch``/
    ``is_delta``/``hub_theta``/``delta``) of two different objects are
    only compared inside ``engine._check_provenance`` /
    ``_check_sampling`` — the helpers that report *every* diverged field
    with both values. Ad-hoc stamp comparisons scattered elsewhere rot as
    stamps are added.

``kernel-missing-oracle``
    Every ``kernels/<name>/`` directory whose ``ops.py`` binds a CUDA
    entry point (``_cuda.function(``) ships a ``ref.py`` host oracle and
    a ``*_plain`` PyTorch version, so the kernel has something to be held
    against on the card and on the CPU; and every ``csrc/*.cu`` source is
    bound by some ``ops.py`` (a source no wrapper reaches is built and
    never checked).

Everything is :mod:`ast` on source text — no imports of the linted
modules, no device, no tracing. The dtype-evidence heuristic resolves
simple local ``name = ...`` assignments (depth-limited), which is exactly
enough for the idioms this repo uses; when it cannot *prove* an integer
accumulator it says so rather than staying silent.
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.report import Violation

FOLD_HOT = ("update", "merge", "merge_epochs")
COERCIONS = ("int", "float", "bool")
HOST_METHODS = ("item", "tolist", "numpy")
STAMPS = {"sample_p", "sample_seed", "orient", "epoch", "is_delta",
          "hub_theta", "delta"}
STAMP_HELPERS = {"_check_provenance", "_check_sampling"}
INT_TOKENS = {"int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64", "bool_", "int", "bool", "long", "short"}
FLOAT_TOKENS = {"float16", "float32", "float64", "bfloat16", "float",
                "double", "half"}
SCATTER_ADDS = {"index_add", "index_add_", "scatter_add", "scatter_add_"}
HOST_MODULES = {"np", "numpy"}


def _names(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _base_name(b) -> str:
    if isinstance(b, ast.Name):
        return b.id
    if isinstance(b, ast.Attribute):
        return b.attr
    return ""


def _arg(call: ast.Call, i: int, name: str):
    """Argument ``i`` of ``call``, or its keyword ``name``; None if absent."""
    if len(call.args) > i:
        return call.args[i]
    return next((k.value for k in call.keywords if k.arg == name), None)


# ---------------------------------------------------------------------------
# rule 1: Python coercion of fold values in fold hot paths


def _coercion(node, tainted: set[str]) -> str | None:
    """The coercion ``node`` applies to a tainted value, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if (isinstance(f, ast.Name) and f.id in COERCIONS and node.args
            and _names(node.args[0]) & tainted):
        return f"{f.id}()"
    if (isinstance(f, ast.Attribute) and f.attr in HOST_METHODS
            and _names(f.value) & tainted):
        return f".{f.attr}()"
    return None


def _rule_fold_coercion(tree, filename: str, out: list[Violation]) -> None:
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if not any("Survey" in _base_name(b) for b in cls.bases):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef) or fn.name not in FOLD_HOT:
                continue
            # taint: the fold arguments and everything assigned from them
            tainted = {a.arg for a in fn.args.args[1:]}  # drop self
            for _ in range(8):  # propagate to fixpoint (assignments chain)
                grew = False
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign) \
                            and _names(node.value) & tainted:
                        for t in node.targets:
                            new = _names(t) - tainted
                            if new:
                                tainted |= new
                                grew = True
                if not grew:
                    break
            for node in ast.walk(fn):
                how = _coercion(node, tainted)
                if how:
                    out.append(Violation(
                        "lint", "fold-python-coercion",
                        f"{filename}:{node.lineno}",
                        f"{cls.name}.{fn.name} calls {how} on a value "
                        "derived from the fold arguments — a host sync in "
                        "the fold's hot path that bakes a device value into "
                        "host control flow (and fails the JAX package's "
                        "trace of the same fold). Use tensor ops and casts "
                        "(.to(dtype), torch.where) on the value instead"))


# ---------------------------------------------------------------------------
# rule 2: float scatter-add accumulators in core


def _dtype_evidence(node, assigns: dict, depth: int = 3,
                    seen: frozenset = frozenset()) -> set[str]:
    """{'int'} / {'float'} / both / empty — dtype tokens reachable from
    ``node``, resolving simple local name assignments up to ``depth``."""
    ev: set[str] = set()
    if node is None:
        return ev
    for n in ast.walk(node):
        tok = None
        if isinstance(n, ast.Attribute):
            tok = n.attr
        elif isinstance(n, ast.Name):
            tok = n.id
            if depth > 0 and tok in assigns and tok not in seen \
                    and tok not in INT_TOKENS and tok not in FLOAT_TOKENS:
                ev |= _dtype_evidence(assigns[tok], assigns, depth - 1,
                                      seen | {tok})
        if tok in INT_TOKENS:
            ev.add("int")
        elif tok in FLOAT_TOKENS:
            ev.add("float")
    return ev


def _scatter_add(node) -> tuple[str, object, object] | None:
    """(the method, the accumulator, the added operand) when ``node`` is a
    tensor scatter-add, else None. ``torch.f(x, ...)`` and ``x.f(...)``
    alike; calls on ``np`` / ``numpy`` are host planning and out of scope."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return None
    f, recv = node.func.attr, node.func.value
    if isinstance(recv, ast.Name) and recv.id in HOST_MODULES:
        return None
    functional = isinstance(recv, ast.Name) and recv.id == "torch"
    shift = 1 if functional else 0                # torch.f(self, ...)
    acc = _arg(node, 0, "input") if functional else recv
    name = f.removesuffix("_")
    if f in SCATTER_ADDS:
        return f, acc, _arg(node, 2 + shift,
                            "source" if "index" in f else "src")
    if name == "scatter_reduce":
        how = _arg(node, 3 + shift, "reduce")
        if isinstance(how, ast.Constant) and how.value not in ("sum", "mean"):
            return None
        return f, acc, _arg(node, 2 + shift, "src")
    if name == "index_put":
        flag = _arg(node, 2 + shift, "accumulate")
        if not (isinstance(flag, ast.Constant) and flag.value is True):
            return None
        return f, acc, _arg(node, 1 + shift, "values")
    if f == "bincount":
        weights = (_arg(node, 1, "weights") if functional
                   else _arg(node, 0, "weights"))
        if weights is None:
            return None
        return f, None, weights
    return None


def _rule_float_scatter(tree, filename: str, out: list[Violation]) -> None:
    assigns = {t.id: node.value
               for node in ast.walk(tree) if isinstance(node, ast.Assign)
               for t in node.targets if isinstance(t, ast.Name)}
    for node in ast.walk(tree):
        hit = _scatter_add(node)
        if hit is None:
            continue
        f, acc, operand = hit
        # the added operand's evidence, as the JAX package reads it; the
        # accumulator's where the operand shows none
        ev = (_dtype_evidence(operand, assigns)
              or _dtype_evidence(acc, assigns))
        if "float" in ev:
            out.append(Violation(
                "lint", "float-scatter-accumulator",
                f"{filename}:{node.lineno}",
                f".{f}() with a float operand — colliding indices fold in "
                "an order the device picks, so the result is not bitwise "
                "across transports/epochs. Accumulate into integer limbs "
                "(counter64, CountingSet) and convert at finalize"))
        elif "int" not in ev:
            out.append(Violation(
                "lint", "float-scatter-accumulator",
                f"{filename}:{node.lineno}",
                f"cannot statically prove this .{f}() accumulator is "
                "integer — make the dtype visible at the call site (e.g. "
                "dtype=torch.int32 where the accumulator is made, or "
                ".to(torch.int32) on the operand) so the order-insensitivity "
                "of the scatter is auditable"))


# ---------------------------------------------------------------------------
# rule 3: provenance stamps compared outside the helper


def _stamp_bases(side) -> set[str]:
    return {a.value.id for a in ast.walk(side)
            if isinstance(a, ast.Attribute) and a.attr in STAMPS
            and isinstance(a.value, ast.Name)}


def _rule_stamp_compare(tree, filename: str, out: list[Violation]) -> None:
    def visit(node, fstack):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fstack = fstack + [node.name]
        if isinstance(node, ast.Compare) and not (set(fstack)
                                                  & STAMP_HELPERS):
            per_side = [_stamp_bases(s)
                        for s in [node.left, *node.comparators]]
            bases = set().union(*per_side)
            if sum(bool(s) for s in per_side) >= 2 and len(bases) >= 2:
                out.append(Violation(
                    "lint", "provenance-direct-compare",
                    f"{filename}:{node.lineno}",
                    f"compares provenance stamps of {sorted(bases)} "
                    "directly — stamps are cross-checked only via "
                    "engine._check_provenance/_check_sampling, which "
                    "report every diverged field with both values; ad-hoc "
                    "comparisons silently miss newly added stamps"))
        for child in ast.iter_child_nodes(node):
            visit(child, fstack)

    visit(tree, [])


# ---------------------------------------------------------------------------
# rule 4: CUDA kernels ship an oracle and a plain version


def _bound_sources(text: str) -> set[str]:
    """The ``csrc`` libraries an ``ops.py`` binds: the first argument of
    each ``_cuda.function("<lib>", ...)`` call."""
    libs = set()
    for node in ast.walk(ast.parse(text)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "function"
                and _base_name(node.func.value) == "_cuda" and node.args
                and isinstance(node.args[0], ast.Constant)):
            libs.add(node.args[0].value)
    return libs


def check_kernel_oracles(kernels_dir: Path) -> list[Violation]:
    """Rule 4 over ``kernels_dir``; every source of ``csrc`` beside it
    must be bound by some ``ops.py``."""
    kernels_dir = Path(kernels_dir)
    csrc_dir = kernels_dir.parent / "csrc"
    out: list[Violation] = []
    bound: set[str] = set()
    for sub in sorted(p for p in kernels_dir.iterdir() if p.is_dir()):
        ops = sub / "ops.py"
        if not ops.exists():
            continue
        text = ops.read_text(encoding="utf-8")
        libs = _bound_sources(text)
        bound |= libs
        if not libs:
            continue
        if not (sub / "ref.py").exists():
            out.append(Violation(
                "lint", "kernel-missing-oracle", str(sub),
                "CUDA kernel directory has no ref.py oracle — every kernel "
                "needs a host reference sibling so its bitwise tests have "
                "something to diff against"))
        plain = [n for n in ast.walk(ast.parse(text))
                 if isinstance(n, ast.FunctionDef) and n.name.endswith("_plain")]
        if not plain:
            out.append(Violation(
                "lint", "kernel-missing-oracle", str(ops),
                "ops.py binds a CUDA kernel but defines no *_plain function "
                "— the wrapper needs its plain PyTorch version for CPU "
                "tensors and for the card's kernel == plain check"))
    if csrc_dir.is_dir():
        for cu in sorted(csrc_dir.glob("*.cu")):
            if cu.stem not in bound:
                out.append(Violation(
                    "lint", "kernel-missing-oracle", str(cu),
                    f"no kernels/*/ops.py binds {cu.name} "
                    f"(_cuda.function({cu.stem!r}, ...)) — a source no "
                    "wrapper reaches is built and never checked"))
    return out


# ---------------------------------------------------------------------------
# drivers


def lint_file(path: str | Path) -> list[Violation]:
    """Lint one source file. Rule scopes are inferred from the path:
    ``float-scatter-accumulator`` only applies under a ``core`` directory,
    and the ``analysis`` package is exempt from
    ``provenance-direct-compare`` (it *is* the verifier)."""
    path = Path(path)
    out: list[Violation] = []
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    except SyntaxError as e:
        out.append(Violation("lint", "unparseable", f"{path}:{e.lineno}",
                             f"file does not parse: {e.msg}"))
        return out
    name = str(path)
    _rule_fold_coercion(tree, name, out)
    if "core" in path.parts:
        _rule_float_scatter(tree, name, out)
    if "analysis" not in path.parts:
        _rule_stamp_compare(tree, name, out)
    return out


def lint_repo(root: str | Path | None = None) -> list[Violation]:
    """Lint every source file of the ``repro_torch`` package (or any tree
    rooted at ``root``), plus the kernel-oracle check."""
    if root is None:
        root = Path(__file__).resolve().parents[1]
    root = Path(root)
    out: list[Violation] = []
    for f in sorted(root.rglob("*.py")):
        if "__pycache__" in f.parts:
            continue
        out += lint_file(f)
    kernels = root / "kernels"
    if kernels.is_dir():
        out += check_kernel_oracles(kernels)
    return out
