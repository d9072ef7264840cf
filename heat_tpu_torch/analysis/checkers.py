"""Per-rule checkers of the file-scope linter, in the port's terms.

Port of ``heat_tpu/analysis/checkers.py``.  Each checker walks one
:class:`~heat_tpu_torch.analysis.core.FileContext` and yields findings.
Where the reference checks JAX constructs, the port checks its own:

* "traced" means captured (:meth:`FileContext.in_traced_context`): a
  function handed to or decorated with ``htt.fuse``, or the body of a
  ``with torch.cuda.graph(...)`` block.  Such code runs once, at capture;
  each replay repeats only the kernels it launched;
* the permutations SPMD101 evaluates are the ``(source, destination)``
  pairs of ``parallel.primitives._permute`` (the port's ``ppermute`` of
  stacked position blocks); ``comm.ring_permute`` takes a shift, a
  bijection by construction;
* a "compiled program" is a ``fuse`` product or an ``@fuse`` function (the
  op engine's ``jitted`` runs eagerly, so it counts as a dispatch site for
  SPMD211-214 but never re-captures per shape: SPMD208 leaves it out);
* dtypes are ``torch``'s (``.to(torch.int32)``, ``.long()``, ...).

Rule SPMD101 is *hybrid* static/dynamic: the perm builders are fixed
before any data moves, so the checker extracts the builder expression and
EVALUATES it for every position count 1..8, checking that each result is a
valid partial bijection.  The evaluation sandbox executes only
module-level ``def`` source from the analyzed file plus arithmetic
builtins: never imports, never torch.

SPMD102 (named-axis collectives against ``shard_map``), SPMD209 (the
``fori_loop``/``scan`` ring bodies) and SPMD301/302 (Pallas tiles and
grids) check constructs the port does not have, and are not ported.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .core import FileContext
from .rules import Finding, rule

__all__ = [
    "MESH_SIZES",
    "check_partial_bijection",
    "verify_ring_schedule",
    "verify_zigzag_builders",
]

#: every perm builder is evaluated for these position counts: 1
#: (degenerate), the powers of two and the awkward primes the tests sweep
MESH_SIZES = tuple(range(1, 9))

_SIZE_NAMES = {"size", "p", "n", "world_size", "num_devices", "mesh_size"}

_SAFE_BUILTINS = {
    k: getattr(builtins, k)
    for k in (
        "range", "len", "min", "max", "abs", "enumerate", "zip", "sum",
        "list", "tuple", "sorted", "reversed", "int", "divmod",
    )
}


# --------------------------------------------------------------------- #
# permutation ground truth (shared with the runtime property tests)      #
# --------------------------------------------------------------------- #
def check_partial_bijection(perm, size: int) -> Optional[str]:
    """Validate one permutation of ``(source, destination)`` pairs for
    ``size`` positions: pairs of ints in range, no duplicated source, no
    duplicated destination (partial perms are legal: absent destinations
    receive zeros).  Returns an error string or None."""
    try:
        pairs = [(int(s), int(d)) for s, d in perm]
    except (TypeError, ValueError):
        return f"not a sequence of (src, dst) pairs: {perm!r}"
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    bad = [x for x in srcs + dsts if not 0 <= x < size]
    if bad:
        return f"index {bad[0]} out of range for mesh size {size}"
    if len(set(srcs)) != len(srcs):
        dup = sorted(s for s in set(srcs) if srcs.count(s) > 1)
        return f"duplicate source(s) {dup} at mesh size {size}"
    if len(set(dsts)) != len(dsts):
        dup = sorted(d for d in set(dsts) if dsts.count(d) > 1)
        return f"duplicate destination(s) {dup} at mesh size {size} (collision: two shards write one slot)"
    return None


def verify_ring_schedule(ring_source, sizes: Sequence[int] = MESH_SIZES) -> Optional[str]:
    """Check ``ring_source(position, round, size)`` against the +1 ring
    rotation it documents: simulate ``[(i, (i+1) % size)]`` applied
    ``round`` times and compare origins."""
    for s in sizes:
        origins = list(range(s))
        for r in range(s):
            for pos in range(s):
                if ring_source(pos, r, s) != origins[pos]:
                    return (
                        f"ring_source({pos}, {r}, {s}) = {ring_source(pos, r, s)}"
                        f" but the +1 rotation delivers block {origins[pos]}"
                    )
            origins = [origins[(pos - 1) % s] for pos in range(s)]
    return None


def verify_zigzag_builders(
    zigzag_perms=None,
    zigzag_inverse_perms=None,
    zigzag_chunk_owner=None,
    sizes: Sequence[int] = MESH_SIZES,
) -> Optional[str]:
    """Full-bijection + round-trip checks for the zig-zag resplit
    schedules.  Each stream perm must be a TOTAL bijection (every position
    sends and receives exactly once), and forward-then-inverse must
    restore the contiguous chunk layout."""
    for s in sizes:
        streams = {}
        if zigzag_perms is not None:
            streams["zigzag_perms"] = zigzag_perms(s)
        if zigzag_inverse_perms is not None:
            streams["zigzag_inverse_perms"] = zigzag_inverse_perms(s)
        for name, perms in streams.items():
            for k, perm in enumerate(perms):
                err = check_partial_bijection(perm, s)
                if err is None and len({d for _, d in perm}) != s:
                    err = f"stream does not cover every device at size {s}"
                if err:
                    return f"{name}({s}) stream {k}: {err}"
        if zigzag_perms is not None and zigzag_chunk_owner is not None:
            fwd = zigzag_perms(s)
            for i in range(s):
                for k in (0, 1):
                    dst = dict(fwd[k])[i]
                    want = zigzag_chunk_owner(2 * i + k, s)
                    if dst != want:
                        return (
                            f"zigzag_perms({s}) sends chunk {2 * i + k} to "
                            f"{dst}, zigzag_chunk_owner says {want}"
                        )
        if zigzag_perms is not None and zigzag_inverse_perms is not None:
            # forward then inverse must restore the contiguous layout:
            # chunk c starts at position c // 2, comes home to c // 2
            fwd, inv = zigzag_perms(s), zigzag_inverse_perms(s)
            for c in range(2 * s):
                home = dict(fwd[c % 2])[c // 2]
                # at its zig-zag home the chunk is the low half iff c < s;
                # low halves ride the even-chunk stream of the inverse
                stream = inv[0] if (c < s) == (home % 2 == 0) else inv[1]
                back = dict(stream)[home]
                if back != c // 2:
                    return (
                        f"zig-zag round trip broken at size {s}: chunk {c} "
                        f"returns to device {back}, expected {c // 2}"
                    )
    return None


# --------------------------------------------------------------------- #
# sandboxed evaluation of perm expressions                               #
# --------------------------------------------------------------------- #
class _Unresolvable(Exception):
    pass


def _module_def_env(ctx: FileContext) -> Dict[str, object]:
    """Exec every module-level ``def`` from source into one shared env.
    Definition never runs the body, so torch-using helpers exec fine and
    only fail (NameError) if a perm expression actually calls them, which
    is caught and treated as unverifiable."""
    env: Dict[str, object] = {"__builtins__": _SAFE_BUILTINS}
    for st in ctx.tree.body:
        if isinstance(st, ast.FunctionDef):
            src = ast.get_source_segment(ctx.source, st)
            if src is None:
                continue
            try:
                exec(compile(ast.parse(src), f"<{ctx.relpath}>", "exec"), env)
            except Exception:
                continue
    return env


def _free_names(expr: ast.AST) -> List[str]:
    bound = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.comprehension):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    bound.add(t.id)
        elif isinstance(node, ast.Lambda):
            bound.update(a.arg for a in node.args.args)
    out = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id not in bound and node.id not in _SAFE_BUILTINS:
                out.append(node.id)
    return out


def _eval_expr(ctx: FileContext, expr: ast.AST, at: ast.AST, size: int,
               env: Dict[str, object], depth: int = 0):
    """Evaluate ``expr`` with position-count variables bound to ``size``.
    Free names resolve through (in order): the module-def env, nearest
    assignment (constants, ``*.size`` attributes, recursively evaluable
    expressions), parameter defaults, and the size-name convention."""
    if depth > 6:
        raise _Unresolvable("resolution too deep")
    local: Dict[str, object] = {}
    params = {}
    for fn in ctx.enclosing_functions(at):
        args = fn.args
        names = [a.arg for a in args.args + args.kwonlyargs]
        defaults = list(args.defaults)
        for name, default in zip(reversed(args.args), reversed(defaults)):
            params.setdefault(name.arg, default)
        for name in names:
            params.setdefault(name, None)
    for name in _free_names(expr):
        if name in env or name in local:
            continue
        rec = ctx.lookup(name, at)
        if rec is not None and rec[0] == "expr":
            val = rec[1]
            if isinstance(val, ast.Constant):
                local[name] = val.value
                continue
            if isinstance(val, ast.Attribute) and val.attr == "size":
                local[name] = size
                continue
            try:
                local[name] = _eval_expr(ctx, val, at, size, env, depth + 1)
                continue
            except _Unresolvable:
                pass
        if name in params:
            default = params[name]
            if name in _SIZE_NAMES:
                local[name] = size
                continue
            if isinstance(default, ast.Constant) and default.value is not None:
                local[name] = default.value
                continue
            raise _Unresolvable(f"parameter {name!r}")
        if name in _SIZE_NAMES:
            local[name] = size
            continue
        raise _Unresolvable(f"name {name!r}")
    code = compile(ast.Expression(body=_strip_locations(expr)), "<perm>", "eval")
    merged = dict(env)
    merged.update(local)
    try:
        return eval(code, merged)
    except _UnresolvableErrors as e:
        raise _Unresolvable(str(e))


_UnresolvableErrors = (NameError, AttributeError, TypeError, ValueError, IndexError, KeyError)


def _strip_locations(expr: ast.AST) -> ast.AST:
    import copy

    new = copy.deepcopy(expr)
    return ast.fix_missing_locations(
        ast.copy_location(new, ast.Expr(lineno=1, col_offset=0))
    )


#: builders whose results SPMD101 verifies whenever the analyzed file
#: defines them: the schedule metadata of the ring and of the zig-zag
#: causal ring (``parallel/primitives.py``)
_BUILDER_NAMES = ("zigzag_perms", "zigzag_inverse_perms", "zigzag_chunk_owner", "ring_source")



@rule("SPMD101", "_permute permutations must be statically-valid bijections", dynamic=True)
def check_ppermute_bijection(ctx: FileContext) -> Iterable[Finding]:
    """Every ``primitives._permute`` perm that is visible as a
    comprehension, a literal, or a call into a local builder is evaluated
    for position counts 1..8 and validated as a partial bijection
    (distinct sources, distinct destinations, indices in range).  Files
    defining the zig-zag / ring schedule builders additionally get their
    cycle structure verified against simulation."""
    env = None  # built lazily: most files have no permutation at all

    def get_env():
        nonlocal env
        if env is None:
            env = _module_def_env(ctx)
        return env

    for node in ast.walk(ctx.tree):
        # _permute(blocks, perm) moves stacked position blocks
        if not isinstance(node, ast.Call) or not ctx.resolves_to(node.func, "_permute"):
            continue
        perm_expr = None
        if len(node.args) >= 2:
            perm_expr = node.args[1]
        else:
            for kw in node.keywords:
                if kw.arg == "perm":
                    perm_expr = kw.value
        if perm_expr is None:
            continue
        expr, at = perm_expr, node
        if isinstance(expr, ast.Name):
            rec = ctx.lookup(expr.id, node)
            if rec is None:
                continue  # parameter or unknown: checked at its builder
            if rec[0] == "expr":
                expr = rec[1]
            else:  # tuple-unpack from a builder call
                call, i = rec[1], rec[2]
                expr = ast.Subscript(
                    value=call, slice=ast.Constant(value=i), ctx=ast.Load()
                )
        if isinstance(expr, ast.Name):
            continue  # parameter-fed perms are validated at the builder
        for size in MESH_SIZES:
            try:
                perm = _eval_expr(ctx, expr, at, size, get_env())
            except _Unresolvable:
                break  # not statically evaluable here: builder-site duty
            err = check_partial_bijection(perm, size)
            if err:
                yield ctx.finding(
                    "SPMD101", node,
                    f"_permute perm is not a valid permutation: {err}",
                    hint="every (src, dst) pair needs distinct sources and "
                    "distinct destinations in [0, positions); rebuild the "
                    "perm from the position count, not from data",
                )
                break

    # schedule builders defined here: verify cycle structure by simulation
    defs = {
        name: ctx.module_function(name)
        for name in _BUILDER_NAMES
        if ctx.module_function(name) is not None
    }
    if defs:
        env = get_env()
        have = {k: env.get(k) for k in defs if callable(env.get(k))}
        err = None
        if "ring_source" in have:
            err = verify_ring_schedule(have["ring_source"])
            anchor = defs["ring_source"]
        if err is None and ("zigzag_perms" in have or "zigzag_inverse_perms" in have):
            err = verify_zigzag_builders(
                zigzag_perms=have.get("zigzag_perms"),
                zigzag_inverse_perms=have.get("zigzag_inverse_perms"),
                zigzag_chunk_owner=have.get("zigzag_chunk_owner"),
            )
            anchor = defs.get("zigzag_perms") or defs.get("zigzag_inverse_perms")
        if err:
            yield ctx.finding(
                "SPMD101", anchor,
                f"schedule builder fails simulation: {err}",
                hint="the perm-builder contract is checked for position "
                "counts 1..8 against a direct simulation of the ring/zig-zag "
                "layout; see tests/test_torch_spmdlint.py for the ground truth",
            )


# --------------------------------------------------------------------- #
# SPMD201: capture purity                                                #
# --------------------------------------------------------------------- #
_BANNED_CALLS = {
    "time.time": "wall-clock reads bake one value into the captured graph",
    "time.perf_counter": "wall-clock reads bake one value into the captured graph",
    "time.monotonic": "wall-clock reads bake one value into the captured graph",
    "time.sleep": "host sleeps are invisible to the graph's replays",
    "print": "host print runs at CAPTURE time only (once)",
    "open": "file I/O at capture time runs once, not per call",
    "input": "blocking host I/O inside a captured function",
    "breakpoint": "debugger traps do not survive capture",
}
_BANNED_PREFIXES = {
    "numpy.random.": "numpy RNG is host state: drawn once at capture, frozen "
    "into every replay; draw on the card with an explicit torch.Generator",
    "random.": "stdlib RNG is host state: drawn once at capture, frozen into "
    "every replay; draw on the card with an explicit torch.Generator",
}


@rule("SPMD201", "no host effects inside fused or graph-captured functions")
def check_trace_purity(ctx: FileContext) -> Iterable[Finding]:
    """Functions handed to ``htt.fuse`` (and the bodies of ``with
    torch.cuda.graph(...)``) run ONCE, at capture: host effects inside
    them silently freeze (RNG, clocks) or vanish (print, I/O) in every
    replay, and ``global`` writes make the cached program depend on hidden
    state."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and ctx.in_traced_context(node):
            dotted = ctx.resolve(node.func)
            if dotted is None:
                continue
            if dotted in _BANNED_CALLS:
                yield ctx.finding(
                    "SPMD201", node,
                    f"host effect {dotted!r} inside a traced function",
                    hint=_BANNED_CALLS[dotted],
                )
                continue
            for prefix, why in _BANNED_PREFIXES.items():
                if dotted.startswith(prefix) and not dotted.startswith("torch."):
                    yield ctx.finding(
                        "SPMD201", node,
                        f"host RNG {dotted!r} inside a traced function",
                        hint=why,
                    )
                    break
        elif isinstance(node, ast.Global) and ctx.in_traced_context(node):
            yield ctx.finding(
                "SPMD201", node,
                f"global-variable write ({', '.join(node.names)}) inside a "
                "traced function",
                hint="captured functions must be pure: thread state through "
                "arguments and results, or move the mutation outside fuse",
            )


# --------------------------------------------------------------------- #
# SPMD202: host syncs of captured values                                 #
# --------------------------------------------------------------------- #
#: method calls that copy a device value to the host
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
#: numpy entry points that pull a device tensor back to host memory
_NP_MATERIALIZERS = {"asarray", "array", "ascontiguousarray", "asfortranarray"}
#: torch entry points that block the host on the card
_SYNC_CALLS = {"torch.cuda.synchronize"}
#: scalar coercions that force a device->host copy when fed a device value
_COERCIONS = {"float", "int", "bool", "complex"}
#: attribute leaves that are host metadata, not device values: coercing
#: these is free and legitimate (``int(x.shape[0])``)
_STATIC_ATTRS = {
    "shape", "gshape", "lshape", "ndim", "size", "split", "itemsize",
    "dtype", "balanced",
}
#: tensor methods whose results are host metadata (``int(x.size(0))``)
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size", "stride"}
#: tensor-method reductions whose results are device values
_REDUCTION_METHODS = {
    "sum", "max", "min", "mean", "prod", "norm", "argmax", "argmin",
    "all", "any", "std", "var", "dot", "astype", "amax", "amin",
}
#: ``torch`` calls that return host metadata, not a tensor
_TORCH_HOST_CALLS = {
    "torch.finfo", "torch.iinfo", "torch.device", "torch.Size",
    "torch.get_default_dtype", "torch.is_tensor", "torch.is_floating_point",
    "torch.is_complex", "torch.promote_types", "torch.result_type",
    "torch.can_cast",
}


def _is_static_expr(ctx: FileContext, expr: ast.AST, at: ast.AST, depth: int = 0) -> bool:
    """True when ``expr`` is visibly host metadata (shape/ndim
    arithmetic, constants, ``len()``, ``x.size(0)``): coercing it never
    touches the card."""
    if depth > 5:
        return False
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Attribute):
        return expr.attr in _STATIC_ATTRS
    if isinstance(expr, ast.Subscript):
        return _is_static_expr(ctx, expr.value, at, depth + 1)
    if isinstance(expr, ast.BinOp):
        return _is_static_expr(ctx, expr.left, at, depth + 1) and _is_static_expr(
            ctx, expr.right, at, depth + 1
        )
    if isinstance(expr, ast.UnaryOp):
        return _is_static_expr(ctx, expr.operand, at, depth + 1)
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Attribute) and expr.func.attr in _STATIC_METHODS:
            return True
        return isinstance(expr.func, ast.Name) and expr.func.id == "len"
    if isinstance(expr, ast.Name):
        rec = ctx.lookup(expr.id, at)
        if rec is not None and rec[0] == "expr":
            return _is_static_expr(ctx, rec[1], at, depth + 1)
    return False


def _is_device_value_expr(ctx: FileContext, expr: ast.AST) -> bool:
    """True when ``expr`` visibly produces a device value: a ``torch.*``
    call (less the host-metadata ones), a tensor-method reduction, or a
    ``.larray``/``._buffer`` access anywhere inside it."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            dotted = ctx.resolve(sub.func) or ""
            if dotted.startswith("torch.") and dotted not in _TORCH_HOST_CALLS:
                return True
            if isinstance(sub.func, ast.Attribute) and sub.func.attr in _REDUCTION_METHODS:
                return True
        elif isinstance(sub, ast.Attribute) and sub.attr in ("larray", "_buffer"):
            return True
    return False


def _names_host(ctx: FileContext, expr: ast.AST) -> bool:
    """True when ``expr`` names the host: ``"cpu"``, ``"cpu:0"`` or
    ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":")[0] == "cpu"
    if isinstance(expr, ast.Call) and ctx.resolves_to(expr.func, "torch.device") and expr.args:
        return _names_host(ctx, expr.args[0])
    return False


def _to_host(ctx: FileContext, call: ast.Call) -> bool:
    """True for ``t.to("cpu")`` / ``t.to(device="cpu")``: a host copy."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    targets = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(_names_host(ctx, t) for t in targets)


@rule("SPMD202", "no host syncs of captured values inside fused or graph-captured functions")
def check_host_sync(ctx: FileContext) -> Iterable[Finding]:
    """Inside functions captured by ``htt.fuse`` (or a ``with
    torch.cuda.graph(...)`` body), value-forcing operations
    (``.item()``/``.tolist()``/``.numpy()``/``.cpu()``/``.to("cpu")``,
    ``np.asarray``/``np.array``, ``torch.cuda.synchronize()``, and
    ``float()``/``int()``/``bool()``/``complex()`` of device values) read
    the card from the host: the capture refuses them ("operation not
    permitted when stream is capturing", or "Cannot copy between CPU and
    CUDA tensors during CUDA graph capture"), and the CPU's plain trace
    lets them through, so they ship unnoticed.  Coercions of host metadata
    (``int(x.shape[0])``, ``int(x.size(0))``) are exempt; a bare-name
    coercion is flagged only when its assignment visibly produced a device
    value, so python-int loop bookkeeping never trips it."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not ctx.in_traced_context(node):
            continue
        if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS:
            yield ctx.finding(
                "SPMD202", node,
                f"host-sync method .{node.func.attr}() inside a traced function",
                hint="the capture cannot read the card from the host: keep "
                "the computation on the card (torch.where) or move this "
                "step outside the fused function",
            )
            continue
        if _to_host(ctx, node):
            yield ctx.finding(
                "SPMD202", node,
                "host copy .to('cpu') inside a traced function",
                hint="the capture cannot copy to the host: return the "
                "tensor and copy it after the fused call",
            )
            continue
        dotted = ctx.resolve(node.func) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        if leaf in _NP_MATERIALIZERS and dotted.startswith("numpy."):
            yield ctx.finding(
                "SPMD202", node,
                f"numpy materialization {dotted!r} inside a traced function",
                hint="np.asarray of a device tensor forces a host copy, which "
                "the capture refuses; use torch equivalents so the value "
                "stays in the captured graph",
            )
            continue
        if dotted in _SYNC_CALLS:
            yield ctx.finding(
                "SPMD202", node,
                f"host sync {dotted!r} inside a traced function",
                hint="a capture cannot wait on the card; synchronize after "
                "the fused call",
            )
            continue
        if (
            isinstance(node.func, ast.Name)
            and node.func.id in _COERCIONS
            and node.func.id not in ctx.aliases  # shadowed by an import
            and len(node.args) == 1
        ):
            arg = node.args[0]
            if _is_static_expr(ctx, arg, node):
                continue
            flagged = _is_device_value_expr(ctx, arg)
            if not flagged and isinstance(arg, ast.Name):
                rec = ctx.lookup(arg.id, node)
                flagged = (
                    rec is not None
                    and rec[0] == "expr"
                    and _is_device_value_expr(ctx, rec[1])
                )
            if flagged:
                yield ctx.finding(
                    "SPMD202", node,
                    f"scalar coercion {node.func.id}() of a device value "
                    "inside a traced function",
                    hint="this reads the card from the host every eager call "
                    "and is refused by the capture; keep the decision on the "
                    "card with torch.where, or hoist the read out of the "
                    "fused function",
                )


# --------------------------------------------------------------------- #
# SPMD203: quantized collectives must carry inexact payloads             #
# --------------------------------------------------------------------- #
#: quantized-collective leaf name -> positional index of its payload
#: (``heat_tpu_torch/comm/compressed.py``)
_QUANTIZED_COLLECTIVES = {
    "ring_allreduce_q": 0, "ring_allreduce_q_ef": 0, "ring_allgather_q": 0,
    "allreduce_q": 0, "allgather_q": 0, "reduce_q": 0, "quantize_blocks": 0,
}
#: dtype leaves whose values must survive a collective bit-exactly
_EXACT_DTYPE_LEAVES = {
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "bool_", "bool", "integer", "signedinteger",
    "int", "long", "short",
}
#: tensor methods that cast to an exact dtype
_EXACT_CAST_METHODS = {
    "long": "int64", "int": "int32", "short": "int16", "char": "int8",
    "byte": "uint8", "bool": "bool",
}


def _exact_dtype_expr(ctx: FileContext, expr: ast.AST) -> Optional[str]:
    """The integer/bool dtype named by ``expr`` (``torch.int32``,
    ``"int64"``, ...), or None when it is not visibly exact."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value if expr.value in _EXACT_DTYPE_LEAVES else None
    dotted = ctx.resolve(expr) or ""
    leaf = dotted.rsplit(".", 1)[-1]
    return leaf if leaf in _EXACT_DTYPE_LEAVES else None


def _visibly_exact_payload(
    ctx: FileContext, expr: ast.AST, at: ast.AST, depth: int = 0
) -> Optional[str]:
    """The exact dtype ``expr`` visibly carries, or None.  Follows
    ``.to(...)``/``.astype(...)`` tails, the integer cast methods
    (``.long()``, ``.int()``, ``.bool()``, ...), ``dtype=`` keywords of
    constructors, and single-assignment name bindings (same lookup
    discipline as SPMD202's device-value tracking)."""
    if depth > 5:
        return None
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Attribute):
            attr = expr.func.attr
            if attr in _EXACT_CAST_METHODS and not expr.args and not expr.keywords:
                return _EXACT_CAST_METHODS[attr]
            if attr in ("astype", "to"):
                for arg in expr.args:
                    dt = _exact_dtype_expr(ctx, arg)
                    if dt is not None:
                        return dt
                for kw in expr.keywords:
                    if kw.arg == "dtype":
                        return _exact_dtype_expr(ctx, kw.value)
                return None
        for kw in expr.keywords:
            if kw.arg == "dtype":
                return _exact_dtype_expr(ctx, kw.value)
        return None
    if isinstance(expr, ast.Name):
        rec = ctx.lookup(expr.id, at)
        if rec is not None and rec[0] == "expr":
            return _visibly_exact_payload(ctx, rec[1], at, depth + 1)
    return None


@rule("SPMD203", "quantized collectives must not carry integer/exact-dtype payloads")
def check_quantized_payload_dtype(ctx: FileContext) -> Iterable[Finding]:
    """Block-scaled quantized collectives (``allreduce_q``, ``reduce_q``,
    ``quantize_blocks`` and the ring forms) round their payload to
    int8-with-scales: floats degrade gracefully, but integer/bool payloads
    (indices, counts, masks, labels) silently corrupt, because a count
    that comes back 79.6 instead of 80 is not "less precise", it is wrong.
    Flags any quantized collective whose payload expression visibly
    carries an exact dtype (``.to(torch.int32)``, ``.long()``, a
    ``dtype=torch.int64`` constructor, or a name bound to one).  Exact
    payloads belong on the exact collectives: the runtime twin of this
    rule is ``reduce_mode``'s TypeError on explicit compression of exact
    dtypes."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = ctx.resolve(node.func) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        if leaf not in _QUANTIZED_COLLECTIVES:
            continue
        if not ("compressed" in dotted or "comm" in dotted or dotted == leaf):
            continue
        idx = _QUANTIZED_COLLECTIVES[leaf]
        if len(node.args) <= idx:
            continue
        dt = _visibly_exact_payload(ctx, node.args[idx], node)
        if dt is not None:
            yield ctx.finding(
                "SPMD203", node,
                f"quantized collective {leaf!r} payload visibly has exact "
                f"dtype {dt!r}",
                hint="int8 block-scaling rounds the payload: integer/bool "
                "values (counts, indices, masks) corrupt silently.  Keep "
                "exact dtypes on the exact collectives (comm.allreduce), "
                "or cast to float only if approximate results are "
                "genuinely acceptable",
            )


# --------------------------------------------------------------------- #
# SPMD204: quantized collectives in guard-disabled regions               #
# --------------------------------------------------------------------- #
def _guard_off_call(ctx: FileContext, expr: ast.AST, leaf_name: str) -> bool:
    """True when ``expr`` is a ``guard("off")`` / ``set_guard_policy("off")``
    call (positionally or via ``policy=``) from the resilience layer (or a
    bare name, the fixture/test spelling)."""
    if not isinstance(expr, ast.Call):
        return False
    dotted = ctx.resolve(expr.func) or ""
    if dotted.rsplit(".", 1)[-1] != leaf_name:
        return False
    if not (
        dotted == leaf_name
        or "resilience" in dotted
        or "guards" in dotted
        or "heat_tpu" in dotted
    ):
        return False
    policy = expr.args[0] if expr.args else None
    if policy is None:
        for kw in expr.keywords:
            if kw.arg == "policy":
                policy = kw.value
    return isinstance(policy, ast.Constant) and policy.value == "off"


@rule("SPMD204", "quantized collectives in guard-disabled regions need an explicit suppression")
def check_guard_disabled_collectives(ctx: FileContext) -> Iterable[Finding]:
    """A quantized collective under ``guard("off")`` runs with its
    numerical health checks stripped: non-finite or saturated payloads
    pass through the int8 ring unchallenged, which is precisely the
    failure mode the guards exist to catch.  Flags any quantized
    collective call (``allreduce_q`` and friends, the SPMD203 set) that
    is lexically inside a ``with guard("off")`` block or follows a
    ``set_guard_policy("off")`` call in the same scope, unless the line
    carries ``# spmdlint: disable=SPMD204``: disabling guards around a
    compressed collective must be a visible, deliberate decision."""
    off_sets: List[Tuple[ast.AST, int]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _guard_off_call(ctx, node, "set_guard_policy"):
            encl = ctx.enclosing_functions(node)
            off_sets.append((encl[0] if encl else ctx.tree, node.lineno))

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = ctx.resolve(node.func) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        if leaf not in _QUANTIZED_COLLECTIVES:
            continue
        if not ("compressed" in dotted or "comm" in dotted or dotted == leaf):
            continue
        reason = None
        cur: Optional[ast.AST] = node
        while cur is not None:
            cur = ctx.parents.get(cur)
            if isinstance(cur, ast.With):
                for item in cur.items:
                    if _guard_off_call(ctx, item.context_expr, "guard"):
                        reason = 'a `with guard("off")` block'
                        break
            if reason:
                break
        if reason is None:
            encl = ctx.enclosing_functions(node)
            scope = encl[0] if encl else ctx.tree
            for s, ln in off_sets:
                if s is scope and ln < node.lineno:
                    reason = 'a set_guard_policy("off") call above it'
                    break
        if reason:
            yield ctx.finding(
                "SPMD204", node,
                f"quantized collective {leaf!r} runs inside {reason} "
                "with numerical health guards disabled",
                hint="compressed collectives silently propagate non-finite "
                "or saturated payloads when unguarded; re-enable guards "
                "(policy 'raise'/'warn'/'degrade'), or mark the call with "
                "`# spmdlint: disable=SPMD204` if running unguarded is a "
                "deliberate, reviewed decision",
            )


# --------------------------------------------------------------------- #
# SPMD205: host timing inside captured functions                         #
# --------------------------------------------------------------------- #
#: host clocks whose reading inside a captured body is a capture-time
#: constant, including the `_ns` variants SPMD201 does not list
_TIMING_CALLS = {
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
}
#: dotted-suffix forms of the telemetry span entry point (`from
#: heat_tpu_torch import telemetry` and the internal `from ..telemetry
#: import _core`)
_SPAN_SUFFIXES = ("telemetry.span", "telemetry._core.span")


@rule("SPMD205", "host-side timing inside captured functions measures capture time, not run time")
def check_trace_timing(ctx: FileContext) -> Iterable[Finding]:
    """A captured body runs ONCE, at capture: a ``time.*`` read or a
    ``telemetry.span`` opened inside it brackets the *capture* of the
    program (host Python around kernel launches that have not run yet),
    not the replays it stands for, and the measured value is frozen into
    the graph.  Deliberately overlaps SPMD201 on the wall-clock reads
    (either finding alone should stop the commit) and extends the set with
    the ``_ns``/``process_time`` variants and the telemetry span API,
    whose timing intent makes the capture/replay confusion easy to
    miss."""
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and ctx.in_traced_context(node)):
            continue
        dotted = ctx.resolve(node.func)
        if dotted is None:
            continue
        if dotted in _TIMING_CALLS:
            yield ctx.finding(
                "SPMD205", node,
                f"host clock {dotted!r} read inside a traced function",
                hint="the read happens once at capture and its value is "
                "baked into every replay; time the fused call at its HOST "
                "call site (after torch.cuda.synchronize), or with CUDA "
                "events / torch.profiler",
            )
        elif any(dotted == s or dotted.endswith("." + s) for s in _SPAN_SUFFIXES):
            yield ctx.finding(
                "SPMD205", node,
                "telemetry.span opened inside a traced function",
                hint="the span brackets the CAPTURE (one-time Python), not "
                "the replays; move the span to the host call site around "
                "the fused call, as fuse already does for its own "
                "fuse:build / fuse:replay spans",
            )


# --------------------------------------------------------------------- #
# SPMD206: monolithic resplit inside a loop body                         #
# --------------------------------------------------------------------- #
#: layout-change entry points whose repeated monolithic execution is the
#: worst-case pattern: each iteration pays a full relayout where one
#: hoisted resplit (or the planned rotation schedule) was expected
_RESPLIT_CALLS = {"resplit", "resplit_", "alltoall", "commit_split"}


def _planned_policy_call(ctx: FileContext, expr: ast.AST, leaf_name: str) -> bool:
    """True when ``expr`` is a ``redistribution("planned"|"auto")`` /
    ``set_redistribution("planned"|"auto")`` call (positionally or via
    ``policy=``) from the comm layer (or a bare name, the fixture/test
    spelling): the exemption, under the planner a loop-body resplit runs
    one bounded schedule instead of the monolithic worst case."""
    if not isinstance(expr, ast.Call):
        return False
    dotted = ctx.resolve(expr.func) or ""
    if dotted.rsplit(".", 1)[-1] != leaf_name:
        return False
    if not (
        dotted == leaf_name
        or "comm" in dotted
        or "redistribute" in dotted
        or "heat_tpu" in dotted
    ):
        return False
    policy = expr.args[0] if expr.args else None
    if policy is None:
        for kw in expr.keywords:
            if kw.arg == "policy":
                policy = kw.value
    return isinstance(policy, ast.Constant) and policy.value in ("planned", "auto")


@rule("SPMD206", "monolithic split→split resplit inside a loop body")
def check_resplit_in_loop(ctx: FileContext) -> Iterable[Finding]:
    """A ``resplit``/``alltoall``/``commit_split`` lexically inside a
    ``for``/``while`` body repeats the framework's single most expensive
    layout primitive every iteration: under the monolithic policy each
    pass is a worst-case relayout (a padded copy of the whole array).
    Almost always the change is loop-invariant and hoists, or belongs
    under the planned redistribution policy, whose rotation schedule
    moves ``(p-1)/p²`` of the array per position with bounded peak
    memory.  Exempt when the call sits inside a ``with
    redistribution("planned"|"auto")`` block or follows a
    ``set_redistribution("planned"|"auto")`` call in the same scope;
    captured bodies (fuse) are also exempt: there the call is recorded
    once into the program, not dispatched per iteration."""
    planned_sets: List[Tuple[ast.AST, int]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _planned_policy_call(
            ctx, node, "set_redistribution"
        ):
            encl = ctx.enclosing_functions(node)
            planned_sets.append((encl[0] if encl else ctx.tree, node.lineno))

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = ctx.resolve(node.func) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        if leaf not in _RESPLIT_CALLS:
            continue
        # a resplit is a method of a DNDarray/comm object (or the comm
        # module's function): a bare local helper named `resplit` is not
        # the layout primitive
        if "." not in dotted:
            continue
        if ctx.in_traced_context(node):
            continue
        in_loop = False
        exempt = False
        cur: Optional[ast.AST] = node
        while cur is not None:
            cur = ctx.parents.get(cur)
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                in_loop = True
            if isinstance(cur, ast.With):
                for item in cur.items:
                    if _planned_policy_call(ctx, item.context_expr, "redistribution"):
                        exempt = True
                        break
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break  # loop containment is per-function, not lexical-outward
        if not in_loop or exempt:
            continue
        encl = ctx.enclosing_functions(node)
        scope = encl[0] if encl else ctx.tree
        if any(s is scope and ln < node.lineno for s, ln in planned_sets):
            continue
        yield ctx.finding(
            "SPMD206", node,
            f"monolithic layout change {leaf!r} inside a loop body pays a "
            "worst-case reshard every iteration",
            hint="hoist the resplit out of the loop if the layout is "
            "loop-invariant; otherwise run it under the planned "
            "redistribution policy (ht.comm.set_redistribution('planned') "
            "or `with redistribution(\"planned\")`), whose compiled "
            "schedule is minimal-traffic and memory-bounded — or mark the "
            "call with `# spmdlint: disable=SPMD206` if the per-iteration "
            "monolithic reshard is deliberate",
        )


# --------------------------------------------------------------------- #
# SPMD207: silent broad except around dispatch/collective/io sites       #
# --------------------------------------------------------------------- #
#: exception leaves that catch "anything that can go wrong at a guarded
#: site": the fault classes the resilience layer exists to make visible
_BROAD_EXC = {"Exception", "BaseException", "OSError", "IOError",
              "EnvironmentError"}

#: call leaves whose failures must never vanish: file opens/loads/saves,
#: checkpoint and loop-snapshot manifests, layout changes, collectives
_GUARDED_SITE_CALLS = {
    "open", "File", "Dataset",
    "load", "save", "load_hdf5", "save_hdf5", "load_netcdf", "save_netcdf",
    "load_csv", "save_csv", "load_loop_state", "save_loop_state",
    "load_estimator", "save_estimator",
    "resplit", "resplit_", "commit_split", "apply_sharding", "redistribute",
    "alltoall", "allreduce", "allgather", "all_gather", "ppermute", "psum",
}


def _broad_handler_names(ctx: FileContext, handler: ast.ExceptHandler) -> List[str]:
    """The broad exception leaves a handler catches (empty = narrow)."""
    t = handler.type
    if t is None:
        return ["(bare except)"]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for e in elts:
        dotted = ctx.resolve(e) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        if leaf in _BROAD_EXC:
            out.append(leaf)
    return out


def _handler_is_silent(ctx: FileContext, handler: ast.ExceptHandler) -> bool:
    """True when nothing in the handler body makes the fault visible: no
    re-raise, no reference to the caught exception (the deferred-error
    barrier pattern binds it: ``err = e``), no incident record, no
    warning/log call."""
    caught = handler.name
    for stmt in handler.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Raise):
                return False
            if caught and isinstance(sub, ast.Name) and sub.id == caught:
                return False
            if isinstance(sub, ast.Call):
                dotted = ctx.resolve(sub.func) or ""
                leaf = dotted.rsplit(".", 1)[-1]
                if leaf == "record" or "incident" in dotted:
                    return False
                if leaf in ("warn", "warning", "error", "exception", "critical"):
                    return False
    return True


@rule("SPMD207", "silent broad except around dispatch/collective/io sites")
def check_silent_broad_except(ctx: FileContext) -> Iterable[Finding]:
    """A ``try`` whose body touches a dispatch, collective, or io site
    (file opens/loads/saves, checkpoint manifests, resplits, ring
    collectives) with an ``except Exception``/``except OSError`` handler
    that neither re-raises, nor references the caught exception (the
    deferred-error barrier pattern: ``err = e`` past a collective fence),
    nor records an incident, makes the fault *invisible*: the fit
    continues on garbage, the chaos lane can't see the injection, and the
    retry/elastic machinery never engages.  Transient faults belong on
    the retry engine (``resilience.retry``); real failures belong in the
    incident log (``resilience.incidents.record``) or propagated."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        guarded_leaf = None
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                dotted = ctx.resolve(sub.func) or ""
                leaf = dotted.rsplit(".", 1)[-1]
                if leaf in _GUARDED_SITE_CALLS:
                    guarded_leaf = leaf
                    break
            if guarded_leaf:
                break
        if guarded_leaf is None:
            continue
        for handler in node.handlers:
            broad = _broad_handler_names(ctx, handler)
            if not broad or not _handler_is_silent(ctx, handler):
                continue
            yield ctx.finding(
                "SPMD207", handler,
                f"broad `except {broad[0]}` swallows failures of guarded "
                f"site {guarded_leaf!r} without re-raise or incident "
                "record — the fault becomes invisible",
                hint="re-raise after cleanup, bind and defer the exception "
                "past the barrier (err = e), route transients through "
                "resilience.retry, or record it with "
                "resilience.incidents.record(...); mark the handler with "
                "`# spmdlint: disable=SPMD207` if the swallow is deliberate",
            )


# --------------------------------------------------------------------- #
# SPMD208: unbucketed dynamic batch shape entering a fused program       #
# --------------------------------------------------------------------- #
#: shape-canonicalization helpers: a slice bound routed through one of
#: these is drawn from a finite shape space (powers of two / shard
#: multiples), so the fused-program cache stays bounded
_BUCKETING_CALLS = {
    "bucket_rows", "next_pow2", "_padded_len", "pad_to_bucket",
    "pad_to_shards", "pad_batch",
}


def _is_compiled_callable(ctx: FileContext, func: ast.AST, at: ast.AST,
                          eager: bool = True) -> bool:
    """True when ``func`` is a program value: a direct ``fuse(f)(...)``
    product, a name bound from one, or a function defined under
    ``@fuse``; with ``eager`` also a ``jitted(key, make)(...)`` product
    (one op-engine dispatch, which runs eagerly and never re-captures).
    ``jax.jit`` products count as programs too, as in the reference."""
    makers = ("fuse", "jax.jit", "jitted") if eager else ("fuse", "jax.jit")
    if isinstance(func, ast.Call):
        return ctx.resolves_to(func.func, *makers)
    if isinstance(func, ast.Name):
        rec = ctx.lookup(func.id, at)
        if (
            rec is not None
            and rec[0] == "expr"
            and isinstance(rec[1], ast.Call)
            and ctx.resolves_to(rec[1].func, *makers)
        ):
            return True
        fn = ctx.local_function(func.id, at)
        if isinstance(fn, ast.FunctionDef):
            for dec in fn.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if ctx.resolves_to(target, "fuse", "jax.jit"):
                    return True
    return False


def _bound_is_bucketed(ctx: FileContext, bound: ast.AST, at: ast.AST) -> bool:
    """True when the slice bound routes through a bucketing helper:
    directly (``x[:bucket_rows(n)]``) or via one local assignment
    (``b = bucket_rows(n); ... x[:b]``)."""
    for sub in ast.walk(bound):
        if isinstance(sub, ast.Call):
            dotted = ctx.resolve(sub.func) or ""
            if dotted.rsplit(".", 1)[-1] in _BUCKETING_CALLS:
                return True
        if isinstance(sub, ast.Name):
            rec = ctx.lookup(sub.id, at)
            if rec is not None and rec[0] == "expr" and isinstance(rec[1], ast.Call):
                dotted = ctx.resolve(rec[1].func) or ""
                if dotted.rsplit(".", 1)[-1] in _BUCKETING_CALLS:
                    return True
    return False


def _dynamic_slice_operand(
    ctx: FileContext, expr: ast.AST, at: ast.AST
) -> Optional[ast.Subscript]:
    """The offending Subscript when ``expr`` is (or is a name
    once-assigned from) a slice whose bounds are dynamic and unbucketed;
    None otherwise."""
    if isinstance(expr, ast.Name):
        rec = ctx.lookup(expr.id, at)
        if rec is not None and rec[0] == "expr":
            expr = rec[1]
    if not isinstance(expr, ast.Subscript):
        return None
    sl = expr.slice
    slices = [sl] if isinstance(sl, ast.Slice) else (
        [e for e in sl.elts if isinstance(e, ast.Slice)]
        if isinstance(sl, ast.Tuple) else []
    )
    bounds = [b for s in slices for b in (s.lower, s.upper) if b is not None]
    dynamic = [
        b for b in bounds
        if any(isinstance(sub, (ast.Name, ast.Call)) for sub in ast.walk(b))
    ]
    if not dynamic:
        return None
    if all(_bound_is_bucketed(ctx, b, at) for b in dynamic):
        return None
    return expr


@rule("SPMD208", "unbucketed dynamic batch shape entering a fused program in a loop")
def check_unbucketed_dynamic_batch(ctx: FileContext) -> Iterable[Finding]:
    """A call to a fused program (``fuse(...)`` product or
    ``@fuse``-decorated function) lexically inside a ``for``/``while``
    body, where an operand is a slice with data-dependent bounds
    (``queue[off : off + n]``), traces and captures once per DISTINCT
    shape: the fuse cache keys on operand shapes, so a request-sized
    slice turns the cache into an unbounded capture treadmill (one CUDA
    graph and its pool memory per batch size ever seen, each a full
    warm-up+capture pause at serving time).  The op engine's ``jitted``
    is left out: it runs eagerly, with no program per shape.

    The fix is the serving pad discipline: round the row count to a
    power of two and zero-pad (``serve.bucket_rows`` + ``pad_batch``, or
    ``pad_to_shards`` on a split axis) so the shape space is finite and
    every steady-state call replays a warm graph.  Bounds routed through
    those bucketing helpers (directly or via one local assignment) are
    exempt, as are constant bounds and captured bodies (inside a capture
    the slice is program structure, not a per-call shape)."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not _is_compiled_callable(ctx, node.func, node, eager=False):
            continue
        if ctx.in_traced_context(node):
            continue
        in_loop = False
        cur: Optional[ast.AST] = node
        while cur is not None:
            cur = ctx.parents.get(cur)
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                in_loop = True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break  # loop containment is per-function, as in SPMD206
        if not in_loop:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            offending = _dynamic_slice_operand(ctx, arg, node)
            if offending is None:
                continue
            yield ctx.finding(
                "SPMD208", node,
                f"dynamic-shape operand {ast.unparse(offending)!r} enters a "
                "fused program inside a loop — every distinct slice "
                "length is a fresh trace+capture, an unbounded program "
                "cache",
                hint="bucket the row count to a finite shape space before "
                "the call (serve.bucket_rows + pad_batch zero-padding, or "
                "pad_to_shards on a split axis) and slice the result "
                "AFTER the fused call; mark the call with "
                "`# spmdlint: disable=SPMD208` if the slice lengths are "
                "genuinely bounded",
            )
            break


# --------------------------------------------------------------------- #
# SPMD210: request-scoped observability inside captured functions        #
# --------------------------------------------------------------------- #
#: dotted-suffix forms of the request-scoped observability entry points
#: (`heat_tpu_torch.telemetry`, the `heat_tpu_torch.obs` facade, and the
#: internal `from ..telemetry import _core` spelling): context managers
#: and calls that run at CAPTURE time inside a captured body
_OBS_CTX_SUFFIXES = (
    "telemetry.trace_ctx", "telemetry._core.trace_ctx", "obs.trace_ctx",
)
_OBS_CALL_SUFFIXES = (
    "telemetry.observe", "telemetry._core.observe", "obs.observe",
)
_OBS_FLIGHT_SUFFIXES = ("flight.note",)


def _obs_match(dotted: str, suffixes) -> bool:
    return any(dotted == s or dotted.endswith("." + s) for s in suffixes)


@rule("SPMD210", "request-scoped observability inside captured functions records capture time, not run time")
def check_traced_observability(ctx: FileContext) -> Iterable[Finding]:
    """The SPMD205 argument, extended to the observability layer: a
    ``telemetry.trace_ctx`` entered, a ``telemetry.observe`` recorded, or
    a ``flight.note`` appended inside a fused or graph-captured body runs
    ONCE, at capture (and at fuse's warm-up before it).  The trace context
    is set and torn down before any replay runs (no replay can carry the
    ids); the histogram receives the capture's observations, none of the
    replays'; the flight note records the *capture* of the program, not
    its launches.  All three belong at the HOST call site, around the
    fused call, where the serve engine places them."""
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and ctx.in_traced_context(node)):
            continue
        dotted = ctx.resolve(node.func)
        if dotted is None:
            continue
        if _obs_match(dotted, _OBS_CTX_SUFFIXES):
            yield ctx.finding(
                "SPMD210", node,
                "telemetry.trace_ctx entered inside a traced function",
                hint="the context is installed and reset during the CAPTURE; "
                "replays carry no request ids; wrap the host call site "
                "instead (the serve engine re-establishes the context per "
                "micro-batch around its fused predict call)",
            )
        elif _obs_match(dotted, _OBS_CALL_SUFFIXES):
            yield ctx.finding(
                "SPMD210", node,
                "telemetry.observe recorded inside a traced function",
                hint="the histogram receives the capture's observations, not "
                "per-replay samples; observe the measured value at the host "
                "call site after torch.cuda.synchronize",
            )
        elif _obs_match(dotted, _OBS_FLIGHT_SUFFIXES):
            yield ctx.finding(
                "SPMD210", node,
                "flight-recorder note inside a traced function",
                hint="the note records the one-time capture, not the "
                "replays; note at the host call site, or rely on the "
                "_emit mirror for enabled-telemetry events",
            )


# --------------------------------------------------------------------- #
# SPMD211: retry loop without a deadline                                 #
# --------------------------------------------------------------------- #
#: identifier fragments whose presence anywhere in the loop marks it as
#: BOUNDED: a deadline/timeout check, an attempt budget, or delegation to
#: the retry engine (``for attempt in retry(policy)`` never matches the
#: rule anyway: it is a ``for``, not a ``while True``)
_RETRY_BOUND_MARKERS = (
    "deadline", "attempt", "retry", "timeout", "tries", "budget", "backoff",
)


def _loop_mentions_bound(node: ast.While) -> bool:
    """True when any identifier in the loop smells like a bound: the
    author is counting attempts or watching a clock, so the loop is a
    (possibly hand-rolled) bounded retry, not an infinite one."""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.keyword):
            name = sub.arg
        if name is not None:
            low = name.lower()
            if any(m in low for m in _RETRY_BOUND_MARKERS):
                return True
    return False


def _handler_swallows_and_retries(handler: ast.ExceptHandler) -> bool:
    """True when the handler neither escapes the loop (``break``/
    ``return``) nor propagates (``raise``): control falls back to the
    ``while True`` header and the failing call runs again, forever."""
    for stmt in handler.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.Raise, ast.Break, ast.Return)):
                return False
    return True


def _retried_site(ctx: FileContext, try_node: ast.Try) -> Optional[str]:
    """The retry-worthy call inside the ``try`` body, if any: a program
    call (a fuse product or a jitted dispatch) or one of SPMD207's
    guarded io/layout sites.  Anything else failing forever is somebody
    else's lint."""
    for stmt in try_node.body:
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Call):
                continue
            if _is_compiled_callable(ctx, sub.func, sub):
                return "a compiled program call"
            dotted = ctx.resolve(sub.func) or ""
            leaf = dotted.rsplit(".", 1)[-1]
            if leaf in _GUARDED_SITE_CALLS:
                return f"guarded site {leaf!r}"
    return None


@rule("SPMD211", "retry loop without a deadline around a compiled/guarded call")
def check_unbounded_retry(ctx: FileContext) -> Iterable[Finding]:
    """A ``while True`` whose body try/excepts a program call (a fuse
    product or a jitted dispatch) or a guarded io/layout site, where the
    handler swallows and loops (no ``raise``/``break``/``return``),
    retries FOREVER: a permanent fault (positions gone, manifest corrupt,
    sidecar deleted) turns into a silent busy-loop that holds the serving
    thread, never surfaces an incident, and defeats the chaos lane's
    determinism (fire counts diverge with host timing).  Bounded retries
    belong on the retry engine: ``for attempt in
    resilience.retry.retry(policy, site=...)`` gives a deadline, jittered
    backoff, and incident records for free.  Loops that visibly count
    attempts or check a deadline/timeout are exempt, as is the retry
    engine's own implementation."""
    if ctx.relpath.endswith("resilience/retry.py"):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.While):
            continue
        test = node.test
        if not (isinstance(test, ast.Constant) and bool(test.value)):
            continue
        if _loop_mentions_bound(node):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Try):
                continue
            site = _retried_site(ctx, sub)
            if site is None:
                continue
            for handler in sub.handlers:
                if not _handler_swallows_and_retries(handler):
                    continue
                yield ctx.finding(
                    "SPMD211", handler,
                    f"`while True` retries {site} with no deadline or "
                    "attempt budget — a permanent fault becomes an "
                    "infinite busy-loop",
                    hint="route the call through `for attempt in "
                    "resilience.retry.retry(policy, site=...)` (deadline + "
                    "seeded backoff + incidents), or bound the loop with "
                    "an attempt counter / deadline check; mark with "
                    "`# spmdlint: disable=SPMD211` if the forever-retry "
                    "is deliberate",
                )


# --------------------------------------------------------------------- #
# SPMD212: blocking host read inside a program-dispatching loop          #
# --------------------------------------------------------------------- #
#: dotted names whose call opens an on-disk dataset handle: re-opening
#: (and reading) one of these per loop iteration serializes the loop on
#: host storage latency
_HOST_READ_OPENERS = frozenset({
    "h5py.File",
    "netCDF4.Dataset",
    "scipy.io.netcdf_file",
})


def _file_handle_expr(ctx: FileContext, expr, at, depth: int = 0) -> bool:
    """True when ``expr`` evaluates to (a view of) an on-disk dataset
    handle: a direct opener call, a name once-bound to one, a subscript
    chain off one (``f[name][lo:hi]``), or its ``.variables`` mapping."""
    if depth > 8:
        return False
    if isinstance(expr, ast.Attribute) and expr.attr == "variables":
        return _file_handle_expr(ctx, expr.value, at, depth + 1)
    if isinstance(expr, ast.Subscript):
        return _file_handle_expr(ctx, expr.value, at, depth + 1)
    if isinstance(expr, ast.Call):
        return (ctx.resolve(expr.func) or "") in _HOST_READ_OPENERS
    if isinstance(expr, ast.Name):
        rec = ctx.lookup(expr.id, at)
        if rec is not None and rec[0] == "expr":
            return _file_handle_expr(ctx, rec[1], at, depth + 1)
    return False


def _blocking_host_read(ctx: FileContext, call: ast.Call) -> Optional[str]:
    """Why ``call`` is a blocking on-disk read, or None if it isn't."""
    dotted = ctx.resolve(call.func) or ""
    if dotted in _HOST_READ_OPENERS:
        return f"`{dotted}` re-opens the file every iteration"
    leaf = dotted.rsplit(".", 1)[-1]
    if (
        leaf in ("asarray", "array")
        and call.args
        and _file_handle_expr(ctx, call.args[0], call)
    ):
        return (
            f"`{leaf}` of a file-handle slice materializes the slab "
            "synchronously on the host"
        )
    if (
        isinstance(call.func, ast.Attribute)
        and call.func.attr == "read_direct"
        and _file_handle_expr(ctx, call.func.value, call)
    ):
        return "`read_direct` on an open dataset handle blocks on storage"
    return None


@rule("SPMD212", "blocking host read inside a loop that dispatches compiled programs")
def check_blocking_read_in_compiled_loop(ctx: FileContext) -> Iterable[Finding]:
    """A loop body that both reads from an on-disk dataset (h5py/netCDF4
    handle access, ``np.asarray`` over a file-handle slice) and dispatches
    a program (a fuse product or a jitted op) serializes the card behind
    host storage: every iteration the card sits idle for the full
    read+copy latency before its next dispatch, the exact
    ``h·(read+copy+compute)`` serial schedule ``comm._costs.stream_model``
    prices.  The streaming path reads chunk ``t+1`` on a worker thread
    while chunk ``t`` computes (``read + h·max(read+copy, compute)``) and
    its generator keeps the read out of the dispatching loop's body by
    construction.  Reads in captured contexts are exempt (they are
    capture-time constants, not per-dispatch io)."""
    for loop in ast.walk(ctx.tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        compiled = None
        read = None
        why = None
        for stmt in loop.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call) or ctx.in_traced_context(sub):
                    continue
                if compiled is None and _is_compiled_callable(ctx, sub.func, sub):
                    compiled = sub
                if read is None:
                    why = _blocking_host_read(ctx, sub)
                    if why is not None:
                        read = sub
        if compiled is not None and read is not None:
            yield ctx.finding(
                "SPMD212", read,
                "blocking host read in a loop body that also dispatches a "
                f"compiled program — {why}, so the device idles behind "
                "storage every iteration",
                hint="stream the dataset through "
                "`heat_tpu_torch.io.stream.stream_chunks` (double-buffered "
                "host→device prefetch overlaps the next read with this "
                "chunk's compute), or hoist the read out of the loop; mark "
                "with `# spmdlint: disable=SPMD212` if the serialization "
                "is deliberate",
            )


# --------------------------------------------------------------------- #
# SPMD213: blocking socket/pipe I/O inside a program-dispatching loop    #
# --------------------------------------------------------------------- #
#: module-level calls that block the calling thread on a peer process or
#: pipe: one of these per iteration serializes the card behind IPC
_BLOCKING_PIPE_CALLS = frozenset({
    "os.read",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
})

#: socket methods that block until the peer answers
_SOCKET_BLOCKING_METHODS = frozenset({"recv", "recv_into", "recvfrom", "accept"})

#: constructors whose value is a socket object
_SOCKET_OPENERS = frozenset({
    "socket.socket", "socket.create_connection",
})

#: methods on a ``subprocess.Popen`` value that wait for the child
_POPEN_WAIT_METHODS = frozenset({"wait", "communicate"})


def _value_from_opener(ctx: FileContext, expr, at, openers: frozenset,
                       depth: int = 0) -> bool:
    """True when ``expr`` evaluates to a value produced by one of the
    ``openers``: a direct constructor call or a name once-bound to one."""
    if depth > 8:
        return False
    if isinstance(expr, ast.Call):
        return (ctx.resolve(expr.func) or "") in openers
    if isinstance(expr, ast.Name):
        rec = ctx.lookup(expr.id, at)
        if rec is not None and rec[0] == "expr":
            return _value_from_opener(ctx, rec[1], at, openers, depth + 1)
    return False


def _blocking_pipe_io(ctx: FileContext, call: ast.Call) -> Optional[str]:
    """Why ``call`` blocks on a socket/pipe/child, or None if it doesn't."""
    dotted = ctx.resolve(call.func) or ""
    if dotted in _BLOCKING_PIPE_CALLS:
        return f"`{dotted}` blocks the dispatching thread on a pipe/child"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _SOCKET_BLOCKING_METHODS and _value_from_opener(
            ctx, call.func.value, call, _SOCKET_OPENERS
        ):
            return f"`.{attr}` on a socket blocks until the peer answers"
        if attr in _POPEN_WAIT_METHODS and _value_from_opener(
            ctx, call.func.value, call, frozenset({"subprocess.Popen"})
        ):
            return f"`.{attr}` waits for the child process to exit"
    return None


@rule("SPMD213", "blocking socket/pipe I/O inside a loop that dispatches compiled programs")
def check_blocking_ipc_in_compiled_loop(ctx: FileContext) -> Iterable[Finding]:
    """A loop body that both performs blocking IPC (``socket.recv``,
    ``os.read``, ``subprocess.run``, ``Popen.wait``/``communicate``) and
    dispatches a program (a fuse product or a jitted op) serializes the
    card behind the peer: every iteration the card idles for the full
    round-trip before its next dispatch, the process-boundary twin of
    SPMD212's storage stall.  The serving plane's shape is the fix: the
    dispatching loop lives in the replica process and never touches a
    socket, while the parent's RPC threads (``serve.procfleet``) own the
    blocking recv and feed work through queues.  IPC in captured contexts
    is exempt (capture-time constants, not per-dispatch waits)."""
    for loop in ast.walk(ctx.tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        compiled = None
        ipc = None
        why = None
        for stmt in loop.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call) or ctx.in_traced_context(sub):
                    continue
                if compiled is None and _is_compiled_callable(ctx, sub.func, sub):
                    compiled = sub
                if ipc is None:
                    why = _blocking_pipe_io(ctx, sub)
                    if why is not None:
                        ipc = sub
        if compiled is not None and ipc is not None:
            yield ctx.finding(
                "SPMD213", ipc,
                "blocking socket/pipe I/O in a loop body that also "
                f"dispatches a compiled program — {why}, so the device "
                "idles behind IPC every iteration",
                hint="move the exchange off the dispatch path: a worker "
                "thread owning the socket feeds a queue the loop drains "
                "(the `heat_tpu_torch.serve.procfleet` worker/outbox shape), or "
                "batch the IPC outside the loop; mark with "
                "`# spmdlint: disable=SPMD213` if the round-trip is "
                "deliberate",
            )


# --------------------------------------------------------------------- #
# SPMD214: unbounded blocking wait inside a worker loop                  #
# --------------------------------------------------------------------- #
def _opener_call(ctx: FileContext, expr, at, openers: frozenset,
                 depth: int = 0) -> Optional[ast.Call]:
    """The opener call that produced ``expr``'s value (a direct
    constructor call or a name once-bound to one), or None: the
    call-returning sibling of :func:`_value_from_opener`, kept separate
    so SPMD214 can inspect the opener's own arguments."""
    if depth > 8:
        return None
    if isinstance(expr, ast.Call):
        return expr if (ctx.resolve(expr.func) or "") in openers else None
    if isinstance(expr, ast.Name):
        rec = ctx.lookup(expr.id, at)
        if rec is not None and rec[0] == "expr":
            return _opener_call(ctx, rec[1], at, openers, depth + 1)
    return None


def _socket_has_timeout(ctx: FileContext, recv_call: ast.Call) -> bool:
    """True when the socket behind ``recv_call`` is visibly bounded: its
    opener passed a ``timeout`` (keyword, or ``create_connection``'s
    second positional), or the file calls ``settimeout`` with a
    non-None value on the same name."""
    opener = _opener_call(ctx, recv_call.func.value, recv_call,
                          _SOCKET_OPENERS)
    if opener is None:
        return True  # unknown provenance: not ours to flag
    if any(kw.arg == "timeout" for kw in opener.keywords):
        return True
    if (ctx.resolve(opener.func) or "").endswith("create_connection") \
            and len(opener.args) >= 2:
        return True
    if isinstance(recv_call.func.value, ast.Name):
        name = recv_call.func.value.id
        for sub in ast.walk(ctx.tree):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "settimeout"
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id == name
                and sub.args
                and not (isinstance(sub.args[0], ast.Constant)
                         and sub.args[0].value is None)
            ):
                return True
    return False


def _unbounded_wait(ctx: FileContext, call: ast.Call) -> Optional[str]:
    """Why ``call`` can block its worker thread forever, or None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in ("wait", "get") and not call.args and not call.keywords:
        # zero-arg wait()/get(): a Condition/Event/Queue/Popen blocking
        # call with no timeout at all (dict.get always has arguments,
        # so mapping reads never match)
        return (
            f"`.{attr}()` has no timeout, so the thread blocks forever "
            "when the notify/put/exit it waits for never comes"
        )
    if attr in _SOCKET_BLOCKING_METHODS and not _socket_has_timeout(ctx, call):
        return (
            f"`.{attr}` on a timeout-less socket blocks forever when the "
            "peer stalls without closing (the half-open gray failure)"
        )
    return None


@rule("SPMD214", "unbounded wait/recv inside a `while True` worker loop")
def check_unbounded_wait_in_worker_loop(ctx: FileContext) -> Iterable[Finding]:
    """A ``while True`` worker loop parked on a zero-timeout blocking
    call (``cv.wait()``, ``queue.get()``, ``popen.wait()``, or a
    ``recv``/``accept`` on a socket with no timeout anywhere in sight)
    can never observe anything but the event it waits for: a peer that
    stalls without closing (the half-open socket), a producer that died
    mid-hand-off, or a shutdown flag all leave the thread wedged forever,
    unjoinable and invisible to deadlines.  That is exactly the gray
    failure the serving plane's hardening exists to catch, and the fix is
    always the same shape: wait with a timeout inside the loop and
    re-check liveness/deadline on each wakeup (the deadline-aware waits
    in ``serve.procfleet.flush`` / ``serve.wfq.pop``).  Loops that
    visibly track a bound (deadline/timeout/attempt/budget identifiers,
    same exemption as SPMD211) are exempt: the author is already
    watching a clock."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.While):
            continue
        test = node.test
        if not (isinstance(test, ast.Constant) and bool(test.value)):
            continue
        if _loop_mentions_bound(node):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) or ctx.in_traced_context(sub):
                continue
            why = _unbounded_wait(ctx, sub)
            if why is None:
                continue
            yield ctx.finding(
                "SPMD214", sub,
                f"unbounded blocking wait in a `while True` worker loop "
                f"— {why}",
                hint="wait with a timeout and re-check liveness/deadline "
                "each wakeup (compute the deadline once, wait the "
                "remainder — the `serve.wfq.pop` shape), or bound the "
                "socket with `settimeout`; mark with "
                "`# spmdlint: disable=SPMD214` if blocking forever is "
                "deliberate",
            )


# --------------------------------------------------------------------- #
# SPMD401: jitted() cache-key hygiene                                    #
# --------------------------------------------------------------------- #
_OK_KEY_ATTRS = {
    "dtype", "ndim", "shape", "size", "split", "axis_name", "name",
    "itemsize", "value",
}
_OK_KEY_CALLS = {"str", "int", "float", "bool", "tuple", "len", "repr", "frozenset", "hash"}


def _classify_key_element(ctx: FileContext, el: ast.AST, fn_scope) -> Optional[Tuple[str, str]]:
    """Return (message, hint) when ``el`` is a risky cache-key part."""
    if isinstance(el, ast.Constant):
        return None
    if isinstance(el, (ast.Tuple,)):
        for sub in el.elts:
            bad = _classify_key_element(ctx, sub, fn_scope)
            if bad:
                return bad
        return None
    if isinstance(el, (ast.List, ast.Dict, ast.Set)):
        return (
            "unhashable literal in jitted() key",
            "use a tuple (lists/dicts/sets raise TypeError at lookup)",
        )
    if isinstance(el, ast.Lambda):
        return (
            "lambda in jitted() key",
            "a fresh lambda has a fresh identity every call: the seen-key "
            "table grows one dead entry per call and never hits",
        )
    if isinstance(el, ast.Starred):
        return ("starred element in jitted() key", "splice statically instead")
    if isinstance(el, ast.Name):
        # a name that the enclosing function CALLS is a callable value:
        # bound methods / closures in keys are the ring_map cache leak
        if fn_scope is not None:
            for sub in ast.walk(fn_scope):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == el.id
                ):
                    return (
                        f"callable {el.id!r} in jitted() key",
                        "bound methods and closures are not identity-stable "
                        "across calls (the ring_map cache leak); key on stable "
                        "data instead, or gate with _compile.cache_stable() "
                        "and suppress",
                    )
        return None
    if isinstance(el, ast.Attribute):
        if el.attr in _OK_KEY_ATTRS:
            return None
        return (
            f"attribute {ast.unparse(el)!r} in jitted() key may be a bound "
            "method or per-call object",
            "key on plain data (dtype/shape/axis tuples, str(dtype), "
            "comm) — never on methods or tensors",
        )
    if isinstance(el, ast.Call):
        if isinstance(el.func, ast.Name) and el.func.id in _OK_KEY_CALLS:
            return None
        dotted = ctx.resolve(el.func) or ""
        if dotted.startswith(("torch.", "numpy.")):
            return (
                f"array-valued call {dotted!r} in jitted() key",
                "tensors are unhashable by value and never identity-stable; "
                "key on the static parameters that produced the tensor",
            )
        return (
            f"unvetted call {ast.unparse(el.func)!r} in jitted() key",
            "only str/int/float/bool/tuple/len conversions are known "
            "hashable+stable; hoist anything else into a named static",
        )
    if isinstance(el, (ast.BinOp, ast.UnaryOp, ast.Compare, ast.IfExp, ast.Subscript)):
        return None  # plain data arithmetic: hashable if its parts are
    if isinstance(el, ast.JoinedStr):
        return None
    return None


@rule("SPMD401", "jitted() cache keys: hashable, identity-stable parts only")
def check_jit_cache_keys(ctx: FileContext) -> Iterable[Finding]:
    """Call sites of the op engine's ``jitted(key, make_fn)`` must build
    ``key`` from parts that are hashable AND identity-stable across calls:
    no bound methods, no lambdas/closures, no tensors.  In the port the
    key decides the compile-cache hit and miss counts and what the
    seen-key table keeps (``core/_compile.py`` ``_SEEN``), not which
    program runs: an unstable key grows the table by one dead entry a
    call and counts every call a miss.  The key must be a tuple literal
    visible at the call site (directly or via one local assignment) so
    this can be audited at all."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not ctx.resolves_to(node.func, "jitted"):
            continue
        if not node.args:
            continue
        key = node.args[0]
        anchor = node
        if isinstance(key, ast.Name):
            rec = ctx.lookup(key.id, node)
            if rec is not None and rec[0] == "expr":
                key = rec[1]
        if not isinstance(key, ast.Tuple):
            yield ctx.finding(
                "SPMD401", anchor,
                "jitted() key is not a statically-visible tuple literal",
                hint="build the key as a tuple at (or one assignment above) "
                "the call site so its parts can be audited",
            )
            continue
        if not (key.elts and isinstance(key.elts[0], ast.Constant)
                and isinstance(key.elts[0].value, str)):
            yield ctx.finding(
                "SPMD401", anchor,
                "jitted() key does not start with a namespace string",
                hint="lead with a unique op-name string so two ops can "
                "never collide on structurally-equal parameter tuples",
            )
        enclosing = ctx.enclosing_functions(node)
        fn_scope = enclosing[-1] if enclosing else None
        for el in key.elts:
            bad = _classify_key_element(ctx, el, fn_scope)
            if bad:
                yield ctx.finding("SPMD401", anchor, bad[0], hint=bad[1])


# --------------------------------------------------------------------- #
# SPMD001: suppression hygiene                                          #
# --------------------------------------------------------------------- #
@rule("SPMD001", "inline suppression of a reason-required rule must carry a reason")
def check_suppression_reasons(ctx: FileContext) -> Iterable[Finding]:
    """A ``# spmdlint: disable=...`` comment that silences a rule in
    :data:`~heat_tpu_torch.analysis.rules.REASON_REQUIRED` (SPMD204,
    SPMD207: the checks whose whole purpose is making a risky pattern
    deliberate) must justify itself with a ``-- reason`` tail::

        # spmdlint: disable=SPMD204 -- bench harness, guards off by design

    A bare suppression (or an empty reason after ``--``) of those rules is
    itself a finding, so silencing the check leaves an audit trail either
    way."""
    from .rules import REASON_REQUIRED

    for lineno, ids, reason in ctx.suppressions():
        gated = sorted(set(ids) & REASON_REQUIRED)
        if gated and not reason:
            anchor = ast.Pass(lineno=lineno, col_offset=0)
            yield ctx.finding(
                "SPMD001", anchor,
                f"suppression of {', '.join(gated)} has no reason",
                hint="append '-- <why this is safe here>' to the "
                "spmdlint: disable comment",
            )
