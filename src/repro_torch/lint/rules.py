"""The port's rules: RPT001–RPT007.

Each rule mechanically checks one invariant of the PyTorch/CUDA port that
review and the runtime tests otherwise hold after the fact (see
``docs/static_analysis_torch.md`` for the rule ↔ invariant table):

- **RPT001** — randomness without an explicit generator: a torch sampler
  called without ``generator=``, or one generator re-seeded with the same
  seed expression between its draws (the second draw repeats the first).
- **RPT002** — a host sync on the launch path: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``, ``int``/``float``/
  ``bool`` of a tensor-derived value, or ``if``/``while``/``assert`` on one.
- **RPT003** — one builder and no fast math: a ``cpp_extension.load*``
  call or an ``nvcc`` subprocess outside ``kernels/_build.py``; a fast-math
  flag in ``CUDA_FLAGS``; a fast-math intrinsic in a CUDA source.
- **RPT004** — host library calls (``numpy``, ``time``, ``datetime``,
  stdlib ``random``) on the launch path.
- **RPT005** — a tensor factory on the launch path without ``device=``.
- **RPT006** — a write to a kernel's launch counter or to the build
  counter outside the module that owns it (a reset to 0 is allowed).
- **RPT007** — an ``except`` on a kernel route that falls back to a plain
  version or swallows the error.

The launch path is :data:`LAUNCH_PATH`: the per-step entry functions by
module, each with the functions of its module that it calls,
transitively.  Rules are flow-light by design: linear statement order with
branch forks, no analysis across modules.  Heuristic misses are
acceptable; false positives on ``src/repro_torch`` are not (the port's
tree is held to ``--strict``).
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Iterator

from .context import CudaContext, LaunchRegion, ModuleContext

RawFinding = tuple[int, int, str]  # (line, col, message)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    check: Callable[[ModuleContext], Iterator[RawFinding]] | None
    check_cuda: Callable[[CudaContext], Iterator[RawFinding]] | None = None


# ---------------------------------------------------------------------------
# the launch path
# ---------------------------------------------------------------------------

#: The reviewed table of the per-step entry functions, by module below
#: ``repro_torch/``: what one provisioning call, one stepper chunk, one
#: serving prefill or decode step and one step of each model family runs
#: (``chip_smoke.py`` phases 4, 12, 13 and 15), and the sequence-parallel
#: boundaries of a sharded step (phase 19).  A region is such a
#: function plus the functions of its module that it calls, transitively.
#: ``Class.method`` names a method (``self.m(...)`` calls are followed).
LAUNCH_PATH: dict[str, tuple[str, ...]] = {
    # provision() / provision_stream(): the engine run of one call
    "core/torch_provision.py": ("_run", "_run_stream"),
    "kernels/provision_scan.py": ("provision_scan_grid", "provision_scan_stream"),
    # FleetProvisioner.advance(): one committed chunk
    "serving/stepper.py": ("stepper_chunk",),
    # the engine's prefill and decode step
    "serving/engine.py": ("InferenceEngine._prefill", "InferenceEngine._decode"),
    "models/model_zoo.py": ("prefill_fn", "decode_fn"),
    "models/transformer.py": ("lm_prefill", "lm_decode_step"),
    "models/blocks.py": ("layer_prefill", "layer_decode"),
    "models/attention.py": ("prefill_attention", "decode_attention"),
    "models/layers.py": ("rms_norm", "embed_tokens", "unembed", "apply_rope", "mlp"),
    "kernels/ops.py": ("flash_attention", "decode_attention"),
    "kernels/flash_attention.py": ("flash_attention", "_launch"),
    "kernels/decode_attention.py": ("decode_attention", "_launch"),
    # the hybrid, MoE and xLSTM families' layers
    "models/ssm.py": ("ssm_prefill", "ssm_decode"),
    "models/moe.py": ("moe_layer",),
    "models/xlstm.py": ("mlstm_train", "mlstm_decode", "slstm_train", "slstm_decode"),
    # a sharded step's sequence-parallel boundaries (phase 19)
    "distributed/ctx.py": ("gather_sequence", "onto_sequence", "last_position"),
}

#: Parameter names that carry host values on the launch path (configs,
#: flags, python ints and floats), reviewed as the reference reviews its
#: static argument names; every other parameter of a region is taken to
#: carry tensors.  ``"<module>:<name>"`` scopes a name to one module (below
#: ``repro_torch/``) where the same name carries a tensor elsewhere.  A
#: parameter is also host when its annotation names only
#: :data:`HOST_TYPES`, or when it defaults to a number, bool or string.
HOST_PARAMS = frozenset({
    # model and call configuration
    "cfg", "kernel", "flag", "causal", "window", "scale", "block_q", "block_k",
    "cd", "compute_dtype", "dtype", "device", "dev", "act", "eps", "theta", "softcap",
    # host positions, sizes and counts
    "cur_len", "t0", "n_levels", "max_h", "horizon", "base_level", "t_chunk",
    "B", "S", "T", "G", "N",
    # engine identity: the policy, the window sweep (python ints), the outputs
    "policy", "windows", "record", "codes",
    # the kernels' peek bound: an int there (the engine's delta is a tensor)
    "kernels/provision_scan.py:delta",
})

#: annotations that mark a parameter as a host value
HOST_TYPES = frozenset({
    "int", "float", "bool", "str", "None", "Optional", "ModelConfig", "ShapeCell",
    "torch.dtype", "torch.device", "dtype", "device",
})


def _annotation_is_host(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    names = {t for t in re.split(r"[\s|\[\],]+", text) if t}
    return bool(names) and names <= HOST_TYPES


def _host_param_names(ctx: ModuleContext) -> frozenset[str]:
    """:data:`HOST_PARAMS` as it applies in ``ctx``'s module."""
    out = set()
    for entry in HOST_PARAMS:
        module, _, name = entry.rpartition(":")
        if not module or ctx.in_module(module):
            out.add(name)
    return frozenset(out)


def _host_params(fn: ast.AST, host_names: frozenset[str]) -> set[str]:
    """The parameters of ``fn`` and its nested defs that carry host values."""
    host: set[str] = {"self", "cls"}
    for node in ast.walk(fn):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        a = node.args
        positional = a.posonlyargs + a.args
        defaults: list[ast.expr | None] = (
            [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
        )
        pairs = list(zip(positional, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
        for arg, default in pairs:
            if (
                arg.arg in host_names
                or _annotation_is_host(arg.annotation)
                or (isinstance(default, ast.Constant)
                    and isinstance(default.value, (bool, int, float, str)))
            ):
                host.add(arg.arg)
    return host


def _param_names(fn: ast.AST) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            a = node.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                names.add(arg.arg)
            if a.vararg:
                names.add(a.vararg.arg)
            if a.kwarg:
                names.add(a.kwarg.arg)
    return names


def _where(region: LaunchRegion) -> str:
    if region.qualname == region.entry:
        return f"launch-path function `{region.qualname}`"
    return f"`{region.qualname}` (on the launch path from `{region.entry}`)"


# ---------------------------------------------------------------------------
# RPT001 — randomness without an explicit generator
# ---------------------------------------------------------------------------

#: torch samplers: module functions (``torch.<name>``) ...
_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial",
    "poisson", "rand_like", "randn_like", "randint_like",
})
#: ... and in-place tensor methods
_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "exponential_", "random_", "bernoulli_", "cauchy_",
    "geometric_", "log_normal_",
})


def _generator_arg(call: ast.Call) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == "generator":
            return kw.value
    return None


def _sampler_name(call: ast.Call, ctx: ModuleContext) -> str | None:
    dotted = ctx.dotted(call.func)
    if dotted is not None and dotted.startswith("torch."):
        name = dotted.rpartition(".")[2]
        if name in _SAMPLERS and dotted.count(".") == 1:
            return dotted
        return None
    if isinstance(call.func, ast.Attribute) and call.func.attr in _INPLACE_SAMPLERS:
        return f".{call.func.attr}"
    return None


def _expr_id(node: ast.AST | None) -> str | None:
    """A stable identifier for a generator expression: a name or a dotted
    chain of names; anything else is not tracked."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _generator_events(stmt: ast.AST, ctx: ModuleContext) -> list[tuple]:
    """(line, col, kind, ident, seed) events of one statement in source
    order: 'draw' (a sampler reads the generator), 'seed' (``g.manual_seed
    (expr)`` as its own statement), 'assign' (the name is rebound)."""
    events: list[tuple] = []
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call):
            if _sampler_name(node, ctx) is not None:
                ident = _expr_id(_generator_arg(node))
                if ident is not None:
                    events.append((node.lineno, node.col_offset, "draw", ident, None))
            elif (isinstance(node.func, ast.Attribute) and node.func.attr == "manual_seed"
                  and node.args and isinstance(stmt, ast.Expr) and stmt.value is node):
                ident = _expr_id(node.func.value)
                if ident is not None:
                    events.append((node.lineno, node.col_offset, "seed", ident,
                                   ast.unparse(node.args[0])))
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
            targets = list(node.targets) if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                for leaf in ast.walk(tgt):
                    ident = _expr_id(leaf)
                    if ident is not None and isinstance(leaf, (ast.Name, ast.Attribute)):
                        events.append((leaf.lineno, leaf.col_offset, "assign", ident, None))
    return sorted(events, key=lambda e: (e[0], e[1]))


#: per generator: (the seed expression of its last seeding or None, draws since)
_GenState = dict[str, tuple[str | None, int]]


def _scan_generator_block(stmts, state: _GenState, ctx, out) -> _GenState:
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            _scan_generator_block(list(stmt.body), {}, ctx, out)
            continue
        if isinstance(stmt, ast.If):
            _apply_generator_events(_generator_events(stmt.test, ctx), state, out)
            state = _merge_generator_states([
                _scan_generator_block(list(stmt.body), dict(state), ctx, out),
                _scan_generator_block(list(stmt.orelse), dict(state), ctx, out),
            ])
            continue
        if isinstance(stmt, ast.Try):
            state = _merge_generator_states([
                _scan_generator_block(list(b), dict(state), ctx, out)
                for b in [stmt.body] + [h.body for h in stmt.handlers]
            ])
            state = _scan_generator_block(list(stmt.finalbody), state, ctx, out)
            continue
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While, ast.With, ast.AsyncWith)):
            header = [getattr(stmt, "iter", None), getattr(stmt, "test", None),
                      getattr(stmt, "target", None)]
            for part in header:
                if part is not None:
                    _apply_generator_events(_generator_events(part, ctx), state, out)
            for item in getattr(stmt, "items", []):
                _apply_generator_events(_generator_events(item, ctx), state, out)
            state = _scan_generator_block(list(stmt.body), state, ctx, out)
            state = _scan_generator_block(list(getattr(stmt, "orelse", [])), state, ctx, out)
            continue
        _apply_generator_events(_generator_events(stmt, ctx), state, out)
    return state


def _merge_generator_states(states: list[_GenState]) -> _GenState:
    merged: _GenState = {}
    for st in states:
        for k, (seed, draws) in st.items():
            old = merged.get(k)
            if old is None or draws > old[1]:
                merged[k] = (seed, draws)
    return merged


def _apply_generator_events(events, state: _GenState, out: list[RawFinding]) -> None:
    for line, col, kind, ident, seed in events:
        if kind == "assign":
            state.pop(ident, None)
        elif kind == "draw":
            last, draws = state.get(ident, (None, 0))
            state[ident] = (last, draws + 1)
        else:  # seed
            last, draws = state.get(ident, (None, 0))
            if last is not None and last == seed and draws > 0:
                out.append((
                    line, col,
                    f"generator `{ident}` re-seeded with the same seed `{seed}` after a "
                    "draw — its next draw repeats the earlier one (give each draw its "
                    "own generator or seed)",
                ))
            state[ident] = (seed, 0)


def check_rpt001(ctx: ModuleContext) -> Iterator[RawFinding]:
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _sampler_name(node, ctx)
        if name is not None and _generator_arg(node) is None and not any(
                kw.arg is None for kw in node.keywords):
            yield (
                node.lineno, node.col_offset,
                f"`{name}` draws from the global generator — pass an explicit "
                "`generator=` (a seeded torch.Generator), so that the draw is "
                "reproducible and can be injected",
            )
    out: list[RawFinding] = []
    _scan_generator_block(list(ctx.tree.body), {}, ctx, out)
    yield from out


# ---------------------------------------------------------------------------
# RPT002 — host syncs on the launch path
# ---------------------------------------------------------------------------

#: tensor attributes that are host metadata (no sync to read them)
_META_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "is_meta", "is_sparse", "layout",
    "requires_grad", "is_leaf", "grad_fn", "names", "placements", "device_mesh",
})
#: tensor methods that return host metadata
_META_METHODS = frozenset({
    "size", "dim", "numel", "nelement", "stride", "storage_offset", "element_size",
    "is_floating_point", "is_complex", "is_contiguous", "data_ptr", "get_device",
    "is_shard", "is_replicate", "is_partial", "keys",
})
#: builtins whose result never reads a tensor's values
_HOST_BUILTINS = frozenset({"len", "isinstance", "type", "id", "hasattr", "callable"})
#: calls that copy a tensor to the host (and wait for the card)
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
_CASTS = frozenset({"int", "float", "bool"})


#: builtins whose result is built from their arguments' values
_VALUE_BUILTINS = frozenset({
    "min", "max", "abs", "sum", "any", "all", "round", "divmod", "pow", "sorted",
    "list", "tuple", "zip", "enumerate", "map", "iter", "next", "reversed", "dict",
    "set", "int", "float", "bool",
})


@dataclasses.dataclass
class _Taint:
    """What RPT002 knows in one region: the tainted names, the module."""

    ctx: ModuleContext
    names: set[str]
    host_fns: set[str]


def _host_result_call(node: ast.Call, env: _Taint) -> bool:
    """A call whose result is a host value whatever its arguments: a
    builtin of :data:`_HOST_BUILTINS`, a metadata method, a predicate named
    ``is_*``/``has_*``, a function of the module annotated to return a host
    type, or a C entry point of a kernel library (``lib.repro_*``, which
    returns a status)."""
    f = node.func
    name = f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None
    if name is None:
        return False
    if isinstance(f, ast.Name) and (name in _HOST_BUILTINS or name in env.host_fns):
        return True
    if isinstance(f, ast.Attribute) and name in _META_METHODS:
        return True
    return name.startswith(("is_", "has_")) or (
        isinstance(f, ast.Attribute) and name.startswith("repro_"))


def _opaque_call(node: ast.Call, env: _Taint) -> bool:
    """A call this flow-light pass does not look into: a function that is
    neither torch's, nor a builtin that computes on its arguments' values,
    nor a method of a tainted value (the port's helpers, a kernel wrapper,
    a constructor).  What it returns is not taken as tainted."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id not in _VALUE_BUILTINS and not (
            env.ctx.dotted(f) or "").startswith("torch.")
    if isinstance(f, ast.Attribute):
        if (env.ctx.dotted(f) or "").startswith("torch."):
            return False
        base = f.value
        while isinstance(base, (ast.Attribute, ast.Subscript, ast.Call)):
            base = base.func if isinstance(base, ast.Call) else base.value
        return not (isinstance(base, ast.Name) and base.id in env.names)
    return False


def _host_returning_functions(ctx: ModuleContext) -> set[str]:
    out: set[str] = set()
    for node in ctx.tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and _annotation_is_host(node.returns)):
            out.add(node.name)
    return out


_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)


def _exempt_leaves(expr: ast.AST, env: _Taint, casts: bool) -> set[int]:
    exempt: set[int] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            exempt.update(id(leaf) for leaf in ast.walk(node.value))
        elif isinstance(node, ast.Call):
            if _host_result_call(node, env) or _opaque_call(node, env):
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    exempt.update(id(leaf) for leaf in ast.walk(arg))
                if _host_result_call(node, env) and isinstance(node.func, ast.Attribute):
                    exempt.update(id(leaf) for leaf in ast.walk(node.func.value))
            elif casts and isinstance(node.func, ast.Name) and node.func.id in _CASTS:
                # reported as the cast itself
                exempt.update(id(leaf) for leaf in ast.walk(node))
        elif isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops
        ):
            for sub in [node.left] + list(node.comparators):
                exempt.update(id(leaf) for leaf in ast.walk(sub))
        elif isinstance(node, _COMPREHENSIONS):
            # `[t.data_ptr() for t in ts]`: the loop reads only metadata of
            # each element, so the iterable is not read as a value
            targets = {leaf.id for gen in node.generators for leaf in ast.walk(gen.target)
                       if isinstance(leaf, ast.Name)}
            parts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                     else [node.elt]) + [c for gen in node.generators for c in gen.ifs]
            inner = _Taint(env.ctx, set(targets), env.host_fns)
            if not any(_tainted_uses(part, inner) for part in parts):
                for gen in node.generators:
                    exempt.update(id(leaf) for leaf in ast.walk(gen.iter))
    return exempt


def _tainted_uses(expr: ast.AST, env: _Taint, casts: bool = False) -> list[tuple[int, int, str]]:
    """Name nodes in ``expr`` that read a tainted binding as a value —
    excluding metadata (``.shape``, ``.numel()``, ...), host builtins and
    predicates, the arguments of calls not looked into, and ``is``/``in``
    tests."""
    exempt = _exempt_leaves(expr, env, casts)
    return [
        (node.lineno, node.col_offset, node.id)
        for node in ast.walk(expr)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
        and node.id in env.names and id(node) not in exempt
    ]


def check_rpt002(ctx: ModuleContext) -> Iterator[RawFinding]:
    host_fns = _host_returning_functions(ctx)
    host_names = _host_param_names(ctx)
    for region in ctx.launch_regions:
        where = _where(region)
        env = _Taint(ctx, _param_names(region.node) - _host_params(region.node, host_names),
                     host_fns)
        stmts = sorted(
            (n for n in ast.walk(region.node) if isinstance(n, ast.stmt)),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for stmt in stmts:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and stmt.value:
                rhs = bool(_tainted_uses(stmt.value, env))
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                for tgt in targets:
                    for leaf in ast.walk(tgt):
                        if isinstance(leaf, ast.Name):
                            if rhs:
                                env.names.add(leaf.id)
                            elif not isinstance(stmt, ast.AugAssign):
                                env.names.discard(leaf.id)
            test, label = None, None
            if isinstance(stmt, (ast.If, ast.While)):
                test, label = stmt.test, type(stmt).__name__.lower()
            elif isinstance(stmt, ast.Assert):
                test, label = stmt.test, "assert"
            if test is not None:
                for line, col, name in _tainted_uses(test, env, casts=True):
                    yield (
                        line, col,
                        f"host `{label}` on `{name}`, a tensor value, in {where} — "
                        "reading it waits for the card (a host sync in a step); keep "
                        "the branch on the device (torch.where) or on host metadata",
                    )
        for node in ast.walk(region.node):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                yield (
                    node.lineno, node.col_offset,
                    f"`.{f.attr}()` in {where} copies a tensor to the host and waits "
                    "for the card — a host sync in a step",
                )
            elif ctx.dotted(f) in _SYNC_CALLS:
                yield (
                    node.lineno, node.col_offset,
                    f"`torch.cuda.synchronize()` in {where} stalls the host on the "
                    "card — a host sync in a step",
                )
            elif isinstance(f, ast.Name) and f.id in _CASTS and node.args:
                uses = _tainted_uses(node.args[0], env)
                if uses:
                    yield (
                        node.lineno, node.col_offset,
                        f"`{f.id}()` of `{uses[0][2]}`, a tensor value, in {where} reads "
                        "it on the host — a host sync in a step",
                    )


# ---------------------------------------------------------------------------
# RPT003 — one builder, and no fast math
# ---------------------------------------------------------------------------

_BUILDER = "kernels/_build.py"
_FAST_FLAG_RE = re.compile(
    r"fast[_-]math|-ftz=true|-prec-div=false|-prec-sqrt=false", re.IGNORECASE)
_FAST_INTRINSICS_RE = re.compile(
    r"\b(__expf|__exp10f|__logf|__log2f|__log10f|__powf|__fdividef|__sinf|__cosf"
    r"|__tanf|__sincosf)\b")
_SUBPROCESS_CALLS = frozenset({
    "subprocess.run", "subprocess.Popen", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "os.system", "os.popen",
})
_FLAG_KEYWORDS = frozenset({"extra_cuda_cflags", "extra_cflags", "extra_ldflags"})


def _strings(node: ast.AST) -> Iterator[str]:
    for leaf in ast.walk(node):
        if isinstance(leaf, ast.Constant) and isinstance(leaf.value, str):
            yield leaf.value


def _runs_nvcc(call: ast.Call) -> bool:
    if not call.args:
        return False
    first = call.args[0]
    for s in _strings(first):
        word = s.strip().split(" ")[0] if isinstance(first, ast.Constant) else s
        if word.rsplit("/", 1)[-1] == "nvcc":
            return True
    return False


def _fast_flags(node: ast.AST) -> list[str]:
    return [s for s in _strings(node) if _FAST_FLAG_RE.search(s)]


def check_rpt003(ctx: ModuleContext) -> Iterator[RawFinding]:
    builder = ctx.in_module(_BUILDER)
    for node in ctx.nodes:
        if isinstance(node, ast.Call):
            dotted = ctx.dotted(node.func) or ""
            if not builder and dotted.startswith("torch.utils.cpp_extension.load"):
                yield (
                    node.lineno, node.col_offset,
                    f"`{dotted}` outside {_BUILDER} — the kernels are built in one "
                    "place, whose builds repro_torch.obs.CompileWatcher counts; call "
                    "its loaders (load_provision_scan, load_attention) instead",
                )
            elif not builder and dotted in _SUBPROCESS_CALLS and _runs_nvcc(node):
                yield (
                    node.lineno, node.col_offset,
                    f"an nvcc subprocess outside {_BUILDER} — a build nothing counts; "
                    "the kernels are built by its loaders only",
                )
            for kw in node.keywords:
                if kw.arg in _FLAG_KEYWORDS:
                    for flag in _fast_flags(kw.value):
                        yield (
                            kw.value.lineno, kw.value.col_offset,
                            f"fast-math flag `{flag}` in `{kw.arg}` — the kernels are "
                            "held to the reference's float32 tolerance, which fast math "
                            "breaks",
                        )
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) and node.value:
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(_expr_id(t) is not None and _expr_id(t).rpartition(".")[2] == "CUDA_FLAGS"
                   for t in targets):
                for flag in _fast_flags(node.value):
                    yield (
                        node.lineno, node.col_offset,
                        f"fast-math flag `{flag}` in CUDA_FLAGS — the kernels are held "
                        "to the reference's float32 tolerance (2e-5), which fast math "
                        "breaks",
                    )
        elif (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
              and isinstance(node.value.func, ast.Attribute)
              and node.value.func.attr in ("append", "extend", "insert")
              and (_expr_id(node.value.func.value) or "").rpartition(".")[2] == "CUDA_FLAGS"):
            for flag in _fast_flags(node.value):
                yield (
                    node.lineno, node.col_offset,
                    f"fast-math flag `{flag}` added to CUDA_FLAGS — the kernels are held "
                    "to the reference's float32 tolerance (2e-5), which fast math breaks",
                )


def check_rpt003_cuda(ctx: CudaContext) -> Iterator[RawFinding]:
    for i, line in enumerate(ctx.code_lines, start=1):
        for m in _FAST_INTRINSICS_RE.finditer(line):
            yield (
                i, m.start(),
                f"fast-math intrinsic `{m.group(1)}` — the kernels are held to the "
                "reference's float32 tolerance (2e-5); use the accurate function "
                f"(`{m.group(1)[2:]}`)",
            )


# ---------------------------------------------------------------------------
# RPT004 — host library calls on the launch path
# ---------------------------------------------------------------------------

#: numpy attributes that are dtype metadata, not host arrays
_NP_OK = frozenset({
    "float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
    "uint16", "uint32", "uint64", "bool_", "dtype", "iinfo", "finfo",
    "promote_types", "result_type",
})


def check_rpt004(ctx: ModuleContext) -> Iterator[RawFinding]:
    for region in ctx.launch_regions:
        where = _where(region)
        for node in ast.walk(region.node):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.dotted(node.func)
            if dotted is None:
                continue
            msg = None
            if dotted.startswith("numpy."):
                attr = dotted.removeprefix("numpy.")
                if attr.split(".")[0] not in _NP_OK:
                    msg = (f"numpy call `{attr}` in {where} runs on the host — keep a "
                           "step's arithmetic in torch on the step's device")
            elif dotted.startswith(("time.", "datetime.")):
                msg = (f"host clock call `{dotted}` in {where} — time a step from "
                       "outside it (repro_torch.obs spans), not inside")
            elif dotted.startswith("random."):
                msg = (f"stdlib `{dotted}` in {where} draws host randomness — draw "
                       "from an explicit torch.Generator, or take the draws injected")
            if msg is not None:
                yield (node.lineno, node.col_offset, msg)


# ---------------------------------------------------------------------------
# RPT005 — tensor factories without a device on the launch path
# ---------------------------------------------------------------------------

_FACTORIES = frozenset({"zeros", "ones", "empty", "full", "arange", "tensor"})


def check_rpt005(ctx: ModuleContext) -> Iterator[RawFinding]:
    for region in ctx.launch_regions:
        where = _where(region)
        for node in ast.walk(region.node):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.dotted(node.func) or ""
            name = dotted.removeprefix("torch.")
            if dotted.startswith("torch.") and name in _FACTORIES and not any(
                kw.arg in ("device", None) for kw in node.keywords
            ):
                yield (
                    node.lineno, node.col_offset,
                    f"`{dotted}` without `device=` in {where} makes a CPU tensor in a "
                    "step — pass the step's device (or use the *_like form)",
                )


# ---------------------------------------------------------------------------
# RPT006 — one owner per counter
# ---------------------------------------------------------------------------

#: counter attribute -> (owning module below repro_torch/, the dotted module
#: path it must resolve to when the name alone is ambiguous, or None)
COUNTERS: dict[str, tuple[str, str | None]] = {
    "flash_launches": ("kernels/flash_attention.py", None),
    "decode_launches": ("kernels/decode_attention.py", None),
    "stream_launches": ("kernels/provision_scan.py", None),
    "launches": ("kernels/provision_scan.py", "provision_scan"),
    "builds": ("kernels/_build.py", "_build"),
}


def _counter_target(node: ast.AST, ctx: ModuleContext) -> str | None:
    """The counter a write target names, or None: ``mod.counter`` (or
    ``mod.builds[...]``) resolved through the imports."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if not isinstance(node, ast.Attribute) or node.attr not in COUNTERS:
        return None
    owner_mod = COUNTERS[node.attr][1]
    if owner_mod is None:
        return node.attr
    base = ctx.dotted(node.value)
    if base is not None and base.rpartition(".")[2] == owner_mod:
        return node.attr
    return None


def check_rpt006(ctx: ModuleContext) -> Iterator[RawFinding]:
    for node in ctx.nodes:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets, value = [node.target], None
        elif isinstance(node, ast.Delete):
            targets, value = node.targets, None
        else:
            continue
        reset = (isinstance(value, ast.Constant) and value.value == 0
                 and not isinstance(value.value, bool))
        seen: set[int] = set()
        for tgt in targets:
            for leaf in ast.walk(tgt):
                counter = _counter_target(leaf, ctx)
                if counter is None or id(leaf) in seen:
                    continue
                if isinstance(leaf, ast.Subscript):
                    seen.add(id(leaf.value))
                owner = COUNTERS[counter][0]
                if ctx.in_module(owner) or (reset and not isinstance(leaf, ast.Subscript)):
                    continue
                yield (
                    leaf.lineno, leaf.col_offset,
                    f"write to `{counter}` outside {owner}, which owns it — a counter "
                    "has one writer (the wrapper that launches, or the builder); read "
                    "it, reset it to 0, or go through repro_torch.obs.CompileWatcher",
                )


# ---------------------------------------------------------------------------
# RPT007 — no fallback on a kernel route
# ---------------------------------------------------------------------------

#: calls that put a ``try`` body on a kernel route
KERNEL_CALLS = frozenset({
    "_launch", "flash_attention", "decode_attention", "provision_scan_grid",
    "provision_scan_stream", "provision_scan", "load_attention", "load_provision_scan",
    "_compile", "stepper_chunk",
})


def _call_name(call: ast.Call) -> str | None:
    f = call.func
    return f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None


def _kernel_kw(call: ast.Call, value: bool) -> bool:
    return any(kw.arg == "kernel" and isinstance(kw.value, ast.Constant)
               and kw.value.value is value for kw in call.keywords)


def _on_kernel_route(body: list[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = _call_name(node) or ""
                if name in KERNEL_CALLS or name.startswith("repro_") or _kernel_kw(node, True):
                    return True
    return False


def check_rpt007(ctx: ModuleContext) -> Iterator[RawFinding]:
    for node in ctx.nodes:
        if not isinstance(node, ast.Try) or not _on_kernel_route(node.body):
            continue
        for handler in node.handlers:
            swallowed = all(
                isinstance(s, (ast.Pass, ast.Continue))
                or (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
                    and s.value.value is Ellipsis)
                for s in handler.body
            )
            plain = None
            for sub in handler.body:
                for call in ast.walk(sub):
                    if isinstance(call, ast.Call):
                        name = _call_name(call) or ""
                        if name.endswith(("_plain", "_ref")) or _kernel_kw(call, False):
                            plain = name
                            break
                if plain is not None:
                    break
            if swallowed:
                yield (
                    handler.lineno, handler.col_offset,
                    "`except` on a kernel route swallows the error — a failed launch or "
                    "build must raise, not pass silently",
                )
            elif plain is not None:
                yield (
                    handler.lineno, handler.col_offset,
                    f"`except` on a kernel route falls back to the plain version "
                    f"(`{plain}`) — routes split by device, never by failure: let the "
                    "kernel's error raise",
                )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

RULES: dict[str, Rule] = {
    r.id: r
    for r in (
        Rule("RPT001", "randomness without an explicit torch.Generator", check_rpt001),
        Rule("RPT002", "host sync on the launch path", check_rpt002),
        Rule("RPT003", "a build outside the builder, or fast math", check_rpt003,
             check_rpt003_cuda),
        Rule("RPT004", "host library calls on the launch path", check_rpt004),
        Rule("RPT005", "tensor factory without a device on the launch path",
             check_rpt005),
        Rule("RPT006", "counter written outside its owning module", check_rpt006),
        Rule("RPT007", "fallback from a kernel to its plain version", check_rpt007),
    )
}
