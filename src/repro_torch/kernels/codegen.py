"""K1: Triton kernel generation for fusion clusters.

Replaces ``repro/kernels/codegen.py:205`` ``_emit_cluster_impl``, which
emits one Pallas TPU kernel per cluster (``pallas_call`` at :392 for map
clusters, :407 for reduce clusters).  The partitioner
(``repro_torch.core.fusion``) hands this module legal clusters;
:func:`emit_cluster` turns each into a :class:`FusedKernel` with two
execution paths:

* the **torch oracle twin**: exactly the same primitive ``impl`` calls, in
  the same order, as the unfused lowering would emit — bitwise equal to
  the unfused program by construction.  A CPU tensor, or kernel mode
  ``"ref"`` / ``"chunked"``, runs it.
* the **generated Triton kernel** (one ``@triton.jit`` function per
  cluster) and its launch wrapper, for CUDA tensors.  A failed build or
  launch raises; nothing falls back to the oracle.

Clusters are bound by bytes: a few flops per element over tensors of
hundreds of megabytes (the LM's ``(B, S, V)`` clusters).  So the design
keeps every interior value in registers and reads each input once:

* **map clusters**: a 1-D grid over the body's ``N`` elements in blocks of
  ``BLOCK`` with a masked tail.  Every operand enters as a strided view at
  the body shape — broadcast members (``unreduce``, ``broadcast_to``) and
  smaller inputs are ``expand`` views with stride 0 on the broadcast axes,
  never materialised — and the kernel computes each operand's offset from
  the element's multi-index (or uses the flat index directly where the
  operand is contiguous, a ``constexpr`` flag per operand).
* **reduce clusters** (root ``reduce_sum`` / ``reduce_max`` /
  ``unbroadcast`` with static axes): the wrapper permutes every operand
  view so the kept axes come first; program ``(j, s)`` reduces split ``s``
  of output element ``j``'s reduced elements in ``BLOCK``-wide steps.  With
  more than one split the same kernel runs a second pass (``PASS=1``) that
  combines each output's partials in a fixed order: no atomics, so the
  result is deterministic.  Sums accumulate in f32 (int32 for integer
  bodies), as torch's do.

Each grid launch adds one to ``LAUNCHES["fused_<kind>"]`` and to the kernel's
entry in ``FUSED_LAUNCHES`` (the generated launcher calls ``_counted()``
after it), so a split reduction counts two launches a call.

Numerics follow torch's CUDA elementwise kernels, so f32 map clusters
match the oracle on the card bitwise or within an ulp: values are held in
the op-math type (f32 for floating types), each op's result is rounded to
its dtype (bf16/f16 results after every op), division is ``div_rn`` (and
a Python-scalar divisor multiplies by its f32 reciprocal, as torch does),
transcendentals go through libdevice, and the kernel is compiled with
``enable_fp_fusion=False`` so no ``a*b+c`` is contracted into an FMA the
oracle does not make.

The source is plain text, generated without importing ``triton``.  At the
first launch on a CUDA tensor it is written to
``build/repro_torch/triton/<hash>.py`` and imported (``@triton.jit`` reads
its function's source from the file); Triton's own cache goes to
``build/repro_torch/triton_cache`` unless ``TRITON_CACHE_DIR`` is set.  A
kernel of a program in the program cache (``FusedKernel.binary_dir``) keeps
its binary in the cache's ``triton`` directory instead, and reports how many
binaries its first launch built, so a warm process that finds them there
builds none.  :meth:`FusedKernel.payload` / :meth:`FusedKernel.from_payload`
are the kernel's durable form: its sources, metadata and environment.

``emit_cluster`` declines (returns None) exactly the clusters the
reference's generator declines, with the same ``DeclineReason`` kinds, so
the two packages' fusion plans are equal (a plan keeps only emitted
clusters).
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.dtypes import np_dtype, torch_dtype
from repro_torch.core.fusion import Cluster, DeclineReason, classify
from repro_torch.core.infer import AArray
from repro_torch.core.ir import Apply, Constant, Node
from repro_torch.core.lowering import _abstract_nbytes, _literal
from repro_torch.obs import profile as obs_profile
from .build import BUILD_DIR, FUSED_LAUNCHES, LAUNCHES
from .ops import get_kernel_mode

__all__ = ["FusedKernel", "emit_cluster", "emit_cluster_explained", "TRITON_DIR"]

#: where the generated kernel modules are written at first use
TRITON_DIR = BUILD_DIR / "triton"

#: elements per program of a map kernel, and per step of a reduce kernel
_MAP_BLOCK = 1024
_RED_BLOCK = 1024
#: programs a reduce kernel aims for (a few waves on 132 SMs)
_RED_PROGRAMS = 1024
#: most splits of one output's reduction (the second pass loads them at once)
_MAX_SPLITS = 1024

_counter = [0]


class FusedKernel:
    """One generated kernel: callable (dispatching by device and kernel
    mode), with the oracle and the Triton launcher exposed for testing."""

    __slots__ = (
        "name",
        "source",
        "oracle_source",
        "n_nodes",
        "kind",
        "body_shape",
        "out_shape",
        "bytes_moved",
        "oracle",
        "launches_per_call",
        "binary_dir",
        "on_build",
        "_env",
        "_launch",
    )

    def __init__(
        self,
        name: str,
        source: str,
        n_nodes: int,
        kind: str,
        body_shape: tuple,
        out_shape: tuple,
        oracle: Callable,
        env: dict,
        bytes_moved: int = 0,
        launches_per_call: int = 1,
        oracle_source: str = "",
    ) -> None:
        self.name = name
        self.source = source
        self.n_nodes = n_nodes
        self.kind = kind
        self.body_shape = body_shape
        self.out_shape = out_shape
        #: least device-memory traffic per launch (cluster inputs read once,
        #: the root written once, from the inferred abstracts)
        self.bytes_moved = bytes_moved
        self.oracle = oracle
        #: device launches of one call: 1, or 2 for a reduction split over
        #: programs (its partials are combined by a second pass)
        self.launches_per_call = launches_per_call
        #: the oracle's own source (``source`` ends with it, after the kernel)
        self.oracle_source = oracle_source
        #: where Triton keeps this kernel's binary (its cache directory), or
        #: None for ``TRITON_CACHE_DIR`` / ``build/repro_torch/triton_cache``;
        #: a program cache points its programs' kernels at its own directory
        self.binary_dir: str | None = None
        #: called with the number of binaries Triton built (not found in its
        #: cache) at this kernel's first launch: the program cache's counter
        self.on_build: Callable[[int], None] | None = None
        self._env = env
        self._launch: Callable | None = None

    def __call__(self, *args: Any) -> Any:
        fn = (self.oracle if get_kernel_mode() in ("ref", "chunked") or not _on_cuda(args)
              else self.triton)
        # runtime profiler hook: disarmed this is one module-global read; armed,
        # the launch is timed on the card (CUDA events) and attributed per kernel
        prof = obs_profile._ACTIVE
        if prof is None:
            return fn(*args)
        out, dur = obs_profile.timed(fn, *args)
        prof.record(self.name, "fused", dur, self.bytes_moved)
        return out

    def triton(self, *args: Any) -> Any:
        """Launch the generated Triton kernel (CUDA tensors only).  The first
        launch is where Triton builds the binary, or loads it from its cache."""
        if self._launch is None:
            launch = _load(self.name, self.kind, self.source, self._env)
            out = _first_launch(launch, args, self.binary_dir, self.on_build)
            self._launch = launch
            return out
        return self._launch(*args)

    # -- the durable form (the program cache's executable tier) ---------------
    def payload(self, prims: dict[int, str] | None = None) -> dict:
        """Everything needed to rebuild this kernel without the cluster: its
        generated sources, its metadata and its environment."""
        from repro_torch.core.lowering import encode_env

        return {
            "name": self.name, "source": self.source, "oracle_source": self.oracle_source,
            "n_nodes": self.n_nodes, "kind": self.kind,
            "body_shape": list(self.body_shape), "out_shape": list(self.out_shape),
            "bytes_moved": self.bytes_moved, "launches_per_call": self.launches_per_call,
            "env": encode_env(self._env, prims),
        }

    @classmethod
    def from_payload(cls, p: dict) -> "FusedKernel":
        from repro_torch.core.lowering import decode_env

        env = decode_env(p["env"])
        namespace = dict(env)
        exec(compile(p["oracle_source"], f"<myia-fused-oracle:{p['name']}>", "exec"),
             namespace)
        oracle = namespace["_oracle"]
        oracle.__fused_source__ = p["source"]
        return cls(
            name=p["name"], source=p["source"], n_nodes=p["n_nodes"], kind=p["kind"],
            body_shape=tuple(p["body_shape"]), out_shape=tuple(p["out_shape"]),
            oracle=oracle, env=env, bytes_moved=p["bytes_moved"],
            launches_per_call=p["launches_per_call"], oracle_source=p["oracle_source"],
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<FusedKernel {self.name} {self.kind} n={self.n_nodes}>"


def _on_cuda(args: tuple) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args)


def _count_launch(name: str, kind: str) -> None:
    """Called by a generated launcher right after each grid launch."""
    LAUNCHES["fused_" + kind] += 1
    FUSED_LAUNCHES[name] = FUSED_LAUNCHES.get(name, 0) + 1


def _load(name: str, kind: str, source: str, env: dict) -> Callable:
    """Write the kernel module, import it (this is where ``triton`` is first
    imported) and bind the wrapper's environment and launch counter; returns
    the launcher."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton_cache"))
    TRITON_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    path = TRITON_DIR / f"{name}_{digest}.py"
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(f"repro_torch_fused_{name}_{digest}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.__dict__.update(env)
    mod._counted = lambda: _count_launch(name, kind)
    return mod._launch


def _cubins(root: str) -> int:
    n = 0
    for _dirpath, _dirs, files in os.walk(root):
        n += sum(f.endswith(".cubin") for f in files)
    return n


def _first_launch(launch: Callable, args: tuple, binary_dir: str | None,
                  on_build: Callable[[int], None] | None) -> Any:
    """The kernel's first launch, where Triton compiles it or finds its binary
    in its cache.  With ``binary_dir`` set, Triton's cache is that directory
    for the extent of the launch, and ``on_build`` receives how many binaries
    (``.cubin`` files) the launch added to it: 0 when the binary was found."""
    if binary_dir is None:
        return launch(*args)
    os.makedirs(binary_dir, exist_ok=True)
    before = _cubins(binary_dir)
    prev = os.environ.get("TRITON_CACHE_DIR")
    os.environ["TRITON_CACHE_DIR"] = binary_dir
    try:
        out = launch(*args)
    finally:
        if prev is None:
            del os.environ["TRITON_CACHE_DIR"]
        else:
            os.environ["TRITON_CACHE_DIR"] = prev
    if on_build is not None:
        on_build(_cubins(binary_dir) - before)
    return out


# ---------------------------------------------------------------------------
# Static helpers (the source literals and byte counts are lowering's)
# ---------------------------------------------------------------------------


def _const_shape(value: Any) -> tuple | None:
    try:
        return tuple(int(d) for d in np.shape(value))
    except Exception:
        return None


def _cluster_bytes(cluster: Cluster) -> int:
    """Least device-memory traffic of one launch: every external input read
    once plus the root output written once (interior values in registers)."""
    total = sum(_abstract_nbytes(n.abstract) for n in cluster.inputs)
    return total + _abstract_nbytes(cluster.root.abstract)


# ---------------------------------------------------------------------------
# Types inside the kernel
# ---------------------------------------------------------------------------

_TL = {
    "float32": "tl.float32", "float16": "tl.float16", "bfloat16": "tl.bfloat16",
    "int32": "tl.int32", "int16": "tl.int16", "int8": "tl.int8", "uint8": "tl.uint8",
    "bool": "tl.int1",
}


def _tl(dt: Any) -> str:
    """The Triton type a value of IR dtype ``dt`` is stored in."""
    name = np.dtype(dt).name
    if name not in _TL:
        raise NotImplementedError(f"fused kernels do not take dtype {name}")
    return _TL[name]


def _is_float(dt: Any) -> bool:
    return np.dtype(dt).kind == "f" or np.dtype(dt).name == "bfloat16"


def _opmath(dt: Any) -> str:
    """The type torch's CUDA kernels compute a ``dt`` op in."""
    if _is_float(dt):
        return "tl.float32"
    if np.dtype(dt).name == "bool":
        return "tl.int1"
    return "tl.int32"


class _Val:
    """A value in the kernel body: its source expression and IR dtype, or a
    Python literal (typed weakly, as torch types a Python scalar)."""

    __slots__ = ("expr", "dtype", "literal", "zero_dim")

    def __init__(self, expr: str, dtype: Any = None, literal: Any = None,
                 zero_dim: bool = False) -> None:
        self.expr = expr
        self.dtype = None if dtype is None else np.dtype(dtype)
        self.literal = literal
        self.zero_dim = zero_dim

    @property
    def is_literal(self) -> bool:
        return self.dtype is None


def _standin(v: _Val) -> Any:
    if v.is_literal:
        return v.literal
    shape = () if v.zero_dim else (1,)
    return torch.empty(shape, dtype=torch_dtype(v.dtype), device="meta")


def _common(a: _Val, b: _Val) -> np.dtype:
    """torch's result type of a binary op on ``a`` and ``b`` (a Python scalar
    is weak, a 0-d tensor ranks below a dimensioned one of its category)."""
    return np_dtype(torch.result_type(_standin(a), _standin(b)))


def _float_lit(x: Any) -> str:
    x = float(np.float32(x))
    return repr(x) if math.isfinite(x) else f"float('{x}')"


def _as(v: _Val, common: Any) -> str:
    """``v`` as an operand of an op computed in ``common``'s op-math type:
    a tensor operand is first converted to ``common`` (torch's iterator
    casts inputs to the common dtype), a Python scalar enters in op-math."""
    om = _opmath(common)
    if v.is_literal:
        lit = v.literal
        if om == "tl.int1":
            return "True" if lit else "False"
        if om == "tl.float32":
            return _float_lit(lit)
        return repr(int(lit))
    if v.dtype == np.dtype(common):
        return v.expr
    if np.dtype(common).name == "bool":
        return f"({v.expr} != 0)"
    if _opmath(v.dtype) != om or _tl(v.dtype) != _tl(common):
        if _tl(common) != om:  # round through the narrow common type first
            return f"{v.expr}.to({_tl(common)}).to({om})"
        return f"{v.expr}.to({om})"
    return v.expr


def _round(expr: str, dt: Any) -> str:
    """Round an op-math result to the node's dtype (bf16/f16 after every op)."""
    if _tl(dt) != _opmath(dt):
        return f"({expr}).to({_tl(dt)}).to({_opmath(dt)})"
    return expr


_LIBDEVICE_UNARY = {"exp": "exp", "log": "log", "tanh": "tanh", "sin": "sin", "cos": "cos",
                    "erf": "erf", "rsqrt": "rsqrt"}
_CMP = {"lt": "<", "gt": ">", "le": "<=", "ge": ">=", "eq": "==", "ne": "!="}


def _pow_scalar(x: str, e: float) -> str:
    """torch's ``pow(tensor, scalar)`` special cases, then libdevice pow."""
    if e == 2:
        return f"({x} * {x})"
    if e == 3:
        return f"({x} * {x} * {x})"
    if e == 0.5:
        return f"tl.sqrt_rn({x})"
    if e == -0.5:
        return f"libdevice.rsqrt({x})"
    if e == -1:
        return f"tl.math.div_rn(1.0, {x})"
    if e == -2:
        return f"tl.math.div_rn(1.0, {x} * {x})"
    return f"libdevice.pow({x}, {_float_lit(e)})"


def _render(prim: str, args: list[_Val], out_dt: Any) -> str:
    """The Triton expression of one elementwise member, in op-math, rounded
    to ``out_dt``.  Every name of ``fusion.ELEMENTWISE`` has a rendering."""
    fl = _is_float(out_dt)
    if prim in _CMP:
        c = _common(args[0], args[1])
        return f"({_as(args[0], c)} {_CMP[prim]} {_as(args[1], c)})"
    if prim in ("bool_and", "bool_or"):
        op = "&" if prim == "bool_and" else "|"
        a, b = (_as(v, np.dtype(bool)) for v in args)
        return f"({a} {op} {b})"
    if prim == "bool_not":
        return f"({_as(args[0], np.dtype(bool))} == 0)"
    if prim == "cast":
        v = args[0]
        if v.is_literal:
            return _as(v, out_dt)
        if np.dtype(out_dt).name == "bool":
            return f"({v.expr} != 0)"
        return _round(f"{v.expr}.to({_opmath(out_dt)})", out_dt)
    if prim == "where":
        c = _as(args[0], np.dtype(bool))
        a, b = _as(args[1], out_dt), _as(args[2], out_dt)
        return _round(f"tl.where({c}, {a}, {b})", out_dt)
    xs = [_as(v, out_dt) for v in args]
    x = xs[0]
    if prim == "add":
        e = f"{xs[0]} + {xs[1]}"
    elif prim == "sub":
        e = f"{xs[0]} - {xs[1]}"
    elif prim == "mul":
        e = f"{xs[0]} * {xs[1]}"
    elif prim == "div":
        if not fl:
            raise NotImplementedError("integer division in a fused kernel")
        if args[1].is_literal:  # torch multiplies by the scalar's f32 reciprocal
            inv = np.float32(1.0) / np.float32(args[1].literal)
            e = f"{xs[0]} * {_float_lit(inv)}"
        elif args[0].is_literal:  # scalar / x is reciprocal(x) * scalar
            e = f"tl.math.div_rn(1.0, {xs[1]}) * {xs[0]}"
        else:
            e = f"tl.math.div_rn({xs[0]}, {xs[1]})"
    elif prim == "power":
        if not fl:
            raise NotImplementedError("integer power in a fused kernel")
        if args[1].is_literal:
            e = _pow_scalar(xs[0], float(args[1].literal))
        else:
            e = f"libdevice.pow({xs[0]}, {xs[1]})"
    elif prim == "integer_pow":
        if not args[1].is_literal:
            raise NotImplementedError("integer_pow with a non-literal exponent")
        n = int(args[1].literal)
        e = _pow_scalar(x, float(n)) if fl else "*".join([x] * n) if n > 0 else "1"
    elif prim == "neg":
        e = f"-{x}"
    elif prim in _LIBDEVICE_UNARY:
        e = f"libdevice.{_LIBDEVICE_UNARY[prim]}({x})"
    elif prim == "sqrt":
        e = f"tl.sqrt_rn({x})"
    elif prim == "sigmoid":  # torch: 1 / (1 + exp(-x)) in op-math
        e = f"tl.math.div_rn(1.0, 1.0 + libdevice.exp(-{x}))"
    elif prim == "relu":  # torch: clamp_min(x, 0), NaN kept
        e = f"tl.where({x} != {x}, {x}, tl.maximum({x}, 0.0))" if fl else f"tl.maximum({x}, 0)"
    elif prim == "square":
        e = f"{x} * {x}"
    elif prim == "absolute":
        e = f"tl.abs({x})"
    elif prim == "sign":  # torch: (0 < x) - (x < 0)
        om = _opmath(out_dt)
        e = f"(0 < {x}).to({om}) - ({x} < 0).to({om})"
    elif prim in ("maximum", "minimum"):
        op = "tl.maximum" if prim == "maximum" else "tl.minimum"
        a, b = xs
        e = (f"tl.where({a} != {a}, {a}, tl.where({b} != {b}, {b}, {op}({a}, {b})))"
             if fl else f"{op}({a}, {b})")
    else:  # pragma: no cover - fusion.ELEMENTWISE and this table move together
        raise NotImplementedError(f"no Triton rendering for {prim}")
    return _round(e, out_dt)


def _unravel(flat: str, shape: tuple, prefix: str) -> list[str]:
    """Source lines splitting the row-major index ``flat`` into per-axis
    indices ``{prefix}{d}`` (the divisors are constants)."""
    lines = []
    rest = flat
    for d in range(len(shape) - 1, 0, -1):
        lines.append(f"{prefix}{d} = {rest} % {shape[d]}")
        lines.append(f"{prefix}t{d} = {rest} // {shape[d]}")
        rest = f"{prefix}t{d}"
    lines.append(f"{prefix}0 = {rest}")
    return lines


def _offset(slot: str, axes: range, prefix: str) -> str:
    terms = [f"{prefix}{d} * {slot}_s{d}" for d in axes]
    return " + ".join(terms) if terms else "0"


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------


def emit_cluster(cluster: Cluster) -> FusedKernel | None:
    """Generate the fused kernel for ``cluster`` or decline with None."""
    kernel, _reason = emit_cluster_explained(cluster)
    return kernel


def emit_cluster_explained(
    cluster: Cluster,
) -> tuple[FusedKernel | None, DeclineReason | None]:
    """``(kernel, None)`` on success, ``(None, DeclineReason)`` when the
    generator cannot express the cluster (the reference's verdicts)."""
    got = _emit_cluster_impl(cluster)
    if isinstance(got, FusedKernel):
        return got, None
    return None, got


def _reduced_axes(root: Apply, body_shape: tuple) -> tuple[int, ...]:
    """The body axes a reduction root reduces (static config: constants)."""
    prim = root.fn.value.name
    r = len(body_shape)
    if prim == "unbroadcast":
        shp = tuple(root.args[1].value)
        if shp == ():
            return tuple(range(r))
        ndiff = r - len(shp)
        return tuple(range(ndiff)) + tuple(
            ndiff + i for i, b in enumerate(shp) if b == 1 and body_shape[ndiff + i] != 1
        )
    axes = root.args[1].value
    if axes is None:
        return tuple(range(r))
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(sorted({a % r for a in axes}))


def _emit_cluster_impl(cluster: Cluster) -> FusedKernel | DeclineReason:
    body_shape = tuple(cluster.body_shape)
    out_shape = tuple(cluster.out_shape)
    out_dtype = cluster.out_dtype
    if out_dtype is None or len(body_shape) == 0:
        return DeclineReason(
            DeclineReason.EMPTY_BODY,
            "cluster has no output dtype or a rank-0 body; no kernel to win",
        )

    # -- name & classify members ------------------------------------------
    members = {n._id for n in cluster.order}
    pre: list[Apply] = []  # broadcast members: strided views made by the wrapper
    body: list[Apply] = []  # elementwise members (+ reduction root)
    for n in cluster.order:
        (pre if classify(n) == "broadcast" else body).append(n)
    if not body or body[-1] is not cluster.root:
        return DeclineReason(
            DeclineReason.CODEGEN,
            "root is not the last body node (single-output ordering)",
        )

    env: dict[str, Any] = {}
    prim_names: dict[int, str] = {}

    def bind_prim(prim) -> str:
        name = prim_names.get(id(prim))
        if name is None:
            name = f"_prim_{prim.name}_{len(prim_names)}"
            prim_names[id(prim)] = name
            env[name] = prim.impl
        return name

    # -- operand discovery -------------------------------------------------
    input_name: dict[int, str] = {}
    for i, node in enumerate(cluster.inputs):
        if not isinstance(node.abstract, AArray):
            return DeclineReason(
                DeclineReason.NOT_ARRAY,
                f"cluster input {i} has no array abstract",
            )
        input_name[node._id] = f"a{i}"

    def ext_ref(node: Node) -> str | None:
        got = input_name.get(node._id)
        if got is not None:
            return got
        if isinstance(node, Constant):
            lit = _literal(node.value)
            if lit is not None:
                return lit
            name = f"_const_{len(env)}"
            env[name] = node.value
            input_name[node._id] = name
            return name
        return None

    def ext_shape(node: Node) -> tuple | None:
        if isinstance(node.abstract, AArray):
            return node.abstract.shape
        if isinstance(node, Constant):
            return _const_shape(node.value)
        return None

    def ext_dtype(node: Node) -> Any:
        if isinstance(node.abstract, AArray):
            return node.abstract.dtype
        from repro_torch.core.infer import abstract_of_value

        return abstract_of_value(node.value).dtype

    pre_name: dict[int, str] = {}
    pre_lines: list[str] = []
    for k, n in enumerate(pre):
        args = []
        for a in n.args:
            if a._id in members:
                return DeclineReason(
                    DeclineReason.CODEGEN,
                    "broadcast member consumes a kernel-body value",
                )
            r = ext_ref(a)
            if r is None:
                return DeclineReason(
                    DeclineReason.CODEGEN,
                    f"unsupported external reference feeding {n.fn.value.name}",
                )
            args.append(r)
        pre_name[n._id] = f"p{k}"
        pre_lines.append(
            f"p{k} = {bind_prim(n.fn.value)}({', '.join(args)})  # {n.fn.value.name} (pre)"
        )

    # kernel operands: every array value entering the elementwise body
    operands: list[tuple[str, str, tuple, Any]] = []  # (slot, wrapper expr, shape, dtype)
    operand_slot: dict[int, _Val] = {}

    def operand_for(a: Node) -> _Val | None:
        got = operand_slot.get(a._id)
        if got is not None:
            return got
        if a._id in pre_name:
            expr, shape, dt = pre_name[a._id], body_shape, a.abstract.dtype
        else:
            r = ext_ref(a)
            if r is None:
                return None
            if r[0] not in "a_" or (
                isinstance(a, Constant)
                and not isinstance(a.value, (torch.Tensor, np.ndarray, np.generic))
            ):  # a Python scalar or a static (a dtype): embedded, not an operand
                return _Val(r, literal=a.value)
            shape = ext_shape(a)
            if shape is None:
                return None
            expr, dt = r, ext_dtype(a)
        slot = f"x{len(operands)}"
        val = _Val(slot, dt, zero_dim=len(shape) == 0)
        operand_slot[a._id] = val
        operands.append((slot, expr, shape, dt))
        return val

    body_lines: list[str] = []
    vals: dict[int, _Val] = {}
    red_root = cluster.kind == "reduce"
    for k, n in enumerate(body):
        is_root_reduction = red_root and n is cluster.root
        rendered: list[_Val] = []
        for j, a in enumerate(n.args):
            if is_root_reduction and j > 0:
                continue  # static reduction config, read by _reduced_axes
            if a._id in vals:
                rendered.append(vals[a._id])
                continue
            v = operand_for(a)
            if v is None:
                return DeclineReason(
                    DeclineReason.CODEGEN,
                    f"unsupported operand feeding {n.fn.value.name}",
                )
            rendered.append(v)
        if is_root_reduction:
            red_in = rendered[0]
            continue
        dt = n.abstract.dtype if isinstance(n.abstract, AArray) else None
        body_lines.append((f"v{k}", n.fn.value.name, rendered, dt))
        vals[n._id] = _Val(f"v{k}", dt)

    _counter[0] += 1
    name = f"fused_{cluster.kind}{_counter[0]}_" + "_".join(
        dict.fromkeys(n.fn.value.name for n in cluster.order)
    )

    # -- the Triton module: kernel + launch wrapper --------------------------
    try:
        kernel_src = _kernel_source(
            cluster, name, body_shape, out_shape, out_dtype, operands, body_lines,
            red_in if red_root else None, pre_lines,
        )
    except NotImplementedError as e:
        # a dtype or op the kernel cannot compute: the plan must stay the
        # reference's, so the cluster is emitted and its launch raises
        kernel_src = _raising_source(name, str(e))

    # -- the oracle: the exact unfused computation ---------------------------
    nargs = ", ".join(f"a{i}" for i in range(len(cluster.inputs)))
    olines = [f"def _oracle({nargs}):"]
    ovname: dict[int, str] = {}
    for n in cluster.order:
        rendered = []
        for a in n.args:
            rendered.append(ovname[a._id] if a._id in ovname else ext_ref(a))
        ovname[n._id] = f"w{len(ovname)}"
        olines.append(
            f"    {ovname[n._id]} = {bind_prim(n.fn.value)}"
            f"({', '.join(rendered)})  # {n.fn.value.name}"
        )
    olines.append(f"    return {ovname[cluster.root._id]}")
    oracle_src = "\n".join(olines) + "\n"

    namespace = dict(env)
    exec(compile(oracle_src, f"<myia-fused-oracle:{name}>", "exec"), namespace)
    oracle = namespace["_oracle"]
    source = kernel_src + "\n\n# -- torch oracle twin " + "-" * 50 + "\n" + oracle_src
    oracle.__fused_source__ = source
    return FusedKernel(
        name=name,
        source=source,
        n_nodes=len(cluster.order),
        kind=cluster.kind,
        body_shape=body_shape,
        out_shape=out_shape,
        oracle=oracle,
        env=env,
        bytes_moved=_cluster_bytes(cluster),
        launches_per_call=_launches_per_call(cluster, body_shape),
        oracle_source=oracle_src,
    )


_HEADER = '''"""Generated by repro_torch.kernels.codegen for fusion cluster {name}."""
import torch
import triton
import triton.language as tl
from triton.language.extra import libdevice
'''


def _raising_source(name: str, why: str) -> str:
    return _HEADER.format(name=name) + (
        f"\n\ndef _launch(*args):\n    raise NotImplementedError({why!r})\n"
    )


def _kernel_source(cluster, name, body_shape, out_shape, out_dtype, operands, body_lines,
                   red_in, pre_lines) -> str:
    reduce = cluster.kind == "reduce"
    rank = len(body_shape)
    slots = [s for s, _, _, _ in operands]
    for _, _, _, dt in operands:
        _tl(dt)  # refuses a dtype the kernel cannot load
    _tl(out_dtype)
    lines = [_HEADER.format(name=name), ""]

    # body statements (op-math values), shared by both kernel kinds
    def body_stmts(indent: str) -> list[str]:
        out = []
        for vname, prim, args, dt in body_lines:
            out.append(f"{indent}{vname} = {_render(prim, args, dt)}  # {prim}")
        return out

    def loads(indent: str, offs: dict[str, str], mask: str) -> list[str]:
        out = []
        for slot, _, _, dt in operands:
            out.append(
                f"{indent}{slot} = tl.load({slot}_ptr + {offs[slot]}, mask={mask}, "
                f"other=0).to({_opmath(dt)})"
            )
        return out

    if not reduce:
        root_v = body_lines[-1][0]
        sig = []
        for s in slots:
            sig += [f"{s}_ptr"] + [f"{s}_s{d}" for d in range(rank)]
        flags = [f"C{i}: tl.constexpr" for i in range(len(slots))]
        lines += [
            "@triton.jit",
            f"def {name}({', '.join(sig + ['o_ptr', 'N'])}, BLOCK: tl.constexpr, "
            f"IDX64: tl.constexpr{''.join(', ' + f for f in flags)}):",
            "    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)",
            "    if IDX64:",
            "        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)",
            "    mask = offs < N",
        ]
        lines += ["    " + l for l in _unravel("offs", body_shape, "i")]
        offs = {}
        for i, s in enumerate(slots):
            lines.append(f"    if C{i}:")
            lines.append(f"        {s}_off = offs")
            lines.append("    else:")
            lines.append(f"        {s}_off = {_offset(s, range(rank), 'i')}")
            offs[s] = f"{s}_off"
        lines += loads("    ", offs, "mask")
        lines += body_stmts("    ")
        lines.append(f"    tl.store(o_ptr + offs, {root_v}.to({_tl(out_dtype)}), mask=mask)")
        lines.append("")
    else:
        red_axes = _reduced_axes(cluster.root, body_shape)
        kept = tuple(d for d in range(rank) if d not in red_axes)
        kshape = tuple(body_shape[d] for d in kept)
        rshape = tuple(body_shape[d] for d in red_axes)
        op = cluster.root.fn.value.name
        is_max = op == "reduce_max"
        red_dt = red_in.dtype if red_in.dtype is not None else np.dtype("float32")
        acc_t = "tl.float32" if _is_float(red_dt) else "tl.int32"
        nk, nr = len(kshape), len(rshape)
        sig = []
        for s in slots:
            sig += [f"{s}_ptr"] + [f"{s}_s{d}" for d in range(nk + nr)]
        flags = [f"RC{i}: tl.constexpr" for i in range(len(slots))]
        ident = ("float('-inf')" if acc_t == "tl.float32" else "-2147483648") if is_max else "0"
        lines += [
            "@triton.jit",
            f"def {name}({', '.join(sig + ['dst_ptr', 'part_ptr', 'M', 'n_split', 'chunk'])}, "
            f"BLOCK: tl.constexpr, PASS: tl.constexpr, IDX64: tl.constexpr"
            f"{''.join(', ' + f for f in flags)}):",
            "    j = tl.program_id(0)",
            "    if PASS == 1:  # combine output j's partials in a fixed order",
            "        s = tl.arange(0, BLOCK)",
            "        p = tl.load(part_ptr + j * n_split + s, mask=s < n_split, "
            f"other={ident})",
        ]
        if is_max:
            lines += [
                "        nan = tl.sum((p != p).to(tl.int32), axis=0)",
                "        r = tl.max(p, axis=0)",
                "        r = tl.where(nan > 0, float('nan'), r)" if acc_t == "tl.float32"
                else "        r = r",
            ]
        else:
            lines.append("        r = tl.sum(p, axis=0)")
        lines += [
            "        tl.store(dst_ptr + j, r.to(dst_ptr.dtype.element_ty))",
            "    else:",
            "        sp = tl.program_id(1)",
            "        if IDX64:",
            "            j = j.to(tl.int64)",
        ]
        lines += ["        " + l for l in _unravel("j", kshape, "k")] if nk else []
        base = {s: (_offset(s, range(nk), "k") if nk else "0") for s in slots}
        for s in slots:
            lines.append(f"        {s}_base = {base[s]}")
        lines += [
            f"        acc = tl.full([BLOCK], {ident}, {acc_t})",
        ]
        if is_max and acc_t == "tl.float32":
            lines.append("        nan = tl.zeros([BLOCK], tl.int32)")
        lines += [
            "        start = sp * chunk",
            "        if IDX64:",
            "            start = sp.to(tl.int64) * chunk",
            "        for r0 in range(0, chunk, BLOCK):",
            "            r = start + r0 + tl.arange(0, BLOCK)",
            "            if IDX64:",
            "                r = r.to(tl.int64)",
            "            mask = r < M",
        ]
        lines += ["            " + l for l in _unravel("r", rshape, "q")]
        offs = {}
        for i, s in enumerate(slots):
            red_off = _offset_red(s, nk, nr)
            lines.append(f"            if RC{i}:")
            lines.append(f"                {s}_off = {s}_base + r")
            lines.append("            else:")
            lines.append(f"                {s}_off = {s}_base + {red_off}")
            offs[s] = f"{s}_off"
        lines += loads("            ", offs, "mask")
        lines += body_stmts("            ")
        x = red_in.expr
        xv = f"{x}.to({acc_t})" if acc_t != _opmath(red_dt) else x
        if is_max:
            lines.append(f"            acc = tl.where(mask, tl.maximum(acc, {xv}), acc)")
            if acc_t == "tl.float32":
                lines.append(f"            nan += (mask & ({xv} != {xv})).to(tl.int32)")
        else:
            lines.append(f"            acc += tl.where(mask, {xv}, 0)")
        if is_max:
            lines.append("        r = tl.max(acc, axis=0)")
            if acc_t == "tl.float32":
                lines.append("        r = tl.where(tl.sum(nan, axis=0) > 0, float('nan'), r)")
        else:
            lines.append("        r = tl.sum(acc, axis=0)")
        lines += [
            "        if n_split == 1:",
            "            tl.store(dst_ptr + j, r.to(dst_ptr.dtype.element_ty))",
            "        else:",
            "            tl.store(part_ptr + j * n_split + sp, r)",
            "",
        ]
    lines += _wrapper_source(cluster, name, body_shape, out_shape, out_dtype, operands,
                             pre_lines, reduce)
    return "\n".join(lines) + "\n"


def _offset_red(slot: str, nk: int, nr: int) -> str:
    terms = [f"q{d} * {slot}_s{nk + d}" for d in range(nr)]
    return " + ".join(terms) if terms else "0"


def _wrapper_source(cluster, name, body_shape, out_shape, out_dtype, operands, pre_lines,
                    reduce) -> list[str]:
    nargs = ", ".join(f"a{i}" for i in range(len(cluster.inputs)))
    out_t = f"torch.{torch_dtype(out_dtype)}".replace("torch.torch.", "torch.")
    lines = [
        "",
        f"def _launch({nargs}):",
        '    """Operands as strided views at the body shape (broadcasts are',
        '    stride-0 views, never materialised), then one launch."""',
        "    dev = a0.device",
    ]
    lines += ["    " + l for l in pre_lines]
    for slot, expr, shape, _dt in operands:
        lines.append(f"    {slot} = torch.broadcast_to(torch.as_tensor({expr}, device=dev), "
                     f"{tuple(body_shape)})")
    slots = [s for s, _, _, _ in operands]
    lines.append(f"    views = [{', '.join(slots)}]")
    lines.append(f"    out = torch.empty({tuple(out_shape)}, dtype={out_t}, device=dev)")
    if not reduce:
        n = int(np.prod(body_shape))
        lines += [
            f"    N = {n}",
            f"    contig = [v.stride() == {_contig_strides(body_shape)} for v in views]",
            "    big = N + 1024 >= 2**31 or any(_extent(v) >= 2**31 for v in views)",
            "    args = []",
            "    for v in views:",
            "        args += [v] + list(v.stride())",
            f"    grid = (triton.cdiv(N, {_MAP_BLOCK}),)",
            f"    {name}[grid](*args, out, N, BLOCK={_MAP_BLOCK}, IDX64=big,",
            "        **{f'C{i}': c for i, c in enumerate(contig)}, enable_fp_fusion=False)",
            "    _counted()",
            "    return out",
            "",
        ]
    else:
        red_axes = _reduced_axes(cluster.root, body_shape)
        kept = tuple(d for d in range(len(body_shape)) if d not in red_axes)
        perm = kept + red_axes
        rshape = tuple(body_shape[d] for d in red_axes)
        n_out = int(np.prod([body_shape[d] for d in kept]))
        M = int(np.prod(rshape))
        block, n_split, chunk = _red_split(n_out, M)
        acc = "torch.float32" if _is_float(_red_dtype(cluster)) else "torch.int32"
        lines += [
            f"    views = [v.permute({perm}) for v in views]",
            f"    n_out, M, block, n_split, chunk = {n_out}, {M}, {block}, {n_split}, {chunk}",
            f"    rc = [tuple(v.stride()[{len(kept)}:]) == {_contig_strides(rshape)} "
            "for v in views]",
            "    big = n_out * M + chunk >= 2**31 or any(_extent(v) >= 2**31 for v in views)",
            f"    part = torch.empty((n_out, n_split), dtype={acc}, device=dev)",
            "    args = []",
            "    for v in views:",
            "        args += [v] + list(v.stride())",
            "    flags = {f'RC{i}': c for i, c in enumerate(rc)}",
            f"    {name}[(n_out, n_split)](*args, out, part, M, n_split, chunk, BLOCK=block,",
            "        PASS=0, IDX64=big, **flags, enable_fp_fusion=False)",
            "    _counted()",
        ]
        if n_split > 1:
            lines += [
                f"    {name}[(n_out,)](*args, out, part, M, n_split, chunk,",
                f"        BLOCK={_next_pow2(n_split)}, PASS=1, IDX64=big, **flags,",
                "        enable_fp_fusion=False)",
                "    _counted()",
            ]
        lines += [
            "    return out",
            "",
        ]
    lines += [
        "",
        "def _extent(v):",
        "    return sum((n - 1) * abs(s) for n, s in zip(v.shape, v.stride())) + 1",
    ]
    return lines


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _red_split(n_out: int, M: int) -> tuple[int, int, int]:
    """``(block, n_split, chunk)`` of a reduce kernel: each of the ``n_out``
    outputs reduces ``M`` elements in ``n_split`` programs of ``chunk``
    elements (a multiple of ``block``)."""
    block = min(_RED_BLOCK, _next_pow2(M))
    n_split = max(1, min(_cdiv(M, block), _cdiv(_RED_PROGRAMS, n_out), _MAX_SPLITS))
    chunk = _cdiv(_cdiv(M, n_split), block) * block
    return block, _cdiv(M, chunk), chunk


def _launches_per_call(cluster: Cluster, body_shape: tuple) -> int:
    """1, or 2 for a reduction whose partials a second pass combines."""
    if cluster.kind != "reduce":
        return 1
    M = int(np.prod([body_shape[d] for d in _reduced_axes(cluster.root, body_shape)]))
    n_out = int(np.prod(body_shape)) // M
    return 2 if _red_split(n_out, M)[1] > 1 else 1


def _red_dtype(cluster: Cluster) -> Any:
    ab = cluster.root.args[0].abstract
    return ab.dtype if isinstance(ab, AArray) else np.dtype("float32")


def _contig_strides(shape: tuple) -> tuple:
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= int(d)
    return tuple(reversed(strides))
