"""Execution backend: graphs to eager torch callables, and the persistent
program cache.

The port of ``repro/core/jax_backend.py``.  Straight-line first-order graphs
are lowered directly (``repro_torch.core.lowering``) and run eagerly: each
call executes the same generated code, one torch call (or one fused kernel
launch) per emitted line.  Anything with residual graph values runs on the
reference VM.  There is no jit tier: torch executes eagerly, and CUDA-graph
capture of the lowered callable is later speed work.

:class:`ProgramCache` is the reference's two-tier persistent cache.  Its
optimized-graph tier is the reference's as it is; its executable tier
stores what the port's lowering builds (there is no XLA executable): the
optimized graph, the lowered straight-line source with its environment, and
the generated Triton sources of the fused clusters, whose binaries Triton
keeps in ``<cache dir>/triton``.

:func:`compile_graph_spmd` is the SPMD tier's backend: the per-shard program
(``repro_torch.core.spmd.shard_graph``) lowered like any other graph, fused
clusters included (K1 at local shapes), run on every rank of a
``torch.distributed`` mesh with the collectives at its resharding points.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
from importlib import metadata
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.parallel import mesh_axes, shard_program

from .dtypes import np_dtype
from .ir import Graph
from .lowering import (
    LoweringError,
    lower_graph,
    lowered_from_payload,
    lowered_payload,
    lowering_blockers,
    try_lower,
)
from .primitives import all_gather_axes, shard_slice
from .serialize import (
    FORMAT_VERSION,
    SerializeError,
    deserialize_graph,
    dumps,
    loads,
    serialize_graph,
    structural_hash,
)
from .spmd import SpmdError, shard_graph
from .vm import VM

__all__ = [
    "CacheStats",
    "CompileFailed",
    "ProgramCache",
    "abstract_signature",
    "abstract_value_signature",
    "compile_graph",
    "compile_graph_spmd",
    "lower_graph",
    "lowering_blockers",
    "mesh_descriptor",
    "trace_graph",
]


class CompileFailed(Exception):
    """Building a program failed after the cache's bounded retries.

    The next rung of the degraded-mode ladder (``api.MyiaFunction``)
    catches this and falls back to the VM oracle — slow, but alive and
    correct.  Nothing else is caught: a Triton kernel that fails to build
    at its first launch raises out of the call."""


def _fault_hooks():
    """The serving fault-injection hooks, or None outside chaos runs
    (imported lazily: ``repro_torch.serve`` depends on ``repro_torch.core``)."""
    try:
        from repro_torch.serve import faults
    except ImportError:  # pragma: no cover - serve tier absent
        return None
    return faults


def trace_graph(graph: Graph) -> Callable:
    """A plain callable evaluating the graph via the VM."""

    def run(*args: Any) -> Any:
        return VM().call(graph, tuple(args))

    run.__name__ = f"myia_{graph.name}"
    return run


def compile_graph(graph: Graph, *, lower: bool = True, fuse: bool = False) -> Callable:
    """Compile ``graph`` to a callable.

    Straight-line first-order graphs are lowered directly (no VM on the
    path); anything with residual graph values falls back to the VM.
    ``fuse=True`` selects the fusion tier: clustered regions execute as
    generated Triton kernels on CUDA tensors (``repro_torch.core.fusion`` +
    ``repro_torch.kernels.codegen``), and as their torch oracles on the CPU
    or in kernel mode ``"ref"``.  The returned callable carries ``.lowered``
    (bool) and ``.fn`` (the callable it runs) for introspection.
    """
    fn = try_lower(graph, fuse=fuse) if lower else None
    lowered = fn is not None
    if fn is None:
        fn = trace_graph(graph)

    def runner(*args: Any) -> Any:
        return fn(*args)

    runner.__name__ = f"myia_{graph.name}"
    runner.lowered = lowered
    runner.fn = fn
    return runner


def compile_graph_spmd(
    graph: Graph,
    mesh: Any,
    in_specs: Sequence[Any],
    *,
    fuse: bool = False,
) -> Callable:
    """Compile ``graph`` to a sharded callable over ``mesh`` (SPMD tier).

    The sharding propagation pass (``repro_torch.core.spmd``) turns the
    optimized global graph into a per-shard program — collectives at the
    resharding points, shape constants localized — which lowers through the
    ordinary straight-line path (with ``fuse=True``, its clusters run as K1
    kernels generated at the *local* shapes; no cluster spans a collective).
    Every rank calls the runner with the *global* arguments: it slices its
    block of each by ``in_partition`` (index math, no communication), runs
    the per-shard program, and all-gathers the outputs by ``out_partition``,
    so every rank holds the global results (the reference's ``shard_map``
    in and out).

    Raises :class:`SpmdError` when the graph cannot be sharded (residual
    recursion / higher-order calls, non-array parameters) — callers fall
    back to the single-device tier.
    """
    sizes = mesh_axes(mesh)
    sharded = shard_graph(graph, in_specs, sizes)
    fn = try_lower(sharded.graph, fuse=fuse)
    if fn is None:  # pragma: no cover - shard_graph already validated
        raise SpmdError(f"per-shard program of {graph.name} failed to lower")

    def runner(*args: Any) -> Any:
        with shard_program(mesh):
            local = tuple(_local_block(a, part, sizes)
                          for a, part in zip(args, sharded.in_partition))
            return _global_value(fn(*local), sharded.out_partition, sizes)

    runner.__name__ = f"myia_spmd_{graph.name}"
    runner.lowered = True
    runner.spmd = True
    runner.fn = fn
    runner.sharded = sharded
    runner.plan = sharded.plan
    runner.mesh = mesh
    return runner


def _entry_axes(entry: Any) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def _local_block(x: Any, partition: tuple, sizes: dict) -> Any:
    """This rank's block of a global argument (``shard_slice`` per dim)."""
    for d, entry in enumerate(partition):
        axes = _entry_axes(entry)
        if axes:
            x = shard_slice.impl(x, axes, d, tuple(sizes[a] for a in axes))
    return x


def _global_value(out: Any, partition: Any, sizes: dict) -> Any:
    """The global value of a per-shard output (``all_gather_axes`` per dim)."""
    if isinstance(out, tuple):
        return tuple(_global_value(o, p, sizes) for o, p in zip(out, partition))
    for d, entry in enumerate(partition):
        axes = _entry_axes(entry)
        if axes:
            out = all_gather_axes.impl(out, axes, d, tuple(sizes[a] for a in axes))
    return out


# ---------------------------------------------------------------------------
# Persistent program cache
# ---------------------------------------------------------------------------


class CacheStats:
    """Counters from one :class:`ProgramCache` (surfaced like ``OptStats``).

    * ``hits`` / ``misses`` — cache-key lookups that found / did not find a
      durable entry,
    * ``exec_loads`` — hits answered by rebuilding the stored program from
      its lowered source (no optimizer, no lowering, no kernel build),
    * ``programs_built`` — programs this process built: lowerings of a
      graph, plus Triton kernel binaries built at a cached program's first
      launch (not found in ``<cache dir>/triton``).  It replaces the
      reference's ``xla_compiles`` (``.lower().compile()`` invocations): a
      warm restart of the same workload keeps it at 0,
    * ``puts`` / ``spills`` — entries written / evicted (LRU by mtime when
      over ``max_entries``),
    * ``errors`` — every degradation event, in aggregate (never fatal:
      the cache degrades to rebuilding), classified further as:

      - ``corrupt_entries`` — entries whose payload would not decode
        (truncated/garbage pickle, undeserializable graph).  Each is
        **quarantined** (renamed to ``*.quarantined``, counted in
        ``quarantined``) so it is never re-read and never fatal,
      - ``io_errors`` — OS-level read/write failures,
      - the remainder of ``errors`` is benign degradation: stored programs
        that would not rebuild (re-lowered from the graph payload),
        non-durable graphs served from memory only.

    * ``compile_retries`` / ``vm_fallbacks`` — the degraded-mode ladder:
      failed builds retried (bounded by ``max_compile_retries``), and
      specializations that exhausted retries and were handed to the VM
      oracle by ``api.MyiaFunction``.
    * ``graph_hits`` / ``graph_misses`` / ``graph_puts`` — the
      optimized-graph tier (``graph_key``/``load_graph``/``store_graph``):
      a graph hit skips the optimize + closure-elim phases of
      ``compile_pipeline`` entirely.
    """

    __slots__ = (
        "hits", "misses", "exec_loads", "programs_built", "puts", "spills",
        "errors", "corrupt_entries", "io_errors", "quarantined",
        "compile_retries", "vm_fallbacks",
        "graph_hits", "graph_misses", "graph_puts",
    )

    def __init__(self) -> None:
        for name in self.__slots__:
            setattr(self, name, 0)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def graph_hit_rate(self) -> float:
        total = self.graph_hits + self.graph_misses
        return self.graph_hits / total if total else 0.0

    def as_dict(self) -> dict:
        out = {name: getattr(self, name) for name in self.__slots__}
        out["hit_rate"] = round(self.hit_rate, 4)
        out["graph_hit_rate"] = round(self.graph_hit_rate, 4)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CacheStats({self.as_dict()!r})"


def mesh_descriptor(mesh: Any) -> tuple | None:
    """Canonical identity of a concrete mesh: axis names and sizes, the global
    ranks in mesh order, and this rank's device.  The single definition shared
    by the specialization key (``api.MyiaFunction``) and the program cache's
    key — a same-shape mesh over different ranks or devices must never
    collide."""
    if mesh is None:
        return None
    if mesh.device_type == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    else:
        device = mesh.device_type
    return (
        tuple(sorted(mesh_axes(mesh).items())),
        tuple(int(r) for r in mesh.mesh.flatten().tolist()),
        device,
    )


def abstract_signature(example_args: Sequence[Any]) -> str:
    """Canonical string for the argument dtypes and shapes — the signature
    component of the executable key, in the reference's spelling (numpy
    dtype strings).  Only array arguments are supported."""
    parts = []
    for a in example_args:
        if not (hasattr(a, "dtype") and hasattr(a, "shape")):
            raise SerializeError(f"non-array argument {type(a).__name__} in AOT signature")
        dt = np_dtype(a.dtype) if isinstance(a.dtype, torch.dtype) else np.dtype(a.dtype)
        parts.append(f"{dt.str}{list(a.shape)}")
    return ";".join(parts)


def abstract_value_signature(abstracts: Sequence[Any]) -> str:
    """Canonical string for a tuple of *inference* abstract values
    (``repro_torch.core.infer.AScalar``/``AArray``/``ATuple``) — the
    signature component of the optimized-graph cache key.

    Known scalar *values* are part of the signature: constant propagation
    bakes them into the optimized graph.  Anything that cannot be
    canonically rendered raises :class:`SerializeError` — the caller skips
    the graph tier."""
    from .infer import ANY, AArray, AScalar, ATuple

    def part(a: Any) -> str:
        if isinstance(a, AArray):
            return f"{a.dtype.str}{list(a.shape)}"
        if isinstance(a, ATuple):
            return "(" + ",".join(part(e) for e in a.elements) + ")"
        if isinstance(a, AScalar):
            if a.value is ANY:
                return f"{a.kind}:?"
            if a.value is None or isinstance(a.value, (bool, int, float, str)):
                return f"{a.kind}:{a.value!r}"
            raise SerializeError(
                f"opaque static value {type(a.value).__name__} in graph-cache signature"
            )
        raise SerializeError(
            f"non-durable abstract {type(a).__name__} in graph-cache signature"
        )

    return ";".join(part(a) for a in abstracts)


def _platform(example_args: Sequence[Any]) -> str:
    """``"cpu"``, or the card's SM version (``"sm_90"``) for CUDA arguments."""
    for a in example_args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            major, minor = torch.cuda.get_device_capability(a.device)
            return f"sm_{major}{minor}"
    return "cpu"


def _triton_version() -> str | None:
    try:
        return metadata.version("triton")
    except metadata.PackageNotFoundError:
        return None


def _kernels_of(fn: Callable) -> list:
    """Every fused kernel of a lowered program, loop sub-programs included."""
    from repro_torch.kernels.codegen import FusedKernel

    out, stack = [], [fn]
    while stack:
        for v in stack.pop().__lowered_env__.values():
            if isinstance(v, FusedKernel):
                out.append(v)
            elif hasattr(v, "__lowered_source__"):
                stack.append(v)
    return out


class ProgramCache:
    """Persistent two-tier cache of built programs, keyed on *what the
    program is* rather than which process built it.

    **Executable tier** (``key``/``load_or_compile``, ``<key>.pkl``)::

        structural graph hash × argument signature × fuse/kernel-mode ×
        mesh descriptor × (torch, CUDA and Triton versions, SM version,
        serialize format)

    Each entry stores the serialized optimized graph and the lowered
    program: its straight-line source and environment, the generated
    Triton sources of its fused clusters among it
    (``lowering.lowered_payload``).  A warm process finds the entry and
    rebuilds the callable from the stored source — no optimizer, no
    ``lower_graph``, no Triton compile: the kernels' binaries are found in
    ``<cache dir>/triton``, Triton's cache for the programs of this cache.
    If the stored program will not rebuild, the stored graph is re-lowered
    — never wrong, at worst slow.

    **Optimized-graph tier** (``graph_key``/``load_graph``/``store_graph``,
    ``<key>.graph.json``)::

        loose structural hash of the PRE-optimization graph ×
        abstract-value signature × opt/patterns/loops/engine config ×
        serialize format version

    The value is the canonical JSON of the post-optimize post-closure-elim
    graph, so a new specialization of a known family skips the optimize +
    closure-elim pipeline phases.  Reads are lock-free: writers publish
    complete entries atomically (``mkstemp`` + ``os.replace``), so
    concurrent distinct-key builds never block each other and same-key
    racers each land a valid entry with one survivor.
    """

    def __init__(
        self, path: str, *, max_entries: int = 256, max_compile_retries: int = 1
    ) -> None:
        self.path = os.path.abspath(path)
        self.max_entries = max_entries
        #: bounded retry for failed builds (rung 2 of the ladder); past it,
        #: :class:`CompileFailed` hands the caller to the VM rung
        self.max_compile_retries = max_compile_retries
        self.stats = CacheStats()
        #: Triton's cache for the kernels of this cache's programs
        self.triton_dir = os.path.join(self.path, "triton")
        os.makedirs(self.path, exist_ok=True)

    # -- keys --------------------------------------------------------------
    def key(
        self,
        graph: Graph,
        example_args: Sequence[Any],
        *,
        fuse: bool = False,
        kernel_mode: str | None = None,
        mesh: Any = None,
    ) -> str:
        if kernel_mode is None:
            from repro_torch.kernels.ops import get_kernel_mode

            kernel_mode = get_kernel_mode()
        payload = {
            "graph": structural_hash(graph),
            "sig": abstract_signature(example_args),
            "fuse": bool(fuse),
            "kernel_mode": kernel_mode,
            "mesh": mesh_descriptor(mesh),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "triton": _triton_version(),
            "platform": _platform(example_args),
            "format": FORMAT_VERSION,
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key + ".pkl")

    def probe(self, key: str) -> bool:
        """True when a durable executable entry exists for ``key``.
        Read-only: no stats mutation, no entry load."""
        return os.path.exists(self._file(key))

    def probe_graph(self, key: str) -> bool:
        """``probe`` for the optimized-graph tier (same read-only contract)."""
        return os.path.exists(self._graph_file(key))

    # -- optimized-graph tier ----------------------------------------------
    def graph_key(
        self,
        graph: Graph,
        abstracts: Sequence[Any],
        *,
        opt: bool = True,
        patterns: bool = False,
        loops: bool = True,
        engine: str = "worklist",
    ) -> str:
        """Cache key of the *pre-optimization* ``graph`` at an abstract
        signature, under one optimizer configuration.  Raises
        :class:`SerializeError` when the graph or signature cannot be
        canonically keyed — callers skip the tier."""
        payload = {
            "graph": structural_hash(graph, loose=True),
            "sig": abstract_value_signature(abstracts),
            "opt": bool(opt),
            "patterns": bool(patterns),
            "loops": bool(loops),
            "engine": engine,
            "format": FORMAT_VERSION,
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()

    def _graph_file(self, key: str) -> str:
        return os.path.join(self.path, key + ".graph.json")

    def load_graph(self, key: str) -> Graph | None:
        """The stored post-optimize graph for ``key``, or None.  Lock-free:
        a reader sees either no file or a whole one; a corrupt entry is
        quarantined, not fatal."""
        fpath = self._graph_file(key)
        try:
            with open(fpath, "r", encoding="utf-8") as f:
                text = f.read()
        except FileNotFoundError:
            self.stats.graph_misses += 1
            return None
        except OSError:
            self.stats.graph_misses += 1
            self.stats.io_errors += 1
            self.stats.errors += 1
            return None
        try:
            g = loads(text)
        except Exception:
            self._quarantine(fpath)
            self.stats.graph_misses += 1
            return None
        self.stats.graph_hits += 1
        try:
            os.utime(fpath)  # LRU touch
        except OSError:
            pass
        return g

    def store_graph(self, key: str, graph: Graph) -> bool:
        """Persist a post-optimize ``graph`` under ``key`` (atomic publish).
        Best-effort: a non-durable graph or a failing write degrades to not
        caching — never to an error."""
        try:
            text = dumps(graph)
        except SerializeError:
            self.stats.errors += 1
            return False
        if not self._publish(self._graph_file(key), text.encode("utf-8")):
            return False
        self.stats.graph_puts += 1
        self._evict(".graph.json")
        return True

    # -- main entry point --------------------------------------------------
    def load_or_compile(
        self,
        graph: Graph,
        example_args: Sequence[Any],
        *,
        fuse: bool = False,
        lowered_fn: Callable | None = None,
        mesh: Any = None,
    ) -> Callable:
        """A built callable for ``graph`` at ``example_args``'s signature,
        answered from disk when possible.  On a miss the program is built
        here (``lower_graph``, with bounded retries) unless ``lowered_fn``
        is given, and persisted.

        Raises :class:`SerializeError` when the graph/arguments cannot be
        made durable (VM-fallback graphs, non-array args) — callers fall
        back to the ordinary tiers — and :class:`CompileFailed` when the
        build fails past its retries.
        """
        key = self.key(graph, example_args, fuse=fuse, mesh=mesh)
        with obs_trace.span("cache.lookup", graph=graph.name) as sp:
            entry = self._read(key)
            if entry is not None:
                runner = self._from_entry(entry, fuse=fuse, fpath=self._file(key))
                if runner is not None:
                    self.stats.hits += 1
                    sp.set(verdict="hit")
                    runner.cache_key = key
                    return runner
            self.stats.misses += 1
            sp.set(verdict="miss")
        # miss: build fresh from the live graph and persist
        if lowered_fn is None:
            if lowering_blockers(graph):
                raise SerializeError(f"graph {graph.name} does not lower (VM fallback)")
            lowered_fn = self._compile(graph, fuse, tag=f"fresh:{graph.name}")
        self._adopt(lowered_fn)
        with obs_trace.span("cache.write", graph=graph.name):
            self._write(key, graph, lowered_fn)
        runner = _program_runner(lowered_fn)
        runner.cache_key = key
        return runner

    # -- internals ---------------------------------------------------------
    def _compile(self, graph: Graph, fuse: bool, *, tag: str) -> Callable:
        """One build (``lower_graph``), with bounded retry (rung 2 of the
        ladder).  Transient failures (injected by the chaos harness) are
        retried up to ``max_compile_retries`` times; a persistent failure
        raises :class:`CompileFailed` so the caller can take the VM rung."""
        fh = _fault_hooks()
        last: Exception | None = None
        for attempt in range(self.max_compile_retries + 1):
            if attempt:
                self.stats.compile_retries += 1
            try:
                if fh is not None:
                    fh.on_compile(tag)
                fn = lower_graph(graph, fuse=fuse)
            except LoweringError as e:
                raise SerializeError(f"graph {graph.name} does not lower: {e}") from None
            except Exception as e:
                last = e
                continue
            self.stats.programs_built += 1
            return fn
        raise CompileFailed(
            f"build of {tag} failed after {self.max_compile_retries + 1} attempts"
        ) from last

    def _adopt(self, fn: Callable) -> None:
        """Point a program's kernels at this cache's Triton directory and
        count the binaries their first launches build."""
        for k in _kernels_of(fn):
            k.binary_dir = self.triton_dir
            k.on_build = self._count_builds

    def _count_builds(self, n: int) -> None:
        self.stats.programs_built += n

    def _quarantine(self, fpath: str) -> None:
        """Rename a corrupt entry aside (``<key>.pkl.quarantined`` no longer
        matches the ``.pkl`` suffix, so it is never re-read).  Quarantine
        failure degrades to deletion."""
        self.stats.corrupt_entries += 1
        self.stats.errors += 1
        try:
            os.replace(fpath, fpath + ".quarantined")
            self.stats.quarantined += 1
        except OSError:
            try:
                os.unlink(fpath)
                self.stats.quarantined += 1
            except OSError:
                self.stats.io_errors += 1

    def _read(self, key: str) -> dict | None:
        fpath = self._file(key)
        if not os.path.exists(fpath):
            return None
        fh = _fault_hooks()
        if fh is not None:
            fh.on_cache_read(fpath)
        try:
            with open(fpath, "rb") as f:
                entry = pickle.load(f)
        except OSError:
            self.stats.io_errors += 1
            self.stats.errors += 1
            return None
        except Exception:
            self._quarantine(fpath)  # truncated / garbage bytes
            return None
        if not isinstance(entry, dict) or "graph" not in entry:
            self._quarantine(fpath)  # decoded, but not a cache entry
            return None
        try:
            os.utime(fpath)  # LRU touch
        except OSError:
            self.stats.io_errors += 1
        return entry

    def _from_entry(self, entry: dict, *, fuse: bool, fpath: str | None = None
                    ) -> Callable | None:
        if entry.get("program") is not None:
            try:
                fn = lowered_from_payload(entry["program"])
            except Exception:
                self.stats.errors += 1  # stale program: rebuild from the graph
            else:
                self.stats.exec_loads += 1
                self._adopt(fn)
                return _program_runner(fn)
        try:
            g = deserialize_graph(entry["graph"])
        except Exception:
            if fpath is not None:
                self._quarantine(fpath)
            else:
                self.stats.corrupt_entries += 1
                self.stats.errors += 1
            return None
        try:
            fn = self._compile(g, fuse, tag=f"entry:{g.name}")
        except CompileFailed:
            raise
        except Exception:
            self.stats.errors += 1
            return None
        self._adopt(fn)
        return _program_runner(fn)

    def _write(self, key: str, graph: Graph, fn: Callable) -> None:
        try:
            payload = serialize_graph(graph)
        except SerializeError:
            self.stats.errors += 1
            return  # graph not durable: serve from memory only
        try:
            program = lowered_payload(fn)
        except SerializeError:
            program = None
            self.stats.errors += 1  # entry still useful: graph-level reuse
        blob = pickle.dumps({"graph": payload, "program": program})
        if self._publish(self._file(key), blob):
            self.stats.puts += 1
            self._evict()

    def _publish(self, fpath: str, data: bytes) -> bool:
        """Write ``data`` to ``fpath`` atomically (tmpfile + ``os.replace``)."""
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, fpath)
        except OSError:
            self.stats.errors += 1
            self.stats.io_errors += 1
            if tmp is not None:  # don't leak .tmp files into the cache dir
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return False
        return True

    def _evict(self, suffix: str = ".pkl") -> None:
        """Bound one tier's entry count (LRU by mtime).  Tiers evict
        independently: a burst of graph-tier puts never spills programs."""
        try:
            files = [
                os.path.join(self.path, n)
                for n in os.listdir(self.path)
                if n.endswith(suffix)
            ]
            if len(files) <= self.max_entries:
                return
            files.sort(key=os.path.getmtime)
            for f in files[: len(files) - self.max_entries]:
                os.remove(f)
                self.stats.spills += 1
        except OSError:
            self.stats.errors += 1
            self.stats.io_errors += 1


def _program_runner(fn: Callable) -> Callable:
    def runner(*args: Any) -> Any:
        return fn(*args)

    runner.lowered = True
    runner.aot = True
    runner.fn = fn
    return runner
