"""Round-trippable graph serialization + canonical structural hashing.

The paper's payoff for a closure-capable graph IR is that the optimized
program is a first-class *artifact* — "amenable to ahead-of-time
optimization" — yet until now nothing the pipeline produced outlived the
Python process.  This module makes optimized graphs durable:

* :func:`serialize_graph` / :func:`deserialize_graph` — a canonical,
  JSON-able encoding of a *closed* graph family (the root graph plus
  every graph it references, e.g. ``while_loop``/``scan_loop``
  sub-graphs).  Deserialize → re-lower reproduces the exact same
  straight-line program: the round trip is bit-identical under ``jit``
  (pinned by ``tests/core/test_serialize.py`` over the closure-elim and
  worklist corpora).
* :func:`structural_hash` — a content hash of the same encoding with all
  debug names stripped, so it is stable across process runs (node ids,
  dict ordering and clone relabels never leak in) and identical for
  structurally-identical graphs.  This is the first component of the
  program-cache key (``torch_backend.ProgramCache``, as the reference's), and
  the port's structural oracle: a program's hash is the same in both
  packages.

What serializes: parameters, applies, and constants holding scalars,
strings, tuples, dtypes, numpy arrays, tensors (encoded as the reference's
jax arrays), :class:`Primitive`\\ s (by
registry name) and nested :class:`Graph`\\ s.  What doesn't: runtime-only
values (closures, gradient environments, symbolic keys) and free
variables into graphs outside the family — those only survive in
VM-fallback graphs, which are not AOT artifacts; :class:`SerializeError`
is raised and callers skip the cache.

Loose (hash-only) mode
----------------------

``structural_hash(g, loose=True)`` additionally admits the two runtime
value kinds that appear in *pre-optimization* adjoint graphs — symbolic
keys (encoded positionally, by the canonical index of the node they
reference) and empty gradient environments — so the optimized-graph
cache tier (``ProgramCache.graph_key`` in the reference) can key on the
program *before* the optimizer runs.  Loose payloads are tagged and
refuse to deserialize: the encoding is an identity, not an artifact.
"""

from __future__ import annotations

import base64
import hashlib
import json
from typing import Any

import numpy as np

from .ir import Apply, Constant, Graph, Node, Parameter
from .primitives import PRIMITIVES, Primitive

__all__ = [
    "FORMAT_VERSION",
    "SerializeError",
    "serialize_graph",
    "deserialize_graph",
    "dumps",
    "loads",
    "structural_hash",
]

#: bump when the encoding changes — part of every ProgramCache key, so a
#: format change can never resurrect stale artifacts
FORMAT_VERSION = 1


class SerializeError(Exception):
    """The graph family contains values that cannot be made durable."""


_RUNTIME = None


def _runtime():
    """Lazily-bound (torch, dtypes, EnvInstance, SymbolicKey) — deferred so
    importing this module stays cheap, memoized so the per-value encoder
    doesn't pay the import-machinery lookup on every constant (the loose
    hash sits on the compile pipeline's cache-lookup path)."""
    global _RUNTIME
    if _RUNTIME is None:
        import torch

        from . import dtypes
        from .values import EnvInstance, SymbolicKey

        _RUNTIME = (torch, dtypes, EnvInstance, SymbolicKey)
    return _RUNTIME


# ---------------------------------------------------------------------------
# Canonical enumeration
# ---------------------------------------------------------------------------


def _enumerate_family(
    root: Graph, *, loose: bool = False
) -> tuple[list[Graph], list[Node], dict[int, int]]:
    """Deterministic numbering of the closed family below ``root``.

    Graphs are numbered in first-reference order starting from the root;
    nodes get one global post-order numbering (inputs always precede
    users), derived purely from the graphs' structure — never from node
    ids or set iteration — so two processes building the same program
    assign identical indices.

    ``loose=True`` (hash-only mode) additionally enumerates the nodes
    referenced by :class:`SymbolicKey` constants before the constants
    themselves, so a key can be encoded as the canonical index of its
    referent.
    """
    SymbolicKey = _runtime()[3]

    graphs: list[Graph] = []
    gidx: dict[int, int] = {}
    nodes: list[Node] = []
    nidx: dict[int, int] = {}
    deferred_keys: set[int] = set()

    def register_graph(g: Graph) -> None:
        if id(g) in gidx:
            return
        gidx[id(g)] = len(graphs)
        graphs.append(g)
        for p in g.parameters:
            if p._id not in nidx:
                nidx[p._id] = len(nodes)
                nodes.append(p)

    def visit(start: Node) -> None:
        stack: list[tuple[Node, bool]] = [(start, False)]
        while stack:
            n, ready = stack.pop()
            if n._id in nidx:
                continue
            if ready:
                nidx[n._id] = len(nodes)
                nodes.append(n)
                continue
            if isinstance(n, Constant):
                if isinstance(n.value, Graph):
                    register_graph(n.value)
                elif loose and isinstance(n.value, SymbolicKey):
                    ref = n.value.node
                    if ref._id not in nidx:
                        if n._id in deferred_keys:
                            # referent unreachable or cyclic through this
                            # constant: no canonical index exists
                            raise SerializeError(
                                f"symbolic key referent {ref!r} cannot be enumerated"
                            )
                        deferred_keys.add(n._id)
                        stack.append((n, False))
                        stack.append((ref, False))
                        continue
                nidx[n._id] = len(nodes)
                nodes.append(n)
                continue
            if isinstance(n, Parameter):
                if loose and n.graph is not None:
                    # pre-opt closures reference free variables of scopes
                    # not reachable as graph constants; for hashing only,
                    # pull the owning scope into the enumeration (its
                    # structure is part of the program's identity)
                    register_graph(n.graph)
                    continue
                # parameter of an unregistered graph: free variable into a
                # scope outside the family
                raise SerializeError(
                    f"free parameter {n!r} of graph "
                    f"{n.graph.name if n.graph else '?'} is not in the family"
                )
            assert isinstance(n, Apply)
            if loose and n.graph is not None:
                register_graph(n.graph)  # same: keep encode-time gidx total
            stack.append((n, True))
            for inp in reversed(n.inputs):
                if inp._id not in nidx:
                    stack.append((inp, False))

    register_graph(root)
    i = 0
    while i < len(graphs):
        g = graphs[i]
        if g.return_ is None:
            raise SerializeError(f"graph {g.name} has no return node")
        visit(g.return_)
        i += 1
    return graphs, nodes, gidx


# ---------------------------------------------------------------------------
# Value encoding
# ---------------------------------------------------------------------------


def _enc_array(kind: str, arr: np.ndarray) -> dict:
    return {
        "t": kind,
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii"),
    }


def _enc_value(
    v: Any,
    gidx: dict[int, int],
    *,
    nidx: dict[int, int] | None = None,
    loose: bool = False,
) -> Any:
    torch, dtypes, EnvInstance, SymbolicKey = _runtime()

    if loose and isinstance(v, SymbolicKey):
        # hash-only: a key is identified by the canonical index of the
        # node it references (enumerated by _enumerate_family in loose
        # mode) — process-stable, never an object id
        i = nidx.get(v.node._id) if nidx is not None else None
        if i is None:
            raise SerializeError(f"symbolic key referent {v.node!r} not in family")
        return {"t": "symkey", "v": i}
    if loose and isinstance(v, EnvInstance):
        if len(v):
            # a populated runtime env is not structure; refuse the key
            raise SerializeError("non-empty gradient environment constant")
        return {"t": "env0"}
    if v is None:
        return {"t": "none"}
    t = type(v)
    if t is bool:
        return {"t": "bool", "v": v}
    if t is int:
        return {"t": "int", "v": v}
    if t is float:
        # repr round-trips exactly, including inf/-inf/nan (json can't)
        return {"t": "float", "v": repr(v)}
    if t is str:
        return {"t": "str", "v": v}
    if t is tuple:
        return {"t": "tuple", "v": [_enc_value(e, gidx, nidx=nidx, loose=loose) for e in v]}
    if isinstance(v, np.dtype):
        return {"t": "dtype", "v": v.str}
    if isinstance(v, type):
        try:
            return {"t": "dtype_cls", "v": np.dtype(v).str}
        except TypeError:
            raise SerializeError(f"cannot serialize type constant {v!r}")
    if isinstance(v, Primitive):
        return {"t": "prim", "v": v.name}
    if isinstance(v, Graph):
        gi = gidx.get(id(v))
        if gi is None:
            raise SerializeError(f"graph constant {v.name} escapes the family")
        return {"t": "graph", "v": gi}
    if isinstance(v, np.generic):
        return _enc_array("npscalar", np.asarray(v))
    if isinstance(v, np.ndarray):
        return _enc_array("np", v)
    if isinstance(v, torch.Tensor):
        # a tensor encodes as the reference's jax array of the same dtype,
        # shape and bytes ("jax"), so the two packages' encodings are equal
        if v.device.type == "meta":
            raise SerializeError("meta tensor constant cannot be serialized")
        try:
            return _enc_array("jax", dtypes.to_numpy(v))
        except TypeError as e:
            raise SerializeError(str(e)) from None
    raise SerializeError(f"cannot serialize constant of type {type(v).__name__}: {v!r}")


def _dec_prim(name: str) -> Primitive:
    p = PRIMITIVES.get(name)
    if p is None:
        # kernel primitives register on import of repro_torch.kernels.ops
        import repro_torch.kernels.ops  # noqa: F401

        p = PRIMITIVES.get(name)
    if p is None:
        raise SerializeError(f"unknown primitive {name!r} (missing registration?)")
    return p


def _dec_value(e: Any, graphs: list[Graph]) -> Any:
    dtypes = _runtime()[1]

    t = e["t"]
    if t == "none":
        return None
    if t in ("bool", "int", "str"):
        return e["v"]
    if t == "float":
        return float(e["v"])
    if t == "tuple":
        return tuple(_dec_value(x, graphs) for x in e["v"])
    if t == "dtype":
        return np.dtype(e["v"])
    if t == "dtype_cls":
        return np.dtype(e["v"]).type
    if t == "prim":
        return _dec_prim(e["v"])
    if t == "graph":
        return graphs[e["v"]]
    if t in ("np", "jax", "npscalar"):
        arr = np.frombuffer(
            base64.b64decode(e["data"]), dtype=np.dtype(e["dtype"])
        ).reshape(tuple(e["shape"]))
        if t == "jax":
            return dtypes.to_tensor(arr)
        if t == "npscalar":
            return arr.reshape(()).copy()[()]
        return arr.copy()
    raise SerializeError(f"unknown value tag {t!r}")


# ---------------------------------------------------------------------------
# Graph <-> payload
# ---------------------------------------------------------------------------


def serialize_graph(root: Graph, *, names: bool = True, loose: bool = False) -> dict:
    """Encode the closed family below ``root`` as a JSON-able dict.

    ``names=False`` strips graph/parameter/node debug names — the form
    :func:`structural_hash` digests, so renames and clone relabels never
    change the hash.  ``loose=True`` admits symbolic-key / empty-env
    constants (pre-optimization adjoint graphs) for hashing only — the
    payload is tagged and :func:`deserialize_graph` rejects it.
    """
    graphs, nodes, gidx = _enumerate_family(root, loose=loose)
    nidx = {n._id: i for i, n in enumerate(nodes)}
    enc_nodes: list[dict] = []
    for n in nodes:
        if isinstance(n, Parameter):
            rec: dict = {"k": "p", "g": gidx[id(n.graph)]}
        elif isinstance(n, Apply):
            if id(n.graph) not in gidx:
                raise SerializeError(
                    f"apply node owned by out-of-family graph {n.graph!r}"
                )
            rec = {"k": "a", "g": gidx[id(n.graph)], "in": [nidx[i._id] for i in n.inputs]}
        else:
            assert isinstance(n, Constant)
            rec = {"k": "c", "v": _enc_value(n.value, gidx, nidx=nidx, loose=loose)}
        if names and n.debug_name:
            rec["n"] = n.debug_name
        enc_nodes.append(rec)
    enc_graphs = []
    for g in graphs:
        enc_graphs.append(
            {
                "name": g.name if names else "",
                "params": [nidx[p._id] for p in g.parameters],
                "ret": nidx[g.return_._id],
            }
        )
    payload = {"version": FORMAT_VERSION, "graphs": enc_graphs, "nodes": enc_nodes}
    if loose:
        payload["loose"] = True
    return payload


def deserialize_graph(payload: dict) -> Graph:
    """Rebuild the root graph (and its family) from :func:`serialize_graph`."""
    if payload.get("version") != FORMAT_VERSION:
        raise SerializeError(
            f"format version mismatch: {payload.get('version')} != {FORMAT_VERSION}"
        )
    if payload.get("loose"):
        raise SerializeError("loose (hash-only) payloads cannot be deserialized")
    graphs = [Graph(e["name"]) for e in payload["graphs"]]
    nodes: list[Node | None] = [None] * len(payload["nodes"])
    # parameters first (graph shells own them)
    for gi, ge in enumerate(payload["graphs"]):
        for pi in ge["params"]:
            rec = payload["nodes"][pi]
            assert rec["k"] == "p" and rec["g"] == gi
            nodes[pi] = graphs[gi].add_parameter(rec.get("n", ""))
    # constants + applies in index order (inputs always have lower indices)
    for i, rec in enumerate(payload["nodes"]):
        if nodes[i] is not None:
            continue
        k = rec["k"]
        if k == "c":
            c = Constant(_dec_value(rec["v"], graphs), rec.get("n", ""))
            nodes[i] = c
        elif k == "a":
            inputs = []
            for j in rec["in"]:
                inp = nodes[j]
                if inp is None:
                    raise SerializeError(f"node {i} references unbuilt input {j}")
                inputs.append(inp)
            nodes[i] = Apply(inputs, graphs[rec["g"]], rec.get("n", ""))
        else:
            raise SerializeError(f"stray parameter record at {i} (not owned by a graph)")
    for g, ge in zip(graphs, payload["graphs"]):
        ret = nodes[ge["ret"]]
        assert ret is not None
        g.set_return(ret)
    return graphs[0]


def dumps(root: Graph, *, names: bool = True, loose: bool = False) -> str:
    """Canonical JSON text of :func:`serialize_graph` (sorted keys, no
    whitespace — byte-stable across processes)."""
    return json.dumps(
        serialize_graph(root, names=names, loose=loose),
        sort_keys=True,
        separators=(",", ":"),
    )


def loads(text: str) -> Graph:
    return deserialize_graph(json.loads(text))


def structural_hash(root: Graph, *, loose: bool = False) -> str:
    """Hex content hash of the name-stripped canonical encoding.

    Stable across process runs and identical for structurally-identical
    graphs — the graph component of the AOT program-cache key.
    ``loose=True`` admits pre-optimization adjoint graphs (symbolic keys,
    empty gradient environments) — the graph component of the
    optimized-graph cache key (``ProgramCache.graph_key``)."""
    return hashlib.sha256(dumps(root, names=False, loose=loose).encode("utf-8")).hexdigest()
