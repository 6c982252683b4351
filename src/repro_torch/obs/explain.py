"""Compile-decision explain layer: "why did the compiler do that?".

Every tier of the pipeline makes silent decisions — the fusion
partitioner declines a region, the SPMD propagator replicates a dim, the
cache tier misses, a loop adjoint picks a checkpoint policy, a residual
closure forces the VM — and until now the only way to see them was to
read four subsystems' internals.  :func:`explain_graph` (surfaced as
``MyiaFunction.explain(*example_args)``) runs the real pipeline on a
private clone and returns one structured, JSON-serializable
:class:`ExplainReport`:

* **fusion** — per-cluster verdict (``emitted`` / ``declined`` with a
  structured :class:`~repro_torch.core.fusion.DeclineReason`) and a per-node
  decision (``fused`` into which cluster, or ``unfused`` with a reason
  object — never a bare string),
* **sharding** — the per-node spec table the SPMD propagator settled on
  (params, nodes with their post-collectives, out spec), or the structured
  reason the tier did not engage,
* **cache** — graph-tier and exec-tier verdicts (``graph-hit`` / ``miss``
  / ``exec-hit`` / ``cold`` / ``unkeyable`` / ``disabled``) with the keys,
* **loops** — the checkpoint policy and slot budget each structured-loop
  adjoint will record with,
* **fallback** — the residual :class:`~repro_torch.core.closure.FallbackReason`
  list when the graph stays on the VM,
* **phases** — the compile-phase wall-time breakdown from a private
  tracer armed for the run.

``dump_ir="dir/"`` additionally writes the IR after every pipeline stage
as deterministic, diffable text (``00-input.ir``, ``01-cloned.ir``, …)
printed by :func:`format_graph` — names assigned in topological order, so
two dumps of structurally equal graphs are textually equal.

The port of ``repro/obs/explain.py``: the same report, section by section.
All ``repro_torch.core`` imports are function-local, so core modules import
``repro_torch.obs`` freely.
"""

from __future__ import annotations

import json
import os
from typing import Any

__all__ = [
    "ExplainReport",
    "explain_function",
    "explain_graph",
    "format_graph",
]


# ---------------------------------------------------------------------------
# Deterministic IR printer (the dump_ir format)
# ---------------------------------------------------------------------------


def _fmt_abstract(ab: Any) -> str:
    return "?" if ab is None else repr(ab)


def _node_names(graph: Any) -> dict[int, str]:
    """Stable names for one graph: ``p{i}`` parameters, ``v{i}`` applies in
    topological order — the same scheme the lowering emits, so an explain
    report and a lowered source line up."""
    from repro_torch.core.ir import Apply, toposort

    names: dict[int, str] = {}
    for i, p in enumerate(graph.parameters):
        names[p._id] = f"p{i}"
    seq = 0
    for n in toposort(graph):
        if isinstance(n, Apply):
            names[n._id] = f"v{seq}"
            seq += 1
    return names


def format_graph(graph: Any) -> str:
    """Print ``graph`` (and every sub-graph constant it references,
    breadth-first) as deterministic text: one assignment per apply in
    topological order, abstracts as trailing comments.  Structurally equal
    graphs print equal text — the property that makes ``dump_ir`` stage
    dumps diffable."""
    from repro_torch.core.ir import Apply, Constant, Graph, toposort

    queue = [graph]
    seen = {id(graph)}
    blocks: list[str] = []
    while queue:
        g = queue.pop(0)
        names = _node_names(g)

        def ref(node: Any) -> str:
            got = names.get(node._id)
            if got is not None:
                return got
            if isinstance(node, Constant):
                if isinstance(node.value, Graph):
                    if id(node.value) not in seen:
                        seen.add(id(node.value))
                        queue.append(node.value)
                    return f"@{node.value.name}"
                return repr(node.value)
            return f"<foreign:{node!r}>"  # free variable: owned elsewhere

        params = ", ".join(
            f"{names[p._id]}: {_fmt_abstract(p.abstract)}" for p in g.parameters
        )
        lines = [f"graph {g.name}({params}):"]
        for n in toposort(g):
            if not isinstance(n, Apply):
                continue
            fn = n.fn
            if isinstance(fn, Constant) and hasattr(fn.value, "name"):
                callee = fn.value.name
            else:
                callee = ref(fn)
            args = ", ".join(ref(a) for a in n.args)
            lines.append(
                f"  {names[n._id]} = {callee}({args})"
                f"  # {_fmt_abstract(n.abstract)}"
            )
        lines.append(f"  return {ref(g.return_)}")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks) + "\n"


# ---------------------------------------------------------------------------
# The report object
# ---------------------------------------------------------------------------


class ExplainReport:
    """A structured compile report: plain JSON-serializable data plus
    terminal/text renderers.  ``as_dict()`` → ``to_json()`` →
    ``from_json()`` round-trips exactly (pinned by tests)."""

    __slots__ = ("data",)

    def __init__(self, data: dict) -> None:
        self.data = data

    def __getitem__(self, key: str) -> Any:
        return self.data[key]

    def as_dict(self) -> dict:
        return self.data

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.data, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExplainReport":
        return cls(json.loads(text))

    def summary(self) -> str:
        """The terminal view: one line per decision domain, then the
        non-obvious verdicts (declined clusters, unfused nodes, fallback
        reasons) spelled out."""
        d = self.data
        fus = d.get("fusion", {})
        lines = [f"explain: {d.get('program')}  sig={d.get('signature')}"]
        if fus.get("enabled"):
            nodes = fus.get("nodes", [])
            fused = sum(1 for n in nodes if n["decision"] == "fused")
            lines.append(
                f"  fusion: {len(fus.get('clusters', []))} clusters, "
                f"{fused}/{len(nodes)} applies fused"
            )
            for c in fus.get("clusters", []):
                if c["verdict"] != "emitted":
                    r = c.get("reason", {})
                    lines.append(
                        f"    cluster {c['cluster']} ({c['kind']}, size "
                        f"{c['size']}) declined: [{r.get('kind')}] {r.get('detail')}"
                    )
        else:
            r = fus.get("reason", {})
            lines.append(f"  fusion: off ([{r.get('kind')}] {r.get('detail')})")
        sh = d.get("sharding", {})
        lines.append(f"  sharding: {sh.get('verdict')}")
        for tier in d.get("cache", []):
            lines.append(f"  cache[{tier['tier']}]: {tier['verdict']}")
        for lp in d.get("loops", []):
            lines.append(
                f"  loop {lp['node']} ({lp['loop']}): checkpoint "
                f"{lp['checkpoint_policy']} ({lp['slots']} slots)"
            )
        fb = d.get("fallback", {})
        if fb.get("reasons"):
            for r in fb["reasons"]:
                lines.append(f"  vm-fallback: [{r.get('kind')}] {r.get('detail')}")
        else:
            lines.append("  lowers: straight-line (no VM fallback)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Section builders (each returns plain JSON data; reasons are dicts with
# at least {"kind", "detail"} — never bare strings)
# ---------------------------------------------------------------------------


def _reason(kind: str, detail: str) -> dict:
    return {"kind": kind, "detail": detail}


def _fusion_section(g: Any, options: Any) -> dict:
    if not options.fuse:
        return {
            "enabled": False,
            "reason": _reason(
                "fusion-disabled",
                "CompileOptions.fuse is False; every apply lowers as one "
                "torch launch",
            ),
        }
    from repro_torch.core.fusion import explain_partition
    from repro_torch.core.ir import Apply, toposort
    from repro_torch.kernels.codegen import emit_cluster_explained

    names = _node_names(g)
    plan, declines = explain_partition(g)
    clusters: list[dict] = []
    member_of: dict[int, int] = {}
    cluster_reason: dict[int, dict | None] = {}
    for i, c in enumerate(plan.clusters):
        kernel, reason = emit_cluster_explained(c)
        entry: dict[str, Any] = {
            "cluster": i,
            "kind": c.kind,
            "root": names.get(c.root._id, f"#{c.root._id}"),
            "size": len(c.members),
            "verdict": "emitted" if kernel is not None else "declined",
        }
        if kernel is not None:
            entry["name"] = kernel.name
            entry["bytes_moved"] = kernel.bytes_moved
        if reason is not None:
            entry["reason"] = reason.as_dict()
        clusters.append(entry)
        for m in c.members:
            member_of[m] = i
            cluster_reason[m] = reason.as_dict() if reason is not None else None
    nodes: list[dict] = []
    for n in toposort(g):
        if not isinstance(n, Apply):
            continue
        op = n.fn.value.name if hasattr(n.fn.value, "name") else repr(n.fn)
        row: dict[str, Any] = {"node": names[n._id], "op": op}
        ci = member_of.get(n._id)
        if ci is not None and cluster_reason[n._id] is None:
            row["decision"] = "fused"
            row["cluster"] = ci
        elif ci is not None:
            row["decision"] = "unfused"
            row["cluster"] = ci
            row["reason"] = cluster_reason[n._id]
        else:
            row["decision"] = "unfused"
            dr = declines.get(n._id)
            row["reason"] = (
                dr.as_dict()
                if dr is not None
                else _reason(
                    "unclassified",
                    "partitioner left this node out without a recorded reason",
                )
            )
        nodes.append(row)
    return {"enabled": True, "clusters": clusters, "nodes": nodes}


def _render_spec(spec: Any) -> Any:
    """A sharding spec as JSON: per-dim lists of mesh axis names,
    ``"scalar"`` for the non-array sentinel, nested lists for tuples."""
    from repro_torch.core.spmd import _SCALAR, _TSpec

    if spec == _SCALAR:
        return "scalar"
    if isinstance(spec, _TSpec):
        return [_render_spec(e) for e in spec.elements]
    if spec is None:
        return None
    return [list(dim) for dim in spec]


def _sharding_section(g: Any, options: Any) -> dict:
    if options.in_specs is None:
        return {
            "verdict": "unsharded",
            "reason": _reason(
                "no-in-specs", "CompileOptions.in_specs not set; SPMD tier inert"
            ),
        }
    from repro_torch.parallel import current_mesh_context, is_concrete, mesh_axes

    ctx = current_mesh_context()
    if ctx is None or not is_concrete(ctx.mesh):
        return {
            "verdict": "unsharded",
            "reason": _reason(
                "no-active-mesh",
                "in_specs configured but no concrete mesh context is active",
            ),
        }
    from repro_torch.core.ir import Apply, toposort
    from repro_torch.core.spmd import SpmdError, propagate

    axes = mesh_axes(ctx.mesh)
    try:
        plan = propagate(g, options.in_specs, axes)
    except SpmdError as e:
        return {
            "verdict": "fallback-single-device",
            "mesh": axes,
            "reason": _reason("spmd-error", str(e)),
        }
    names = _node_names(g)
    params = [
        {"param": names[p._id], "spec": _render_spec(plan.spec_of(p))}
        for p in g.parameters
    ]
    nodes = []
    for n in toposort(g):
        if not isinstance(n, Apply):
            continue
        op = n.fn.value.name if hasattr(n.fn.value, "name") else repr(n.fn)
        row = {"node": names[n._id], "op": op, "spec": _render_spec(plan.spec_of(n))}
        post = plan.post.get(n._id)
        if post:
            row["post"] = [[kind, list(axes_)] for kind, axes_ in post]
        nodes.append(row)
    return {
        "verdict": "sharded",
        "mesh": axes,
        "params": params,
        "nodes": nodes,
        "out_spec": _render_spec(plan.out_spec),
    }


def _graph_cache_tier(base: Any, abstracts: tuple | None, options: Any) -> dict:
    """The graph-tier verdict, probed read-only.  Must run BEFORE the
    pipeline: the explain run itself stores into the graph cache on a
    miss, so probing afterwards could never report ``miss``."""
    gcache = options.graph_cache
    if gcache is None:
        return {"tier": "graph", "verdict": "disabled"}
    if abstracts is None:
        return {
            "tier": "graph",
            "verdict": "unkeyable",
            "reason": _reason("no-abstracts", "argument abstracts unavailable"),
        }
    from repro_torch.core.serialize import SerializeError

    try:
        gkey = gcache.graph_key(
            base, abstracts, opt=options.opt, patterns=options.patterns
        )
    except SerializeError as e:
        return {
            "tier": "graph",
            "verdict": "unkeyable",
            "reason": _reason("serialize-error", str(e)),
        }
    return {
        "tier": "graph",
        "verdict": "graph-hit" if gcache.probe_graph(gkey) else "miss",
        "key": gkey,
    }


def _cache_section(
    graph_tier: dict, g: Any, example_args: tuple, options: Any
) -> list[dict]:
    """Graph-tier (pre-computed) then exec-tier verdicts, read-only
    (``probe``: no stats mutation, no entry load — explain never warms
    the caches it reports on, except through the pipeline run itself)."""
    tiers: list[dict] = [graph_tier]
    pcache = options.program_cache
    if pcache is None:
        tiers.append({"tier": "exec", "verdict": "disabled"})
    else:
        from repro_torch.core.serialize import SerializeError

        try:
            key = pcache.key(g, example_args, fuse=options.fuse)
        except SerializeError as e:
            tiers.append({
                "tier": "exec",
                "verdict": "unkeyable",
                "reason": _reason("serialize-error", str(e)),
            })
        else:
            tiers.append({
                "tier": "exec",
                "verdict": "exec-hit" if pcache.probe(key) else "cold",
                "key": key,
            })
    return tiers


def _loops_section(g: Any, options: Any) -> list[dict]:
    from repro_torch.core.ad import _policy_slots
    from repro_torch.core.ir import Apply, Constant, Graph, toposort
    from repro_torch.core.primitives import LOOP_GRAPH_ARGS

    policy = options.checkpoint_policy
    out: list[dict] = []
    queue = [g]
    seen = {id(g)}
    while queue:
        cur = queue.pop(0)
        names = _node_names(cur)
        for n in toposort(cur):
            if not isinstance(n, Apply):
                continue
            prim = n.fn.value if isinstance(n.fn, Constant) else None
            pname = getattr(prim, "name", None)
            if pname in LOOP_GRAPH_ARGS:
                out.append({
                    "graph": cur.name,
                    "node": names[n._id],
                    "loop": pname,
                    "checkpoint_policy": str(policy),
                    "slots": _policy_slots(policy),
                })
            for a in n.args:
                if (
                    isinstance(a, Constant)
                    and isinstance(a.value, Graph)
                    and id(a.value) not in seen
                ):
                    seen.add(id(a.value))
                    queue.append(a.value)
    return out


def _fallback_section(g: Any, options: Any) -> dict:
    from repro_torch.core.closure import analyze_blockers

    reasons = [r.as_dict() for r in analyze_blockers(g)]
    out = {"lowers": not reasons, "reasons": reasons}
    if options.backend == "vm":
        out["lowers"] = False
        out.setdefault("reasons", []).append(
            _reason("backend-vm", "CompileOptions.backend forces the reference VM")
        )
    return out


def _options_section(options: Any) -> dict:
    return {
        "backend": options.backend,
        "opt": options.opt,
        "fuse": options.fuse,
        "patterns": options.patterns,
        "profile": getattr(options, "profile", False),
        "checkpoint_policy": str(options.checkpoint_policy),
        "in_specs": repr(options.in_specs) if options.in_specs is not None else None,
        "program_cache": options.program_cache is not None,
        "graph_cache": options.graph_cache is not None,
    }


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def explain_graph(
    graph: Any,
    example_args: tuple,
    options: Any = None,
    *,
    name: str | None = None,
    dump_ir: str | None = None,
) -> ExplainReport:
    """Run the real pipeline on ``graph`` at ``example_args`` and explain
    every compile decision.  ``options`` is a
    :class:`~repro_torch.core.api.CompileOptions` (defaults constructed when
    None); ``dump_ir`` writes per-stage IR text into that directory."""
    from repro_torch.core.api import CompileOptions, compile_pipeline
    from repro_torch.core.infer import InferenceError, abstract_of_value
    from repro_torch.obs import trace as obs_trace

    if options is None:
        options = CompileOptions()
    try:
        abstracts = tuple(abstract_of_value(a) for a in example_args)
    except InferenceError:
        abstracts = None

    stages: list[tuple[str, str]] = [("input", format_graph(graph))]

    def snap(stage: str, g: Any) -> None:
        stages.append((stage, format_graph(g)))

    tracer = obs_trace.Tracer()
    with obs_trace.tracing(tracer):
        with obs_trace.span("explain.report", graph=graph.name):
            graph_tier = _graph_cache_tier(graph, abstracts, options)
            g = compile_pipeline(graph, abstracts, options=options, snapshot=snap)
            fusion = _fusion_section(g, options)
            sharding = _sharding_section(g, options)
            cache = _cache_section(graph_tier, g, example_args, options)
            loops = _loops_section(g, options)
            fallback = _fallback_section(g, options)

    data = {
        "program": name or graph.name,
        "signature": [repr(a) for a in abstracts] if abstracts is not None else None,
        "options": _options_section(options),
        "phases_ms": tracer.phase_totals_ms(),
        "fusion": fusion,
        "sharding": sharding,
        "cache": cache,
        "loops": loops,
        "fallback": fallback,
        "ir_stages": [s for s, _ in stages],
    }
    if dump_ir is not None:
        os.makedirs(dump_ir, exist_ok=True)
        paths = []
        for i, (stage, text) in enumerate(stages):
            p = os.path.join(dump_ir, f"{i:02d}-{stage}.ir")
            with open(p, "w", encoding="utf-8") as f:
                f.write(text)
            paths.append(p)
        data["ir_dumps"] = paths
    return ExplainReport(data)


def explain_function(
    fn: Any, example_args: tuple, *, dump_ir: str | None = None
) -> ExplainReport:
    """Explain a :class:`~repro_torch.core.api.MyiaFunction` at a concrete call
    signature — resolves pending AD transforms exactly like
    ``specialize`` does, so the report describes the graph that would
    actually compile."""
    from repro_torch.core.infer import InferenceError, abstract_of_value

    try:
        example = tuple(abstract_of_value(a) for a in example_args)
    except InferenceError:
        example = None
    base = fn._resolved_graph(example) if fn.transforms else fn.graph
    return explain_graph(
        base, example_args, fn.options, name=fn.__name__, dump_ir=dump_ir
    )
