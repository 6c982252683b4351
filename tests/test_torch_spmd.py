"""The port's SPMD tier (``repro_torch.core.spmd``) against the reference's.

Every case of ``tests/core/test_spmd.py`` (normalize, propagate, shard_graph,
fusion boundaries, the optimizer guard), each graph built in both packages
from the same program and the same numpy inputs, held to **exact** equality:
the ``SpmdPlan``'s specs (node by node, in topological order), post
collectives and stats; the per-shard graph's canonical encoding and
``structural_hash``; the in/out partitions (the reference's
``PartitionSpec``s as tuples); the local abstracts; the per-shard
``FusionPlan`` (clusters, members, kinds, shapes, bytes, launch counts).
Propagation and the transform are pure graph passes: mesh axes are plain
``{name: size}`` dicts, no ranks needed.

Then, in this process on a gloo world of one (``file://`` rendezvous under
``tmp_path``): the 1×1-mesh identity (the per-shard program equals the
single-device lowering **bitwise**, unfused and fused), the API dispatch
through ``mesh_context`` and its ``SpmdError`` fallback, and an abstract
mesh that does not engage the tier.  Multi-rank execution is
``tests/test_torch_spmd_exec.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as R
import repro.core.primitives as RP
import repro_torch.core as T
import repro_torch.core.primitives as TP
from repro.core import api as R_api
from repro.core import fusion as R_fusion
from repro.core import serialize as R_ser
from repro.core import spmd as R_spmd
from repro.core.infer import abstract_of_value as R_abstract
from repro.kernels import codegen as R_codegen
from repro_torch.core import api as T_api
from repro_torch.core import fusion as T_fusion
from repro_torch.core import serialize as T_ser
from repro_torch.core import spmd as T_spmd
from repro_torch.core.infer import abstract_of_value as T_abstract
from repro_torch.kernels import codegen as T_codegen

AXES = {"data": 2, "model": 2}


def _two_layer(P):
    def two_layer(w1, w2, x):
        h = P.tanh(x @ w1)
        return P.reduce_sum(P.tanh(h @ w2), (0, 1), False)

    return two_layer


def _chain(P):
    def chain(x):
        s = P.reduce_sum(P.tanh(x) * P.sigmoid(x) + 1.0, (0,), True)
        return P.reduce_sum(P.exp(s) * 2.0, (0, 1), False)

    return chain


def _emb_loss(P):
    def emb_loss(emb, w, toks):
        h = P.take(emb, toks)
        h = P.tanh(h @ w)
        return P.reduce_sum(h * h, (0, 1, 2), False)

    return emb_loss


def _cross_shard(P):
    def cross_shard(a, b):
        return P.reduce_sum(a * b, (0, 1), False)

    return cross_shard


def _mlp_args(b=8, d=16):
    rng = np.random.default_rng(0)
    return (
        (rng.standard_normal((d, d)) * 0.1).astype(np.float32),
        (rng.standard_normal((d, d)) * 0.1).astype(np.float32),
        rng.standard_normal((b, d)).astype(np.float32),
    )


def _args(name):
    rng = np.random.default_rng(1)
    if name == "chain":
        return (rng.standard_normal((8, 16)).astype(np.float32),)
    if name == "emb":
        return ((rng.standard_normal((32, 16)) * 0.5).astype(np.float32),
                (rng.standard_normal((16, 16)) * 0.1).astype(np.float32),
                rng.integers(0, 32, (4, 8)).astype(np.int32))
    if name == "cross":
        return _mlp_args()[:2]
    return _mlp_args()


#: workload → (program factory, gradient wrt or None)
PROGRAMS = {
    "mlp_grad": (_two_layer, (0, 1)),
    "mlp_fwd": (_two_layer, None),
    "chain": (_chain, None),
    "emb": (_emb_loss, (0, 1)),
    "cross": (_cross_shard, None),
}

#: (workload, in_specs): every spec test_spmd.py uses, and the exec corpus's
CASES = {
    "dp": ("mlp_grad", (None, None, ("data",))),
    "megatron": ("mlp_grad", (("model",), (None, "model"), ("data",))),
    "replicated": ("mlp_grad", (None, None, None)),
    "fwd_dp": ("mlp_fwd", (None, None, ("data",))),
    "chain_dp": ("chain", (("data",),)),
    "chain_2d": ("chain", (("data", "model"),)),
    "emb_dp": ("emb", (None, None, ("data",))),
    "cross_reshard": ("cross", (("data", None), (None, "data"))),
}


def _graph(pkg, name, arrs):
    core, P, api, abstract = pkg
    make, wrt = PROGRAMS[name]
    g = core.parse_function(make(P))
    if wrt is not None:
        g = core.build_grad_graph(g, wrt)
    return api.compile_pipeline(g, tuple(abstract(a) for a in arrs))


REF = (R, RP, R_api, R_abstract)
PORT = (T, TP, T_api, T_abstract)


def _pair(case):
    name, specs = CASES[case]
    arrs = _args(name)
    jarrs = tuple(__import__("jax").numpy.asarray(a) for a in arrs)
    targs = tuple(torch.from_numpy(a.copy()) for a in arrs)
    return _graph(REF, name, jarrs), _graph(PORT, name, targs), specs


def _render(spec, spmd):
    if spec is spmd._SCALAR or spec == spmd._SCALAR:
        return "scalar"
    if isinstance(spec, spmd._TSpec):
        return [_render(e, spmd) for e in spec.elements]
    return [list(dim) for dim in spec]


def _plan_table(plan, g, spmd, ir):
    rows = []
    for n in ir.toposort(g):
        if isinstance(n, ir.Apply):
            rows.append((n.fn.value.name, _render(plan.spec_of(n), spmd),
                         plan.post.get(n._id)))
    return rows


def _ref_partition(p):
    from jax.sharding import PartitionSpec

    if isinstance(p, PartitionSpec):
        return tuple(p)
    return tuple(_ref_partition(e) for e in p)


def _fusion(fusion, codegen, g):
    plan = fusion.partition_graph(g)
    clusters = []
    for c in plan.clusters:
        kernel, reason = codegen.emit_cluster_explained(c)
        clusters.append((
            c.kind, tuple(c.body_shape), tuple(c.out_shape), str(c.out_dtype),
            tuple(n.fn.value.name for n in c.order), len(c.inputs),
            None if reason is None else reason.kind,
            None if kernel is None else kernel.bytes_moved,
        ))
    return clusters, plan.stats()


def _prims(g, ir):
    return [n.fn.value.name for n in g.nodes()
            if isinstance(n, ir.Apply) and isinstance(n.fn, ir.Constant)]


# -- normalize --------------------------------------------------------------------

NORMALIZE = [
    # (spec, shape, expected) — test_spmd.py's TestNormalize
    ((("data",), ("model",)), (6, 3), (("data",), ())),  # 3 % 2: replicated
    ((("pod",), None), (8, 8), ((), ())),  # unknown axis dropped
    ((("data",), ("data",)), (8, 8), (("data",), ())),  # an axis used once
    (None, (8, 8), ((), ())),
    (("data", None), (8, 8), (("data",), ())),  # a partition tuple
    ((("data", "model"),), (8, 4), (("data", "model"), ())),
    (("model", "data"), (4, 6), (("model",), ("data",))),
]


@pytest.mark.parametrize("spec,shape,want", NORMALIZE)
def test_normalize_spec(spec, shape, want):
    got = T_spmd.normalize_spec(spec, _t_aarray(shape), AXES)
    assert got == want
    assert got == R_spmd.normalize_spec(spec, _r_aarray(shape), AXES)


def _t_aarray(shape):
    from repro_torch.core.infer import AArray

    return AArray(np.float32, shape)


def _r_aarray(shape):
    from repro.core.infer import AArray

    return AArray(np.float32, shape)


def test_partition_roundtrip():
    from jax.sharding import PartitionSpec as PS

    spec = T_spmd.normalize_spec(None, _t_aarray((8, 8)), AXES)
    assert T_spmd.spec_to_partition(spec) == (None, None) == tuple(PS(None, None))
    two = (("data", "model"), ())
    assert T_spmd.spec_to_partition(two) == tuple(R_spmd.spec_to_partition(two))
    assert T_spmd.normalize_spec(T_spmd.spec_to_partition(two), _t_aarray((8, 8)), AXES) == two


# -- propagate --------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_propagate_plan_equal(case):
    rg, tg, specs = _pair(case)
    assert T_ser.structural_hash(tg) == R_ser.structural_hash(rg)
    rp, tp = R_spmd.propagate(rg, specs, AXES), T_spmd.propagate(tg, specs, AXES)
    assert tp.stats == rp.stats
    assert [_render(s, T_spmd) for s in tp.in_specs] == [_render(s, R_spmd) for s in rp.in_specs]
    assert _render(tp.out_spec, T_spmd) == _render(rp.out_spec, R_spmd)
    assert _plan_table(tp, tg, T_spmd, T.ir) == _plan_table(rp, rg, R_spmd, R.ir)


def test_propagate_stats_as_the_reference_tests_read_them():
    _, dp, specs = _pair("dp")
    plan = T_spmd.propagate(dp, specs, AXES)
    # both weight grads contract over the sharded batch -> 2 psums
    assert plan.stats["n_psum"] == 2 and plan.stats["params_sharded"] == 1
    assert plan.stats["nodes_sharded"] > plan.stats["nodes"] // 2
    _, tp, specs = _pair("megatron")
    assert T_spmd.propagate(tp, specs, AXES).stats["n_psum"] >= 3
    _, rep, specs = _pair("replicated")
    stats = T_spmd.propagate(rep, specs, AXES).stats
    assert stats["n_psum"] == 0 and stats["nodes_sharded"] == 0


def test_arity_mismatch_raises_in_both():
    rg, tg, _ = _pair("dp")
    with pytest.raises(R_spmd.SpmdError):
        R_spmd.propagate(rg, (None, None), AXES)
    with pytest.raises(T_spmd.SpmdError):
        T_spmd.propagate(tg, (None, None), AXES)


# -- shard_graph ------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_graph_equal(case):
    rg, tg, specs = _pair(case)
    rs, ts = R_spmd.shard_graph(rg, specs, AXES), T_spmd.shard_graph(tg, specs, AXES)
    assert T_ser.dumps(ts.graph, names=False) == R_ser.dumps(rs.graph, names=False)
    assert T_ser.structural_hash(ts.graph) == R_ser.structural_hash(rs.graph)
    assert ts.stats == rs.stats
    assert ts.in_partition == _ref_partition(rs.in_partition)
    assert ts.out_partition == _ref_partition(rs.out_partition)
    assert repr(ts.local_abstracts) == repr(rs.local_abstracts)
    assert [repr(n.abstract) for n in T.ir.toposort(ts.graph)] == \
        [repr(n.abstract) for n in R.ir.toposort(rs.graph)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_shard_fusion_plan_equal(case):
    rg, tg, specs = _pair(case)
    rs, ts = R_spmd.shard_graph(rg, specs, AXES), T_spmd.shard_graph(tg, specs, AXES)
    assert _fusion(T_fusion, T_codegen, ts.graph) == _fusion(R_fusion, R_codegen, rs.graph)
    assert T.lower_graph(ts.graph, fuse=True).__fusion_plan__.stats() == \
        R.lower_graph(rs.graph, fuse=True).__fusion_plan__.stats()


def test_collectives_inserted_and_shapes_localized():
    _, g, specs = _pair("dp")
    sg = T_spmd.shard_graph(g, specs, AXES)
    assert _prims(sg.graph, T.ir).count("psum_axes") == 2
    # the scalar cotangent's unreduce targets the LOCAL batch block
    unreduce = [n for n in sg.graph.nodes()
                if isinstance(n, T.ir.Apply) and n.fn.value.name == "unreduce"]
    assert unreduce and unreduce[0].args[1].value == (4, 16)
    assert unreduce[0].abstract.shape == (4, 16)
    assert sg.stats["all_gather"] == 0 and sg.stats["shard_slice"] == 0
    assert sg.out_partition == ((None, None), (None, None))


def test_non_first_order_graph_raises():
    def rec(n):
        if n <= 0:
            return 0
        return rec(n - 1)

    g_raw = T_api.compile_pipeline(T.parse_function(rec), None,
                                   options=T_api.CompileOptions(opt=False))
    with pytest.raises(T_spmd.SpmdError):
        T_spmd.shard_graph(g_raw, ((),), AXES)


# -- fusion boundaries, optimizer guard -------------------------------------------


@pytest.mark.parametrize("case", ["dp", "chain_dp", "megatron"])
def test_no_cluster_spans_a_resharding_point(case):
    _, g, specs = _pair(case)
    sg = T_spmd.shard_graph(g, specs, AXES)
    coll = [n for n in sg.graph.nodes()
            if isinstance(n, T.ir.Apply) and n.fn.value.name in T_fusion.COLLECTIVES]
    assert coll and all(T_fusion.classify(n) == "opaque" for n in coll)
    plan = T_fusion.partition_graph(sg.graph)
    assert plan.clusters
    ids = {n._id for n in coll}
    for c in plan.clusters:
        assert not (c.members & ids)


def test_optimizer_never_touches_collectives():
    rg, tg, specs = _pair("dp")
    rs, ts = R_spmd.shard_graph(rg, specs, AXES), T_spmd.shard_graph(tg, specs, AXES)
    before = _prims(ts.graph, T.ir).count("psum_axes")
    T.optimize(ts.graph)
    R.optimize(rs.graph)
    assert _prims(ts.graph, T.ir).count("psum_axes") == before
    assert T_ser.structural_hash(ts.graph) == R_ser.structural_hash(rs.graph)


# -- the mesh layer ----------------------------------------------------------------


def test_mesh_context_spec_and_the_gspmd_calls():
    from repro_torch import parallel

    mesh = parallel.abstract_mesh((2, 4), ("data", "model"))
    with parallel.mesh_context(mesh, {}) as ctx:
        assert ctx.spec(("batch", None, "vocab")) == ("data", None, "model")
        # batch 3 does not divide by data=2: replicated
        assert ctx.spec(("batch", "mlp"), (3, 8)) == (None, "model")
        # under a mesh, constrain places DTensors; a plain tensor passes through
        assert parallel.constrain(y := torch.ones(2), "batch") is y
        assert parallel.logical_to_spec(("batch",)) == ("data",)
    assert parallel.constrain(x := torch.ones(2), "batch") is x
    assert parallel.logical_to_spec(("batch",)) == ()
    assert parallel.named_sharding(("batch",)) is None


def test_meshes_that_wait_or_do_not_fit_raise():
    from repro_torch.launch import mesh as launch_mesh

    # the production mesh is built (in a fake world of its own process) by
    # tests/test_torch_dryrun.py; a local mesh needs as many ranks as it has blocks
    assert launch_mesh.FAKE_WORLD == 512
    with pytest.raises(ValueError, match="2 ranks"):
        launch_mesh.make_local_mesh(2, 1, device="cpu")


@pytest.mark.parametrize("device, world, local, cards, want", [
    ("cpu", 2, "2", 8, "gloo"),
    ("cuda", 1, None, 1, "nccl"),
    ("cuda", 2, "2", 1, "gloo"),        # two ranks sharing one card
    ("cuda", 2, None, 1, "gloo"),       # no LOCAL_WORLD_SIZE: the world is on one node
    ("cuda", 16, "8", 8, "nccl"),       # 2 nodes x 8 cards, a card per rank
    ("cuda", 16, None, 8, "gloo"),
    ("cuda", 4, "4", 2, "gloo"),
])
def test_pick_backend_counts_the_ranks_of_this_node(monkeypatch, device, world, local, cards,
                                                    want):
    from repro_torch.launch import mesh as launch_mesh

    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert launch_mesh.pick_backend(torch.device(device), world) == want


def test_collectives_raise_outside_a_per_shard_program():
    for name in sorted(TP.COLLECTIVE_NAMES):
        extra = () if name in ("psum_axes", "pmax_axes") else (0, (1,))
        with pytest.raises(RuntimeError, match="per-shard program"):
            TP.PRIMITIVES[name].impl(torch.ones(2), ("data",), *extra)


# -- a gloo world of one in this process -------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank (file:// rendezvous: no port to collide
    on under xdist), torn down after the test."""
    from repro_torch.launch.mesh import make_local_mesh

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        yield make_local_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", ["dp", "megatron", "chain_2d", "emb_dp", "cross_reshard"])
def test_mesh_1x1_identity(world_of_one, case, fuse):
    """On a 1×1 mesh the per-shard program computes what the single-device
    lowering computes, bitwise (psum over one rank is the identity)."""
    rg, g, specs = _pair(case)
    name = CASES[case][0]
    args = tuple(torch.from_numpy(a.copy()) for a in _args(name))
    want = T.lower_graph(g, fuse=fuse)(*args)
    run = T.compile_graph_spmd(g, world_of_one, specs, fuse=fuse)
    assert run.spmd
    got = run(*args)
    for a, b in zip(_flat(got), _flat(want), strict=True):
        assert torch.equal(a, b)
    # and the reference's single-device values, within the f32 tolerance
    import jax

    ref = jax.jit(R.lower_graph(rg))(*(jax.numpy.asarray(a) for a in _args(name)))
    for a, b in zip(_flat(got), _flat(ref), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-5, atol=1e-6)


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


def test_api_dispatch_and_fallback(world_of_one):
    from repro_torch.parallel import mesh_context

    args = tuple(torch.from_numpy(a.copy()) for a in _mlp_args())
    vag = T_api.value_and_grad(_two_layer(TP), (0, 1),
                               options=T_api.CompileOptions(in_specs=(None, None, ("data",))))
    loss0, grads0 = vag(*args)
    assert not getattr(vag.specialize(args), "spmd", False)
    with mesh_context(world_of_one, {}):
        loss1, grads1 = vag(*args)
        assert vag.specialize(args).spmd
        report = vag.explain(*args)
        assert report["sharding"]["verdict"] == "sharded"
    assert torch.equal(loss0, loss1)
    for a, b in zip(grads0, grads1, strict=True):
        assert torch.equal(a, b)

    # SpmdError (here: a non-array argument's spec) gives way to the single-device tier
    def scale(x, k):
        return x * k

    f = T_api.myia(scale, options=T_api.CompileOptions(in_specs=(("data",), ("data",))))
    with mesh_context(world_of_one, {}):
        runner = f.specialize((args[0], 2.0))
        assert not getattr(runner, "spmd", False)
        assert torch.equal(runner(args[0], 2.0), args[0] * 2.0)


def test_abstract_mesh_context_does_not_engage_spmd():
    from repro_torch.parallel import abstract_mesh, mesh_context

    args = tuple(torch.from_numpy(a.copy()) for a in _mlp_args())
    vag = T_api.value_and_grad(_two_layer(TP), (0, 1),
                               options=T_api.CompileOptions(in_specs=(None, None, ("data",))))
    with mesh_context(abstract_mesh((16, 16), ("data", "model")), {}):
        runner = vag.specialize(args)
    assert not getattr(runner, "spmd", False)


def test_collectives_run_under_their_profiler_labels(world_of_one):
    """Each collective call is one ``repro.*`` range in a ``torch.profiler`` trace,
    which is how a trace sums a step's time in them."""
    from repro_torch import parallel

    group = parallel.axis_group(world_of_one, ("data", "model"))
    x = torch.arange(6.0).reshape(2, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s = parallel.all_reduce(x, "sum", group)
        m = parallel.all_reduce(x, "max", group)
        g = parallel.all_gather(x, 1, group)
    assert torch.equal(s, x) and torch.equal(m, x) and torch.equal(g, x)
    names = [e.name for e in prof.events() if e.name.startswith("repro.")]
    assert sorted(names) == ["repro.all_gather", "repro.all_reduce.max", "repro.all_reduce.sum"]


def test_mesh_descriptor_keys_the_program_cache(world_of_one, tmp_path):
    from repro_torch.core.torch_backend import ProgramCache, mesh_descriptor

    desc = mesh_descriptor(world_of_one)
    assert desc == ((("data", 1), ("model", 1)), (0,), "cpu")
    _, g, _ = _pair("dp")
    args = tuple(torch.from_numpy(a.copy()) for a in _mlp_args())
    cache = ProgramCache(str(tmp_path / "pc"))
    assert cache.key(g, args, mesh=world_of_one) != cache.key(g, args)
