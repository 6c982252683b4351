"""The port's sharding specs against the reference's, exactly.

``repro_torch.distributed.sharding`` (``param_specs``, ``tree_specs``,
``batch_specs``, ``_moe_fallback``), ``repro_torch.distributed.cache_shardings``'
resolver and ``MeshContext.spec`` are backend-free logic: they must equal the
reference's leaf by leaf, for all ten archs at their full configs, on the
reference's abstract 16×16 and 2×16×16 meshes, with the AdamW and Adafactor states
included.  The reference side is ``jax.eval_shape``; the port side runs on
``meta`` tensors (``models.model.abstract_params``), so nothing is allocated.

The reference stacks the layers of a scanned segment into one leaf; the port
keeps one leaf per layer (``models/convert.py::params_from_jax``).  A port
layer's leaf is compared with the reference's stacked leaf through the same
mapping (segment, position in the pattern, repeat), its spec with the
reference's spec without the leading stacking dim.

Also here: the cell half of ``configs`` (``ShapeCell``, ``SHAPES``,
``cells_for``, ``input_specs``, ``cache_specs``) against the reference's shapes
and dtypes, and the GSPMD calls of ``parallel`` under an abstract mesh.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as RC
import repro.distributed as RD
import repro.distributed.sharding as RS
import repro.models as RM
import repro.optim as RO
import repro.parallel as RPar
import repro_torch.configs as TC
import repro_torch.distributed as TD
import repro_torch.distributed.sharding as TS
import repro_torch.optim as TO
import repro_torch.parallel as TPar
from repro_torch import tree as T
from repro_torch.models.model import abstract_params, encoder_config, stacked_layer_groups

ARCHS = sorted(TC.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _contexts(arch: str, mesh: str):
    sizes, names = MESHES[mesh]
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    return (rcfg, RPar.MeshContext(RPar.abstract_mesh(sizes, names), RS.make_rules(rcfg)),
            tcfg, TPar.MeshContext(TPar.abstract_mesh(sizes, names), TS.make_rules(tcfg)))


def _norm(spec, ndim: int) -> tuple:
    """A reference PartitionSpec as a tuple of one entry per dim."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _ref_leaves(tree, specs) -> dict:
    """{path of str keys: (shape, spec tuple)} of a reference tree and its specs."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sleaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(flat) == len(sleaves)
    out = {}
    for (path, leaf), s in zip(flat, sleaves):
        key = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = (tuple(leaf.shape), _norm(s, len(leaf.shape)))
    return out


def _layer_map(cfg) -> list[tuple[int, int, int | None]]:
    """Port layer index → (segment, position in its pattern, repeat or None when
    the segment is not stacked), in ``params_from_jax``'s order."""
    out = []
    for s, (pattern, reps) in enumerate(cfg.scan_segments()):
        for r in range(reps):
            for j in range(len(pattern)):
                out.append((s, j, r if reps > 1 else None))
    return out


def _ref_path(cfg, path: tuple) -> tuple[tuple, bool]:
    """The reference path of a port leaf path (any wrapper prefix and suffix kept),
    and whether the reference stacks it."""
    keys = [str(k) for k in path]
    if "layers" not in keys:
        return tuple(keys), False
    i = keys.index("layers")
    enc = i > 0 and keys[i - 1] == "encoder"
    s, j, r = _layer_map(encoder_config(cfg) if enc else cfg)[int(keys[i + 1])]
    return tuple(keys[:i] + ["segments", str(s), "layers", str(j)] + keys[i + 2:]), r is not None


def _compare(cfg, port_tree, port_specs, ref: dict, what: str) -> int:
    n = 0
    specs = T.leaves(port_specs, is_leaf=TS._is_spec)
    pairs = list(T.leaves_with_paths(port_tree))
    assert len(pairs) == len(specs)
    for (path, leaf), spec in zip(pairs, specs, strict=True):
        rpath, stacked = _ref_path(cfg, path)
        rshape, rspec = ref[rpath]
        shape = tuple(leaf.shape)
        assert (rshape[1:] if stacked else rshape) == shape, (what, path, rshape, shape)
        want = rspec[1:] if stacked else rspec
        got = tuple(spec) + (None,) * (len(shape) - len(spec))
        assert got == want, (what, path, shape, got, want)
        n += 1
    return n


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = RC.get_config(arch)
            cache[arch] = jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))
        return cache[arch]

    return get


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_equal_the_reference(arch, mesh, ref_params):
    rcfg, rctx, tcfg, tctx = _contexts(arch, mesh)
    rp = ref_params(arch)
    tp = abstract_params(tcfg)
    rspecs = RS.param_specs(rcfg, rp, rctx)
    tspecs = TS.param_specs(tcfg, tp, tctx)
    n = _compare(tcfg, tp, tspecs, _ref_leaves(rp, rspecs), "params")
    assert n == len(T.leaves(tp))
    for name in ("adamw", "adafactor"):
        ropt = RO.make_optimizer(RO.OptConfig(name=name))
        rstate = jax.eval_shape(lambda: ropt.init(rp))
        topt = TO.make_optimizer(TO.OptConfig(name=name), layer_groups=stacked_layer_groups(tcfg))
        tstate = topt.init(tp)
        ref = _ref_leaves(rstate, RS.tree_specs(rspecs, rstate, rp))
        _compare(tcfg, tstate, TS.tree_specs(tspecs, tstate, tp), ref, name)
        if name == "adafactor":  # the factored rows and columns are replicated
            for path, spec in T.leaves_with_paths(TS.tree_specs(tspecs, tstate, tp),
                                                  is_leaf=TS._is_spec):
                if path[-1] in ("vr", "vc"):
                    assert all(e is None for e in spec), (path, spec)
    # the full state: params, optimizer and step, as state_shardings places it
    full = {"params": tp, "opt": TO.make_optimizer(TO.OptConfig()).init(tp),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}
    st = TD.state_partitions(tcfg, tctx, full)
    assert st["step"] == () and T.leaves(st["params"], is_leaf=TS._is_spec) == T.leaves(
        tspecs, is_leaf=TS._is_spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    rcfg, rctx, tcfg, tctx = _contexts(arch, mesh)
    for name in RC.cells_for(arch):
        rcell, tcell = RC.SHAPES[name.name], TC.SHAPES[name.name]
        rin, tin = RC.input_specs(rcfg, rcell), TC.input_specs(tcfg, tcell)
        rb, tb = RS.batch_specs(rctx, rin), TS.batch_specs(tctx, tin)
        for k in rin:
            assert tuple(tb[k]) + (None,) * (tin[k].ndim - len(tb[k])) == _norm(
                rb[k], len(rin[k].shape)), (k, tb[k], rb[k])
        if rcell.kind != "decode":
            continue
        rc, tc = RC.cache_specs(rcfg, rcell), TC.cache_specs(tcfg, tcell)
        rsh = RD.cache_shardings(rcfg, rctx, rc)
        ref = _ref_leaves(rc, jax.tree.map(lambda s: s.spec, rsh))
        n = _compare_cache(tcfg, tc, TD.cache_partitions(tcfg, tctx, tc), ref)
        assert n == len(T.leaves(tc))


def _compare_cache(cfg, caches, specs, ref: dict) -> int:
    """The reference's cache tree is a list of segments ``[{"layers": [...]}]``
    with stacked leaves; the port's a list of layers."""
    lm = _layer_map(cfg)
    pairs = list(T.leaves_with_paths(caches))
    specs = T.leaves(specs, is_leaf=TS._is_spec) if specs is not None else [None] * len(pairs)
    assert len(pairs) == len(specs)
    for (path, leaf), spec in zip(pairs, specs, strict=True):
        s, j, r = lm[path[0]]
        rshape, rspec = ref[(str(s), "layers", str(j)) + tuple(str(k) for k in path[1:])]
        shape = tuple(leaf.shape)
        assert (rshape[1:] if r is not None else rshape) == shape, (path, rshape, shape)
        if spec is not None:
            got = tuple(spec) + (None,) * (len(shape) - len(spec))
            assert got == (rspec[1:] if r is not None else rspec), (path, got, rspec)
    return len(pairs)


def test_moe_fallback_and_divisibility_match_the_reference():
    """grok: 8 experts on model 16 move the model axis to the expert FFN width;
    kimi: 384 experts stay expert-parallel; and MeshContext.spec's divisibility
    fallback, axis by axis, as the reference's."""
    for arch, e_axis in (("grok-1-314b", None), ("kimi-k2-1t-a32b", "model")):
        rcfg, rctx, tcfg, tctx = _contexts(arch, "16x16")
        E, D, F = tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff or tcfg.d_ff
        logical = ("experts", "embed_fsdp", "expert_mlp")
        for shape in ((E, D, F), (4, E, D, F)):
            lg = (None,) * (len(shape) - 3) + logical
            assert TS._moe_fallback(tcfg, tctx, lg, shape) == RS._moe_fallback(
                rcfg, rctx, lg, shape)
            got = TS._physical(tctx, TS._moe_fallback(tcfg, tctx, lg, shape), shape)
            want = _norm(RS._physical(rctx, RS._moe_fallback(rcfg, rctx, lg, shape), shape),
                         len(shape))
            assert got == want and got[-3] == e_axis
            if e_axis is None:
                assert got[-1] == "model"
    rng = np.random.default_rng(0)
    names = ["batch", "heads", "kv_heads", "mlp", "vocab", "kv_seq", "seq", None, "embed",
             "experts", "ssm_heads"]
    for mesh in MESHES:
        sizes, axes = MESHES[mesh]
        r = RPar.MeshContext(RPar.abstract_mesh(sizes, axes), {})
        t = TPar.MeshContext(TPar.abstract_mesh(sizes, axes), {})
        for _ in range(200):
            nd = int(rng.integers(1, 5))
            logical = tuple(names[i] for i in rng.integers(0, len(names), nd))
            shape = tuple(int(x) for x in rng.choice([1, 2, 8, 12, 16, 32, 48, 256], nd))
            assert t.spec(logical, shape) == _norm(r.spec(logical, shape), nd)
            assert t.spec(logical) == _norm(r.spec(logical), nd)


def test_shape_cells_and_input_and_cache_specs_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    tdt = {torch.int32: "int32", torch.bfloat16: "bfloat16", torch.float32: "float32"}
    for arch in ARCHS:
        assert TC.is_subquadratic(arch) == RC.is_subquadratic(arch)
        assert [c.name for c in TC.cells_for(arch)] == [c.name for c in RC.cells_for(arch)]
        rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
        for cell in TC.cells_for(arch):
            rin, tin = RC.input_specs(rcfg, cell), TC.input_specs(tcfg, cell)
            assert sorted(rin) == sorted(tin)
            for k, v in tin.items():
                assert v.is_meta and tuple(v.shape) == tuple(rin[k].shape), (arch, k)
                assert tdt[v.dtype] == str(rin[k].dtype), (arch, k)
            if cell.kind == "decode":
                rc = RC.cache_specs(rcfg, cell)
                tc = TC.cache_specs(tcfg, cell)
                assert all(leaf.is_meta for leaf in T.leaves(tc))
                _compare_cache(tcfg, tc, None, _ref_leaves(rc, jax.tree.map(lambda s: P(), rc)))
                tdtypes = [tdt[leaf.dtype] for leaf in T.leaves(tc)]
                lm = _layer_map(tcfg)
                flat = jax.tree_util.tree_flatten_with_path(rc)[0]
                rdt = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                       str(leaf.dtype) for path, leaf in flat}
                for (path, _), dt in zip(T.leaves_with_paths(tc), tdtypes, strict=True):
                    s_, j, _r = lm[path[0]]
                    assert rdt[(str(s_), "layers", str(j)) + tuple(str(k) for k in path[1:])] == dt


def test_the_gspmd_calls_under_an_abstract_mesh():
    from torch.distributed.tensor import Replicate, Shard

    mesh = TPar.abstract_mesh((2, 4), ("data", "model"))
    with TPar.mesh_context(mesh, {}) as ctx:
        assert TPar.logical_to_spec(("batch", None, "vocab")) == ("data", None, "model")
        assert TPar.named_sharding(("batch", None, "vocab")) == (Shard(0), Shard(2))
        assert ctx.sharding(("batch", "mlp"), (3, 8)) == (Replicate(), Shard(1))
        x = torch.ones(2)
        assert TPar.constrain(x, "batch") is x  # a plain tensor passes through
    multi = TPar.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert TPar.placements((("pod", "data"), None, "model"), multi) == (
        Shard(0), Shard(0), Shard(2))
