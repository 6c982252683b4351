"""The dry run (``repro_torch.launch.dryrun``) on the production meshes.

Each cell runs in a process of its own: the fake process group of 512 ranks that
``make_production_mesh`` starts cannot share a process with a real one.  A
reduced train cell on the 16×16 mesh and a reduced decode cell on 2×16×16: the
record's ``param_count`` equals the reference's (``jax.eval_shape`` of its
``init_params``, as its ``_param_count`` sums it), and its argument bytes per
rank equal the bytes the reference's partition specs imply (each leaf's bytes
over the product of the mesh axes its spec names).  Importing the dry run sets
no process-wide environment (the reference's sets ``XLA_FLAGS``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from test_torch_sharded_exec import SRC

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _dryrun(args: list[str], tmp_path, reduced: bool = True) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *(["--reduced"] if reduced else []), "--out", str(tmp_path), *args],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    recs = [json.loads(line.split(" ", 1)[1]) for line in res.stdout.splitlines()
            if line.startswith("DRYRUN ")]
    assert len(recs) == 1, res.stdout[-2000:]
    files = os.listdir(tmp_path)
    assert len(files) == 1 and json.load(open(tmp_path / files[0])) == recs[0]
    return recs[0]


def _spec_bytes(tree, specs, sizes: dict) -> int:
    """The bytes of ``tree``'s leaves on one rank under the reference's specs."""
    total = 0
    flat = jax.tree_util.tree_leaves(tree)
    sleaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(flat) == len(sleaves)
    for leaf, spec in zip(flat, sleaves):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n //= sizes[a]
        total += n
    return total


def _reference(arch: str, cell: str, mesh: str, reduced: bool = True) -> tuple[float, int]:
    """(parameter count, argument bytes per rank) of a cell (reduced by default) by the
    reference's specs."""
    import repro.configs as RC
    import repro.distributed as RD
    import repro.distributed.sharding as RS
    import repro.models as RM
    import repro.optim as RO
    import repro.parallel as RPar

    cfg = RC.get_config(arch, reduced=reduced)
    sizes, names = MESHES[mesh]
    ctx = RPar.MeshContext(RPar.abstract_mesh(sizes, names), RS.make_rules(cfg))
    axes = dict(zip(names, sizes))
    c = RC.SHAPES[cell]
    params = jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))
    count = float(sum(np.prod(leaf.shape) for leaf in jax.tree.leaves(params)))
    pspecs = RS.param_specs(cfg, params, ctx)
    inputs = RC.input_specs(cfg, c)
    if c.kind == "train":
        name = "adafactor" if count > 1e11 else "adamw"
        opt = RO.make_optimizer(RO.OptConfig(name=name, state_dtype="float32"))
        state = jax.eval_shape(lambda: opt.init(params))
        nbytes = (_spec_bytes(params, pspecs, axes)
                  + _spec_bytes(state, RS.tree_specs(pspecs, state, params), axes) + 4
                  + _spec_bytes(inputs, RS.batch_specs(ctx, inputs), axes))
    else:
        caches = RC.cache_specs(cfg, c)
        csh = jax.tree.map(lambda s: s.spec, RD.cache_shardings(cfg, ctx, caches))
        tok = {"token": inputs["token"]}
        nbytes = (_spec_bytes(params, pspecs, axes) + _spec_bytes(caches, csh, axes)
                  + _spec_bytes(tok, RS.batch_specs(ctx, tok), axes))
    return count, nbytes


@pytest.mark.parametrize("arch,cell,mesh", [
    ("internlm2-1.8b", "train_4k", "single"),
    ("gemma3-1b", "decode_32k", "multi"),
], ids=["internlm2-train_4k-16x16", "gemma3-decode_32k-2x16x16"])
def test_dryrun_cell_matches_the_reference_specs(arch, cell, mesh, tmp_path):
    rec = _dryrun(["--arch", arch, "--cell", cell, "--mesh", mesh], tmp_path)
    sizes, _ = MESHES[mesh]
    assert rec["arch"] == arch and rec["cell"] == cell and rec["mesh_shape"] == list(sizes)
    count, nbytes = _reference(arch, cell, mesh)
    assert rec["param_count"] == count
    assert rec["argument_bytes_per_rank"] == nbytes, (rec["argument_bytes_per_rank"], nbytes)
    assert rec["flops_per_rank"] > 0 and rec["trace_s"] > 0
    assert sum(rec["collectives"].values()) > 0, rec["collectives"]
    if cell == "train_4k":
        assert rec["optimizer"] == "adamw"


@pytest.mark.parametrize("arch,cell", [
    ("internlm2-1.8b", "decode_32k"),
    ("whisper-medium", "decode_32k"),
    ("jamba-v0.1-52b", "long_500k"),
], ids=["internlm2-decode_32k", "whisper-decode_32k", "jamba-long_500k"])
def test_dryrun_of_a_production_decode_cell(arch, cell, tmp_path):
    """Production decode cells at full width on 16×16, which the cached decode on
    DTensors failed before it ran on local shards: internlm2's 8 kv heads under 16
    sharded q heads (a 32768-slot cache sharded on its slots), whisper's self- and
    cross-attention decode, and jamba's 524288-slot cache (sequence-sharded, never
    gathered), GQA and SSM step.  The record holds a peak and collective bytes, and its
    argument bytes per rank are what the reference's specs imply."""
    rec = _dryrun(["--arch", arch, "--cell", cell, "--mesh", "single"], tmp_path,
                  reduced=False)
    count, nbytes = _reference(arch, cell, "single", reduced=False)
    mem = rec["memory"]
    assert rec["param_count"] == count
    assert rec["argument_bytes_per_rank"] == mem["argument_size_bytes"] == nbytes
    assert mem["peak_size_bytes"] > nbytes and mem["temp_size_bytes"] > 0
    assert set(rec["collective_bytes"]) == set(KINDS)
    assert rec["collective_bytes"]["all-reduce"] > 0
    # each rank attends over its own block of a long cache's slots: the self-attention
    # caches (every 4-d cache of seq_len slots) are never gathered, and everything the
    # step gathers (the FSDP-stored parameters) is less than they hold
    from repro_torch import tree as T
    from repro_torch.configs import SHAPES, cache_specs, get_config

    caches = cache_specs(get_config(arch), SHAPES[cell])
    big = sum(t.numel() * t.element_size() for t in T.leaves(caches)
              if t.ndim == 4 and t.shape[-2] == SHAPES[cell].seq_len)
    assert big > 0 and rec["collective_bytes"]["all-gather"] < big, (
        rec["collective_bytes"], big)


def test_probe_counts_the_unsharded_step(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = ("import json; from repro_torch.launch.dryrun import run_probe; "
            "from repro_torch.configs import SHAPES; "
            "print(json.dumps(run_probe('internlm2-1.8b', SHAPES['decode_32k'], reduced=True)))")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["flops_global"] > 0 and rec["cell"] == "decode_32k"


def test_importing_the_dryrun_sets_no_environment():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = ("import json, os; before = dict(os.environ); import repro_torch.launch.dryrun; "
            "print(json.dumps(dict(os.environ) == before))")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "true"


# -- the memory, bytes and collective accounting ---------------------------------------

_CELL_RECORD = """
import json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import run_cell
arch, kind, seq, batch, data, model, real = sys.argv[1:8]
cell = ShapeCell("t", kind, int(seq), int(batch))
if real == "real":
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(int(data), int(model), device="cpu")
else:
    from repro_torch.launch.mesh import make_fake_mesh
    mesh = make_fake_mesh((int(data), int(model)), ("data", "model"))
rec = run_cell(arch, cell, mesh, "m", reduced=True)
print("RECORD " + json.dumps(rec))
"""


def _cell_record(tmp_path, *argv) -> dict:
    """``run_cell`` of a reduced arch on a small ``data × model`` mesh, in a process
    of its own: a fake world, or (``real``) a gloo world of one on the CPU."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _CELL_RECORD, *map(str, argv)], env=env,
                         capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = [line for line in res.stdout.splitlines() if line.startswith("RECORD ")]
    return json.loads(lines[-1].split(" ", 1)[1])


KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def test_collective_bytes_of_a_data_parallel_step(tmp_path):
    """Reduced internlm2-1.8b's train step on a 4×1 fake mesh: every parameter is
    replicated over ``data``, so each gradient is a pending sum there, all-reduced
    once at its parameter's bytes; the loss's sum over the batch shards is one f32
    more.  Nothing else is sent."""
    import repro.configs as RC
    import repro.models as RM

    rec = _cell_record(tmp_path, "internlm2-1.8b", "train", 64, 8, 4, 1, "fake")
    cfg = RC.get_config("internlm2-1.8b", reduced=True)
    params = jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))
    grad_bytes = sum(int(np.prod(p.shape)) * np.dtype(p.dtype).itemsize
                     for p in jax.tree.leaves(params))
    want = dict.fromkeys(KINDS, 0)
    want["all-reduce"] = grad_bytes + 4
    assert rec["collective_bytes"] == want, (rec["collective_bytes"], want)
    # one all-reduce a parameter of the port's (unstacked: a leaf a layer)
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.model import abstract_params

    n = len(T.leaves(abstract_params(get_config("internlm2-1.8b", reduced=True))))
    assert rec["collectives"] == {"all_reduce": n + 1}


def test_collective_bytes_of_a_tensor_parallel_prefill(tmp_path):
    """Reduced internlm2-1.8b's prefill (batch 8, prompt 64) on a 1×2 fake mesh: the
    vocab-sharded embedding and each layer's row-parallel attention and MLP
    outputs are summed over ``model`` (2L + 1 all-reduces of the (B, S, D) f32
    residual stream), and the last position's logits are gathered from their vocab
    shards (one all-gather of (B, V) f32)."""
    import repro.configs as RC

    cfg = RC.get_config("internlm2-1.8b", reduced=True)
    B, S = 8, 64
    rec = _cell_record(tmp_path, "internlm2-1.8b", "prefill", S, B, 1, 2, "fake")
    want = dict.fromkeys(KINDS, 0)
    want["all-reduce"] = (2 * cfg.n_layers + 1) * B * S * cfg.d_model * 4
    want["all-gather"] = B * cfg.vocab * 4
    assert rec["collective_bytes"] == want, (rec["collective_bytes"], want)
    assert rec["collectives"] == {"all_reduce": 2 * cfg.n_layers + 1,
                                  "all_gather_into_tensor": 1}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_accounting_equals_the_real_run_on_a_1x1_mesh(kind, tmp_path):
    """The same step of reduced internlm2-1.8b (batch 2, length 64) under fake
    tensors on a fake 1×1 mesh and on real CPU tensors on a gloo 1×1 mesh: the same
    peak, temp, output and argument bytes, bytes accessed and FLOPs."""
    fake = _cell_record(tmp_path, "internlm2-1.8b", kind, 64, 2, 1, 1, "fake")
    real = _cell_record(tmp_path, "internlm2-1.8b", kind, 64, 2, 1, 1, "real")
    for key in ("memory", "bytes_accessed_per_rank", "collective_bytes", "flops_per_rank",
                "argument_bytes_per_rank"):
        assert fake[key] == real[key], (key, fake[key], real[key])
    mem = fake["memory"]
    assert mem["argument_size_bytes"] == fake["argument_bytes_per_rank"]
    assert mem["temp_size_bytes"] == mem["peak_size_bytes"] - mem["argument_size_bytes"] > 0


def _reference_output_bytes(arch: str, cell: str, mesh: str) -> int:
    """The step's output bytes on one rank by the reference's specs: a train step
    returns its new state and 5 f32 metrics (loss, nll, aux, gnorm, lr) whole; a
    decode step its caches and the (B, V) f32 logits whole."""
    import repro.configs as RC
    import repro.distributed as RD
    import repro.distributed.sharding as RS
    import repro.models as RM
    import repro.optim as RO
    import repro.parallel as RPar

    cfg = RC.get_config(arch, reduced=True)
    sizes, names = MESHES[mesh]
    ctx = RPar.MeshContext(RPar.abstract_mesh(sizes, names), RS.make_rules(cfg))
    axes = dict(zip(names, sizes))
    c = RC.SHAPES[cell]
    if c.kind == "train":
        params = jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))
        pspecs = RS.param_specs(cfg, params, ctx)
        state = jax.eval_shape(lambda: RO.make_optimizer(RO.OptConfig()).init(params))
        return (_spec_bytes(params, pspecs, axes)
                + _spec_bytes(state, RS.tree_specs(pspecs, state, params), axes) + 4 + 5 * 4)
    caches = RC.cache_specs(cfg, c)
    csh = jax.tree.map(lambda s: s.spec, RD.cache_shardings(cfg, ctx, caches))
    return _spec_bytes(caches, csh, axes) + c.global_batch * cfg.vocab * 4


@pytest.mark.parametrize("arch,cell,mesh", [
    ("internlm2-1.8b", "train_4k", "single"),
    ("gemma3-1b", "decode_32k", "multi"),
], ids=["internlm2-train_4k-16x16", "gemma3-decode_32k-2x16x16"])
def test_dryrun_memory_of_a_production_cell(arch, cell, mesh, tmp_path):
    """The record's memory on the production meshes: the arguments as the reference's
    specs give them; the outputs are the state (or caches) again plus what the step
    returns whole; the peak holds at least the arguments (and, for a train step,
    the new state beside the old); every collective kind is reported."""
    rec = _dryrun(["--arch", arch, "--cell", cell, "--mesh", mesh], tmp_path)
    _count, nbytes = _reference(arch, cell, mesh)
    mem = rec["memory"]
    assert mem["argument_size_bytes"] == rec["argument_bytes_per_rank"] == nbytes
    assert mem["output_size_bytes"] == _reference_output_bytes(arch, cell, mesh), mem
    assert mem["temp_size_bytes"] == mem["peak_size_bytes"] - nbytes > 0
    if cell == "train_4k":  # the new state is made while the old one is alive
        assert mem["peak_size_bytes"] >= nbytes + mem["output_size_bytes"] - 5 * 4
    assert set(rec["collective_bytes"]) == set(KINDS)
    assert rec["collective_bytes"]["all-reduce"] > 0
    assert rec["bytes_accessed_per_rank"] > mem["peak_size_bytes"] - nbytes
