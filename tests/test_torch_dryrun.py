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


def _dryrun(args: list[str], tmp_path) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced",
                          "--out", str(tmp_path), *args], env=env, capture_output=True,
                         text=True, timeout=240)
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


def _reference(arch: str, cell: str, mesh: str) -> tuple[float, int]:
    """(parameter count, argument bytes per rank) of a reduced cell by the reference's
    specs."""
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
