"""SPMD execution: the port's per-shard programs on gloo CPU ranks against the
single-device result, across meshes 1×1, 2×1, 1×2 and 2×2, fused and unfused.

The reference's own contract (``tests/distributed/test_spmd_exec.py``): its
six-workload corpus, each workload's sharded output held to the single-device
unfused one at rtol 3e-5, atol 1e-6.  The reference's sharded execution fails
on this tree (``shard_map(check_rep=)``), so it is not the oracle; its
single-device ``jax.jit(lower_graph(g))`` is, beside the port's own unfused
single-device lowering.  The parent process computes the reference's values
with jax and hands them to the ranks as ``.npy`` files; the ranks import
``repro_torch`` only.

Each rank is a subprocess (``file://`` rendezvous under ``tmp_path``, so
pytest-xdist's workers never collide on a port) with its own timeout.  Then
the Myia train step on two ranks against one device (losses rtol 2e-5, params
rtol 2e-4, atol 1e-6, the reference's bounds), and ``python -m
torch.distributed.run --standalone -m repro_torch.launch.train --compiler myia
--data-mesh 2`` to its end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT = 240


def _mlp(P):
    def mlp(w1, w2, x):
        h = P.tanh(x @ w1)
        return P.reduce_sum(P.tanh(h @ w2), (0, 1), False)

    return mlp


def _chain(P):
    def chain(x):
        return P.reduce_sum(P.tanh(x) * P.sigmoid(x) + 1.0, (0, 1), False)

    return chain


def _emb_loss(P):
    def emb_loss(emb, w, toks):
        h = P.take(emb, toks)
        h = P.tanh(h @ w)
        return P.reduce_sum(h * h, (0, 1, 2), False)

    return emb_loss


def _row_sums(P):
    def row_sums(x):
        return P.reduce_sum(P.tanh(x) * 2.0, (1,), False)

    return row_sums


def _cross_shard(P):
    def cross_shard(a, b):
        return P.reduce_sum(a * b, (0, 1), False)

    return cross_shard


def corpus_arrays() -> dict:
    rng = np.random.default_rng(0)
    d = 16
    arr = {
        "w1": rng.standard_normal((d, d)) * 0.1,
        "w2": rng.standard_normal((d, d)) * 0.1,
        "x": rng.standard_normal((8, d)),
        "emb": rng.standard_normal((32, d)) * 0.5,
        "w": rng.standard_normal((d, d)) * 0.1,
        "big": rng.standard_normal((16, 32)),
    }
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    arr["toks"] = rng.integers(0, 32, (4, 8)).astype(np.int32)
    return arr


#: (name, program factory, gradient wrt or None, argument names, in_specs): the
#: reference's six workloads (tests/distributed/test_spmd_exec.py), and one more
WORKLOADS = [
    ("mlp_fwd", _mlp, None, ("w1", "w2", "x"), (None, None, ("data",))),
    ("mlp_grad_dp", _mlp, (0, 1), ("w1", "w2", "x"), (None, None, ("data",))),
    ("mlp_grad_tp", _mlp, (0, 1), ("w1", "w2", "x"), (("model",), (None, "model"), ("data",))),
    ("reduce_chain", _chain, None, ("big",), (("data", "model"),)),
    ("emb_grad", _emb_loss, (0, 1), ("emb", "w", "toks"), (None, None, ("data",))),
    # operands shard the SAME mesh axis on DIFFERENT dims: the reshard must
    # gather (all dims) before any shard_slice
    ("cross_shard_reshard", _cross_shard, None, ("a", "b"), (("data", None), (None, "data"))),
    # beyond the reference's six: an output sharded over both axes on one dim, so the
    # block order of shard_slice and of the gathers must agree (a sum hides it)
    ("row_sums_2d", _row_sums, None, ("big",), ((("data", "model"),),)),
]


def _graph(core_parse, core_grad, pipeline, abstract, P, make, wrt, args):
    g = core_parse(make(P))
    if wrt is not None:
        g = core_grad(g, wrt)
    return pipeline(g, tuple(abstract(a) for a in args))


def _corpus_args(arr, names):
    if names == ("a", "b"):
        return arr["w1"], arr["w2"]
    return tuple(arr[n] for n in names)


def _write_reference(dirpath) -> None:
    """The reference's single-device values of the six workloads, as .npy (the
    ranks import this module: jax and the reference stay in this function)."""
    import jax
    import jax.numpy as jnp

    import repro.core.primitives as RP
    from repro.core import build_grad_graph, parse_function
    from repro.core.api import compile_pipeline
    from repro.core.infer import abstract_of_value
    from repro.core.lowering import lower_graph

    arr = corpus_arrays()
    for name, make, wrt, names, _ in WORKLOADS:
        args = tuple(jnp.asarray(a) for a in _corpus_args(arr, names))
        g = _graph(parse_function, build_grad_graph, compile_pipeline, abstract_of_value,
                   RP, make, wrt, args)
        out = jax.jit(lower_graph(g))(*args)
        for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
            np.save(dirpath / f"{name}_{i}.npy", np.asarray(o))


_RANK = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.core as T
    import repro_torch.core.primitives as P
    from repro_torch.core.api import compile_pipeline
    from repro_torch.core.infer import abstract_of_value
    from repro_torch.launch.mesh import make_local_mesh
    from test_torch_spmd_exec import WORKLOADS, _corpus_args, _graph, corpus_arrays

    rank, world, data, model = (int(a) for a in sys.argv[1:5])
    dist.init_process_group("gloo", init_method="file://{store}", rank=rank,
                            world_size=world)
    mesh = make_local_mesh(data, model, device="cpu")
    arr = corpus_arrays()
    n_ok = 0
    for name, make, wrt, names, in_specs in WORKLOADS:
        args = tuple(torch.from_numpy(a.copy()) for a in _corpus_args(arr, names))
        g = _graph(T.parse_function, T.build_grad_graph, compile_pipeline, abstract_of_value,
                   P, make, wrt, args)
        oracle = T.lower_graph(g)(*args)  # the port, single device, unfused
        oracle = oracle if isinstance(oracle, tuple) else (oracle,)
        ref = [np.load("{npy}/" + f"{{name}}_{{i}}.npy") for i in range(len(oracle))]
        for fuse in (False, True):
            run = T.compile_graph_spmd(g, mesh, in_specs, fuse=fuse)
            assert run.spmd
            got = run(*args)
            got = got if isinstance(got, tuple) else (got,)
            for a, b, r in zip(got, oracle, ref, strict=True):
                msg = f"{{name}} fuse={{fuse}} mesh={{(data, model)}} rank={{rank}}"
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-5, atol=1e-6,
                                           err_msg=msg + " vs the port's single device")
                np.testing.assert_allclose(a.numpy(), r, rtol=3e-5, atol=1e-6,
                                           err_msg=msg + " vs the reference's single device")
        n_ok += 1
        print("OK", name, flush=True)
    dist.destroy_process_group()
    print("CORPUS PASSED", n_ok, flush=True)
    """
)


def _run_ranks(script: str, world: int, argv_of, tmp_path, timeout: int = TIMEOUT) -> list[str]:
    """Start ``world`` ranks of ``script`` (a real file: the parser reads source
    through ``inspect``), wait for each under its timeout, and return their
    standard outputs; any rank's failure fails the test with its stderr."""
    path = tmp_path / "rank.py"
    path.write_text(script)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(path), *argv_of(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=["1x1", "2x1", "1x2", "2x2"])
def test_corpus_on_a_mesh(data, model, tmp_path):
    _write_reference(tmp_path)
    world = data * model
    script = _RANK.format(src=SRC, tests=os.path.dirname(os.path.abspath(__file__)),
                          store=tmp_path / "store", npy=tmp_path)
    outs = _run_ranks(script, world, lambda r: (str(r), str(world), str(data), str(model)),
                      tmp_path)
    for out in outs:
        assert out.count("OK") == len(WORKLOADS) and f"CORPUS PASSED {len(WORKLOADS)}" in out


_STEP = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.myia_step import MyiaLMDims, make_myia_train_step
    from repro_torch.parallel import mesh_context

    rank, data, model = (int(a) for a in sys.argv[1:4])
    dist.init_process_group("gloo", init_method="file://{store}", rank=rank, world_size=2)
    dims = MyiaLMDims(vocab=64, d_model=16, d_hidden=32)
    B, S = 4, 8
    rng = np.random.default_rng(0)
    batches = [
        {{"tokens": torch.from_numpy(rng.integers(0, 64, (B, S)).astype(np.int32)),
          "labels": torch.from_numpy(rng.integers(0, 64, (B, S)).astype(np.int32))}}
        for _ in range(3)
    ]

    def run(mesh):
        step, init = make_myia_train_step(dims, B, S, 1e-2, device="cpu")
        with mesh_context(mesh, {{}}):
            state = init()
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
            spmd = getattr(step.vag.specialize((*state["params"], b["tokens"], b["labels"])),
                           "spmd", False)
        return losses, state, spmd

    l0, s0, spmd0 = run(None)
    l1, s1, spmd1 = run(make_local_mesh(data, model, device="cpu"))
    assert not spmd0 and spmd1, (spmd0, spmd1)
    np.testing.assert_allclose(l0, l1, rtol=2e-5)
    for a, b in zip(s0["params"], s1["params"], strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)
    dist.destroy_process_group()
    print("E2E OK", json.dumps(l0), flush=True)
    """
)


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_myia_train_step_2_ranks_matches_single_device(data, model, tmp_path):
    script = _STEP.format(src=SRC, store=tmp_path / "store")
    outs = _run_ranks(script, 2, lambda r: (str(r), str(data), str(model)), tmp_path)
    assert all("E2E OK" in out for out in outs)
    assert outs[0].split("E2E OK")[1] == outs[1].split("E2E OK")[1]


def test_launch_train_under_torch_distributed_run(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--compiler", "myia",
           "--reduced", "--device", "cpu", "--data-mesh", "2", "--steps", "3",
           "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    reports = [json.loads(line.split(" ", 1)[1]) for line in res.stdout.splitlines()
               if line.startswith("SPMD_RANK ")]
    assert sorted(r["rank"] for r in reports) == [0, 1]
    for r in reports:
        assert r["backend"] == "gloo" and r["steps"] == 3 and r["restarts"] == 0
        assert r["plan"]["n_clusters"] == 4 and r["collectives"]["psum"] > 0
        assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
    assert reports[0]["losses"] == reports[1]["losses"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["rank0", "rank1"]


def test_launch_train_mesh_flags_of_the_model_zoo_wait():
    """``--compiler torch`` under a mesh runs the placed step (its two-rank run is
    tests/test_torch_sharded_exec.py's); a world of one cannot hold a 2x1 mesh."""
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match="2 ranks"):
        main(["--reduced", "--device", "cpu", "--data-mesh", "2"])


def test_launch_serve_full_prefix_under_torch_distributed_run():
    """``--compiler myia`` serving under a 1x2 mesh (the vocab projection split over
    the two ranks): the full-prefix path on the SPMD tier gives the single-device
    run's greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli

    flags = ["--compiler", "myia", "--reduced", "--device", "cpu", "--batch", "2",
             "--prompt-len", "6", "--gen", "3"]
    want = serve_cli.serve_myia_full_prefix(
        serve_cli.parse_args([*flags, "--full-prefix"]), get_config("internlm2-1.8b", reduced=True))
    assert not want["spmd"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.serve", *flags, "--model-mesh", "2"]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("[myia/spmd] prefill: 2×6") == 2
    rows = [json.loads(line.strip()) for line in res.stdout.splitlines()
            if line.strip().startswith("[") and line.strip()[1:2].isdigit()]
    # both ranks print every row; their lines interleave in the launcher's stdout
    assert sorted(rows) == sorted(2 * [row.tolist() for row in want["tokens"]])
