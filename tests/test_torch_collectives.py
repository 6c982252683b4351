"""The explicit collectives over ``torch.distributed`` on gloo CPU ranks.

The reference's tests of these (``tests/distributed/test_collectives.py``) fail on
this tree (explicit sharding, ROADMAP §C), so the port is held to the
definitions they state: ``int8_allreduce`` matches the exact sum within the
quantization error (5% of the largest element) and the same result lands on
every rank; its error feedback, carried over 64 repeated reductions, brings the
mean closer to the exact sum than one reduction gets (bias below 0.6 of it);
``ring_reduce_scatter_matmul`` equals the dense product at the reference's
``(m, K, N)`` cases, rtol/atol 3e-4 (its first case at the reference's 2e-4);
``compressed_psum_grads`` gives the mean.  On 2 and 4 ranks; each rank is a
subprocess with its own timeout, as in ``tests/test_torch_spmd_exec.py``.
"""

from __future__ import annotations

import os
import textwrap

import pytest

from test_torch_sharded_exec import SRC, _run_ranks

_RANK = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import (
        compressed_psum_grads, int8_allreduce, ring_reduce_scatter_matmul)

    rank, world = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method="file://{store}", rank=rank, world_size=world)

    # every rank draws every rank's block from one seed: rank r takes row r
    xs = np.random.default_rng(0).standard_normal((world, 133)).astype(np.float32)
    out, err = int8_allreduce(torch.from_numpy(xs[rank]), None, torch.zeros(133))
    expect = xs.sum(0)
    rel = float(np.abs(out.numpy() - expect).max() / np.abs(expect).max())
    assert rel < 0.05, rel
    same = [torch.empty(133) for _ in range(world)]
    dist.all_gather(same, out)
    assert all(torch.equal(s, same[0]) for s in same)
    assert err.shape == (133,) and float(err.abs().max()) <= float(np.abs(xs[rank]).max()) / 127
    print("REL", rel, flush=True)

    xs = (np.random.default_rng(1).standard_normal((world, 257)) * 0.1).astype(np.float32)
    expect = xs.sum(0)
    x = torch.from_numpy(xs[rank])
    e = torch.zeros(257)
    acc = np.zeros(257)
    for _ in range(64):
        o, e = int8_allreduce(x, None, e)
        acc += o.numpy()
    bias_ef = np.abs(acc / 64 - expect).mean()
    o1, _ = int8_allreduce(x, None, torch.zeros(257))
    bias_1 = np.abs(o1.numpy() - expect).mean()
    assert bias_ef < bias_1 * 0.6, (bias_ef, bias_1)
    print("BIAS", bias_ef, bias_1, flush=True)

    for (m, K, N), tol in (((32, 64, 16), 2e-4), ((8, 32, 8), 3e-4), ((64, 128, 32), 3e-4),
                           ((16, 64, 128), 3e-4)):
        g = np.random.default_rng(m * K)
        X = g.standard_normal((m, K)).astype(np.float32)
        W = g.standard_normal((K, N)).astype(np.float32)
        k = K // world
        y = ring_reduce_scatter_matmul(torch.from_numpy(X[:, rank * k:(rank + 1) * k].copy()),
                                       torch.from_numpy(W[rank * k:(rank + 1) * k].copy()))
        mb = m // world
        np.testing.assert_allclose(y.numpy(), (X @ W)[rank * mb:(rank + 1) * mb], rtol=tol,
                                   atol=tol, err_msg=str((m, K, N)))
    print("RING OK", flush=True)

    gs = np.random.default_rng(2).standard_normal((world, 3, 40)).astype(np.float32)
    grads = {{"a": torch.from_numpy(gs[rank, 0]), "b": [torch.from_numpy(gs[rank, 1:])]}}
    mean, errs = compressed_psum_grads(grads)
    want = gs.mean(0)
    scale = np.abs(gs.sum(0)).max() / world
    np.testing.assert_allclose(mean["a"].numpy(), want[0], atol=0.05 * scale)
    np.testing.assert_allclose(mean["b"][0].numpy(), want[1:], atol=0.05 * scale)
    assert errs["a"].shape == (40,) and errs["b"][0].shape == (2, 40)
    print("MEAN OK", flush=True)
    dist.destroy_process_group()
    print("RANK PASSED", flush=True)
    """
)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_on_gloo_ranks(world, tmp_path):
    script = _RANK.format(src=SRC, store=tmp_path / "store")
    outs = _run_ranks(script, world, lambda r: (str(r), str(world)), tmp_path)
    for out in outs:
        for tag in ("REL", "BIAS", "RING OK", "MEAN OK", "RANK PASSED"):
            assert tag in out, (tag, out[-2000:])
    # the all-reduce gives every rank the same tensor, and so the same error to it
    assert len({out.split("REL ")[1].split()[0] for out in outs}) == 1


def test_the_collectives_take_a_process_group():
    import inspect

    from repro_torch.distributed import collectives as C

    for fn in (C.int8_allreduce, C.ring_reduce_scatter_matmul, C.compressed_psum_grads):
        assert "group" in inspect.signature(fn).parameters
    assert os.path.basename(C.__file__) == "collectives.py"
