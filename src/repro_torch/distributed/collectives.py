"""Explicit collectives for distributed optimization, over ``torch.distributed``.

The port of ``repro/distributed/collectives.py``.  Where the reference takes an
``axis_name`` inside ``shard_map``, these take a process group: ``None`` (the
default group), a ``ProcessGroup``, or ``(mesh, axis name)`` for one axis of a
``DeviceMesh``.  Every rank of the group calls them with its own block.

* :func:`int8_allreduce`: a bandwidth-compressed all-reduce with error feedback,
  4× fewer wire bytes than f32.  Two phases, reduce-scatter then all-gather,
  both with int8 on the wire and per-shard f32 scales; the stage-1 quantization
  error is returned for error-feedback accumulation (carried in the optimizer
  loop, so the bias vanishes over steps).
* :func:`ring_reduce_scatter_matmul`: the collective matmul ``y = x·W`` with both
  operands sharded on the contraction dim; the reduce-scatter is a ring of
  ``isend``/``irecv`` steps, each overlapped with one row block's partial
  product (a plain ``torch.matmul``, as the reference's ``dot_general`` is
  outside any kernel).
* :func:`compressed_psum_grads`: the tree-wide int8 error-feedback mean.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as T

__all__ = ["int8_allreduce", "ring_reduce_scatter_matmul", "compressed_psum_grads"]


def _group(group: Any):
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(axis)
    return group


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _all_gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in group-rank order."""
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out


def int8_allreduce(
    x: torch.Tensor, group: Any = None, err: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce (sum) ``x``, the same shape on every rank, over ``group`` with int8
    wire traffic.  Returns (reduced, new error feedback).

    Phase 1 (reduce-scatter): quantize locally, all-to-all the int8 chunks so
    rank d receives everyone's d-th chunk, dequantize and sum.
    Phase 2 (all-gather): re-quantize the reduced chunk, all-gather the int8
    chunks and their scales, dequantize."""
    group = _group(group)
    n = dist.get_world_size(group)
    orig_shape = x.shape
    xf = x.reshape(-1).to(torch.float32)
    if err is not None:
        xf = xf + err.reshape(-1)
    pad = (-xf.numel()) % n
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])

    q, scale = _quantize(xf)
    new_err = xf - q.to(torch.float32) * scale  # stage-1 error-feedback residual

    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)  # rank d gets every rank's d-th chunk
    scales = _all_gather(scale.reshape(()), n, group)  # (n,)
    partial = torch.sum(recv.reshape(n, -1).to(torch.float32) * scales[:, None], dim=0)

    q2, s2 = _quantize(partial)
    qs = _all_gather(q2, n, group)  # (n, chunk) int8
    ss = _all_gather(s2.reshape(()), n, group)  # (n,)
    out = (qs.to(torch.float32) * ss[:, None]).reshape(-1)
    if pad:
        out, new_err = out[:-pad], new_err[:-pad]
    return out.reshape(orig_shape).to(x.dtype), new_err.reshape(orig_shape)


def ring_reduce_scatter_matmul(x_shard: torch.Tensor, w_shard: torch.Tensor,
                               group: Any = None) -> torch.Tensor:
    """``y = X @ W`` with X (m, K) and W (K, N) both sharded on K: this rank holds
    x_shard (m, K/n) and w_shard (K/n, N), and gets rows ``[d·m/n, (d+1)·m/n)`` of
    y, fully reduced (Megatron's row-parallel layer, with the reduce-scatter
    unrolled).

    At step s the accumulator visiting rank d is the one that finishes, after its
    remaining hops, at rank (d + s) mod n: the rank adds its partial product for
    that row block and passes it down the ring (to rank d - 1).  The product of
    the next block runs while the accumulator is in flight."""
    group = _group(group)
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    m = x_shard.shape[0]
    if m % n:
        raise ValueError(f"{m} rows do not split over {n} ranks")
    mb = m // n
    to = dist.get_global_rank(group, (idx - 1) % n) if group is not None else (idx - 1) % n
    frm = dist.get_global_rank(group, (idx + 1) % n) if group is not None else (idx + 1) % n

    def part(s: int) -> torch.Tensor:
        blk = (idx + s) % n
        rows = x_shard[blk * mb:(blk + 1) * mb]
        return torch.matmul(rows.to(torch.float32), w_shard.to(torch.float32))

    acc = torch.zeros((mb, w_shard.shape[1]), dtype=torch.float32, device=x_shard.device)
    nxt = part(0)
    for s in range(n):
        acc = acc + nxt
        got = torch.empty_like(acc)
        reqs = [dist.isend(acc, to, group=group), dist.irecv(got, frm, group=group)]
        if s + 1 < n:
            nxt = part(s + 1)  # overlapped with the transfer
        for r in reqs:
            r.wait()
        acc = got
    return acc.to(torch.promote_types(x_shard.dtype, w_shard.dtype))


def compressed_psum_grads(grads: Any, group: Any = None, errs: Any = None) -> tuple[Any, Any]:
    """Tree-wide int8 error-feedback all-reduce of gradients, as a mean over the
    group: (mean tree, new error tree)."""
    n = dist.get_world_size(_group(group))
    if errs is None:
        errs = T.map_leaves(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)
    outs = [int8_allreduce(g, group, e) for g, e in zip(T.leaves(grads), T.leaves(errs),
                                                          strict=True)]
    return (T.unflatten(grads, [o[0] / n for o in outs]),
            T.unflatten(grads, [o[1] for o in outs]))
