"""The kernel boundary: where model code on DTensors meets the kernels.

Under a mesh (``repro_torch.distributed``'s placed steps) the model runs on
DTensors (``torch.distributed.tensor``): placements follow the reference's
logical-axis rules and DTensor propagates them through plain PyTorch ops.  The
hand-written kernels take raw pointers (``data_ptr`` through ctypes), so they
cannot see a DTensor; and on the CPU the kernel ops send a call to the plain
version, where a DTensor would flow through plain ATen ops unnoticed.  So every
call of ``kernels.rmsnorm``, ``kernels.flash_attention`` and ``kernels.ssd_scan``
goes through this module: each operand is redistributed to stated in
placements, taken as its local shard (``to_local``, in the autograd graph), the
kernel runs on plain local tensors, and its outputs come back as DTensors with
stated out placements (``from_local``).  The gradient of an operand that is
replicated on a mesh axis where another operand is sharded is a ``Partial``
sum over that axis (a norm weight's over the data axis, say).  On plain tensors
every function here is the kernel op itself, with nothing around it.

The other places where DTensor has no sharding strategy for the model's ops,
or where it would pick a costly one, are written here too, as explicit
redistribution and local compute: the embedding lookup on a vocab-sharded
table, the f32-output logits product, the cross-entropy on vocab-sharded logits,
the MoE's index-based dispatch and combine, the Mamba conv, and the decode caches'
writes.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch import kernels, parallel

__all__ = [
    "cache_put", "embedding", "flash_attention", "is_dtensor", "local_call", "matmul_f32",
    "moe", "nll", "rmsnorm", "rows", "ssd_scan",
]


def is_dtensor(*xs: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in xs)


def _classes():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    return DTensor, Partial, Replicate, Shard


def _shard_dim(p, ndim: int) -> int | None:
    """The tensor dim a placement shards (non-negative), or None."""
    _, _, _, Shard = _classes()
    return p.dim % ndim if isinstance(p, Shard) else None


def _keep(x, dims: Sequence[int]) -> tuple:
    """``x``'s placements with every shard of a dim outside ``dims`` replicated."""
    _, _, Replicate, _ = _classes()
    return tuple(p if _shard_dim(p, x.ndim) in dims else Replicate() for p in x.placements)


def _sharded(pls: Sequence, ndim: int, dim: int) -> list[bool]:
    return [_shard_dim(p, ndim) == dim for p in pls]


def _offset(mesh, pls: Sequence, ndim: int, dim: int, size: int) -> tuple[int, int]:
    """(first global index, local length) of this rank's block of ``dim`` (of
    global length ``size``) under ``pls``: mesh dims in order, outermost first."""
    coord = mesh.get_coordinate()
    lo, n = 0, size
    for m, p in enumerate(pls):
        if _shard_dim(p, ndim) == dim:
            n //= mesh.size(m)
            lo += coord[m] * n
    return lo, n


def _grad_pl(own: Sequence, others: Sequence[Sequence]) -> tuple:
    """An operand's gradient placements: ``Partial`` on the mesh dims where it is
    replicated while another operand is sharded, its own placements elsewhere."""
    _, Partial, Replicate, Shard = _classes()
    out = []
    for m, p in enumerate(own):
        sharded = any(isinstance(o[m], Shard) for o in others)
        out.append(Partial() if isinstance(p, Replicate) and sharded else p)
    return tuple(out)


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward reduces a pending sum in the gradient: the
    gradient leaves at the operand's own placements (``Partial`` all-reduced), so
    the plain ops before the boundary never see a ``Partial`` gradient (DTensor
    would turn it into a strided shard of a flattened batch dim, which its matmul
    cannot take)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return parallel.redistribute(g, ctx.placements)


def local_call(fn: Callable, args: Sequence, ins: Sequence, grads: Sequence, outs: Any):
    """``fn`` on the local shards of ``args``: each DTensor operand redistributed to
    its ``ins`` placements and taken with ``grads`` as its gradient placements
    (None: a plain operand, passed as it is; a pending sum is reduced at the
    boundary, :class:`_SumGrad`); each output tensor wrapped with its ``outs``
    placements (a tuple of them for a tuple of outputs)."""
    DTensor, Partial, _, _ = _classes()
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    local = []
    for a, pin, pg in zip(args, ins, grads, strict=True):
        if isinstance(a, DTensor):
            a = parallel.redistribute(a, pin)
            if a.requires_grad and any(isinstance(p, Partial) for p in pg or ()):
                a = _SumGrad.apply(a)
            a = a.to_local(grad_placements=pg)
        local.append(a)
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, outs, strict=True))
    return DTensor.from_local(out, mesh, outs, run_check=False)


# ===========================================================================
# The kernels
# ===========================================================================


def rmsnorm(x, w, *, eps: float, impl: str | None = None):
    """K2/K3 on local rows: the normalized dim (last) is gathered first where it
    is sharded (the Mamba gate norm over ``ssm_proj``)."""
    if not is_dtensor(x, w):
        return kernels.rmsnorm(x, w, eps=eps, impl=impl)
    _, _, Replicate, _ = _classes()
    xin = _keep(x, range(x.ndim - 1))
    win = tuple(Replicate() for _ in xin)
    return local_call(lambda a, b: kernels.rmsnorm(a, b, eps=eps, impl=impl), (x, w),
                      (xin, win), (xin, _grad_pl(win, [xin])), xin)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    impl: str | None = None):
    """K4 on local batch rows and heads.  Sequence and head dims are gathered where
    sharded.  Where the q heads are sharded and the kv heads replicated (kv heads
    that do not divide the model axis), K and V are cut to the kv heads this
    rank's q heads map to globally (``h // (H / KVH)``), not to
    ``h_local // (H_local / KVH)``."""
    if not is_dtensor(q, k, v):
        return kernels.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    _, _, Replicate, Shard = _classes()
    mesh = q.device_mesh
    qin = _keep(q, (0, 1))
    kin = []
    for m, p in enumerate(qin):  # batch as q's; heads sharded only where q's are
        pk = k.placements[m]
        if _shard_dim(p, 4) == 0:
            kin.append(Shard(0))
        elif _shard_dim(p, 4) == 1 and _shard_dim(pk, 4) == 1:
            kin.append(Shard(1))
        else:
            kin.append(Replicate())
    kin = tuple(kin)
    H, KVH = q.shape[1], k.shape[1]
    group = H // KVH
    h0, hl = _offset(mesh, qin, 4, 1, H)
    k0, kl = _offset(mesh, kin, 4, 1, KVH)
    idx = [(h0 + j) // group - k0 for j in range(hl)]  # each local q head's local kv head
    lo, hi = idx[0], idx[-1] + 1
    uniform = hl % (hi - lo) == 0 and idx == [lo + j // (hl // (hi - lo)) for j in range(hl)]

    def run(ql, kl_, vl):
        if (lo, hi) != (0, kl) or not uniform:
            if uniform:  # a contiguous block of kv heads, each serving hl/(hi-lo) q heads
                kl_, vl = kl_[:, lo:hi], vl[:, lo:hi]
            else:  # q heads that straddle kv heads: one kv head per q head
                sel = torch.tensor(idx, device=kl_.device)
                kl_, vl = kl_.index_select(1, sel), vl.index_select(1, sel)
            kl_, vl = kl_.contiguous(), vl.contiguous()
        return kernels.flash_attention(ql, kl_, vl, causal=causal, window=window, impl=impl)

    kg = _grad_pl(kin, [qin])
    return local_call(run, (q, k, v), (qin, kin, kin), (qin, kg, kg), qin)


def ssd_scan(x, dt, A, B, C, *, return_final_state: bool = False, impl: str | None = None):
    """K5 on local batch rows and heads: x (B, S, NH, P) keeps its batch and head
    shards; dt and A follow x's heads; B and C (one group) are replicated over the
    head axis, and their gradients are partial sums over it."""
    if not is_dtensor(x, dt, A, B, C):
        return kernels.ssd_scan(x, dt, A, B, C, return_final_state=return_final_state,
                                impl=impl)
    _, _, Replicate, Shard = _classes()
    xin = _keep(x, (0, 2))
    dtin, ain, bin_, sin = [], [], [], []
    for p in xin:
        d = _shard_dim(p, 4)
        dtin.append(Shard(d) if d is not None else Replicate())
        ain.append(Shard(0) if d == 2 else Replicate())
        bin_.append(Shard(0) if d == 0 else Replicate())
        sin.append(Shard(0) if d == 0 else Shard(1) if d == 2 else Replicate())
    dtin, ain, bin_, sin = map(tuple, (dtin, ain, bin_, sin))
    bg = _grad_pl(bin_, [xin])

    def run(*a):
        return kernels.ssd_scan(*a, return_final_state=return_final_state, impl=impl)

    return local_call(run, (x, dt, A, B, C), (xin, dtin, ain, bin_, bin_),
                      (xin, dtin, _grad_pl(ain, [xin]), bg, bg),
                      (xin, sin) if return_final_state else xin)


# ===========================================================================
# Ops DTensor has no strategy for, written as local compute
# ===========================================================================


def rows(fn: Callable, x, *ws):
    """``fn(x, *ws)`` on each rank's batch rows of x (B, S, C), with each of ``ws``
    whole: the Mamba mixer's causal conv and conv window (``F.pad``, which DTensor
    in torch 2.11 placed wrongly: one placement on a two-axis mesh)."""
    if not is_dtensor(x, *ws):
        return fn(x, *ws)
    _, _, Replicate, _ = _classes()
    xin = _keep(x, (0,))
    win = tuple(Replicate() for _ in xin)
    return local_call(fn, (x, *ws), (xin,) + (win,) * len(ws),
                      (xin,) + (_grad_pl(win, [xin]),) * len(ws), xin)


def embedding(table, tokens):
    """``table[tokens]``.  On a vocab-sharded table each rank looks up the tokens in
    its rows, zeroes the others, and the result is a ``Partial`` sum over the vocab
    axis (the caller's ``constrain`` reduces it)."""
    if not is_dtensor(table, tokens):
        return table[tokens.long()]
    _, Partial, Replicate, Shard = _classes()
    mesh = table.device_mesh
    tin = _keep(table, (0,))
    vocab = _sharded(tin, 2, 0)
    kin = tuple(Replicate() if v else p for p, v in zip(tokens.placements, vocab))
    v0, vl = _offset(mesh, tin, 2, 0, table.shape[0])
    outs = tuple(Partial() if v else (Shard(_shard_dim(p, tokens.ndim)) if isinstance(p, Shard)
                                      else Replicate()) for p, v in zip(kin, vocab))

    def run(t, tok):
        tok = tok.long()
        if not any(vocab):
            return t[tok]
        i = tok - v0
        inside = (i >= 0) & (i < vl)
        return t[torch.where(inside, i, 0)] * inside[..., None].to(t.dtype)

    return local_call(run, (table, tokens), (tin, kin), (_grad_pl(tin, [kin]), None), outs)


def matmul_f32(a, b, fn: Callable):
    """``fn(a, b)`` (the f32-output product of the logits) on local shards: a (B, S,
    D) keeps its batch shards, b (D, V) its column shards."""
    if not is_dtensor(a, b):
        return fn(a, b)
    _, Partial, Replicate, Shard = _classes()
    bin_ = _keep(b, (1,))
    ain = tuple(Shard(0) if _shard_dim(p, 3) == 0 and not isinstance(q, Shard) else Replicate()
                for p, q in zip(a.placements, bin_))
    outs = tuple(Shard(0) if isinstance(p, Shard) else Shard(2) if isinstance(q, Shard)
                 else Replicate() for p, q in zip(ain, bin_))
    return local_call(fn, (a, b), (ain, bin_), (_grad_pl(ain, [bin_]), _grad_pl(bin_, [ain])),
                      outs)


def nll(logits, labels):
    """Mean of ``logsumexp(logits) - logits[label]`` over every position.

    Under a mesh each rank takes its batch rows.  On vocab-sharded logits the max,
    the sum of exponentials and the gold logit are reduced over the vocab axis
    (the sum and the gold logit differentiably, through DTensor).  A rank's mean
    is weighted by its share of the rows and summed: on a mesh of one rank that is
    the single-device mean, bit for bit."""
    if not is_dtensor(logits, labels):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - gold)
    DTensor, Partial, Replicate, Shard = _classes()
    mesh = logits.device_mesh
    lin = _keep(logits, (0, 2))
    vocab = [v and mesh.size(m) > 1 for m, v in enumerate(_sharded(lin, 3, 2))]
    rows = [_shard_dim(p, 3) == 0 for p in lin]
    yin = tuple(Shard(0) if r else Replicate() for r in rows)
    v0, vl = _offset(mesh, lin, 3, 2, logits.shape[2])
    share = 1.0
    for m, r in enumerate(rows):
        share /= mesh.size(m) if r else 1

    def over_vocab(t, op: str = "sum"):
        """``t`` (a local partial over the vocab axis) reduced over it."""
        pl = tuple(Partial(op) if v else Replicate() for v in vocab)
        return parallel.redistribute(DTensor.from_local(t, mesh, pl, run_check=False),
                                     tuple(Replicate() for _ in vocab)).to_local()

    def run(lg, lab):
        lab = lab.long()
        if not any(vocab):
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, lab[..., None])[..., 0]
        else:
            with torch.no_grad():
                m = over_vocab(lg.amax(dim=-1), "max")
            logz = torch.log(over_vocab(torch.exp(lg - m[..., None]).sum(-1))) + m
            i = lab - v0
            inside = (i >= 0) & (i < vl)
            g = torch.gather(lg, -1, torch.where(inside, i, 0)[..., None])[..., 0]
            gold = over_vocab(g * inside.to(g.dtype))
        mean = torch.mean(logz - gold)
        return mean * share if share != 1.0 else mean

    outs = tuple(Partial() if r else Replicate() for r in rows)
    out = local_call(run, (logits, labels), (lin, yin), (lin, None), outs)
    return parallel.redistribute(out, tuple(Replicate() for _ in rows))


def moe(core: Callable, x, router, wi, wg, wo, *, full_capacity: bool):
    """The MoE's routing, dispatch, experts and combine (``core``, the single-device
    body of ``layers.moe_apply``) on local shards.

    Each rank routes its own groups (batch rows) with the whole router, and runs
    its own experts: a block of the expert dim where experts are sharded, or a
    block of every expert's FFN width where they fall back (grok: 8 experts on a
    16-way axis).  Either way a rank's output is a partial sum over the expert
    axis, all-reduced here in f32.  Decode's single group spans the whole batch,
    so there the rows are gathered first.  The load-balancing statistics (the
    mean router probability and the mean assignment count of each expert) are
    summed over the ranks' groups before the aux loss is formed from them."""
    if not is_dtensor(x, router, wi, wg, wo):
        return core(x, router, wi, wg, wo, 0, x.shape[0] * x.shape[1])
    DTensor, Partial, Replicate, Shard = _classes()
    mesh = x.device_mesh
    xin = tuple(Replicate() for _ in x.placements) if full_capacity else _keep(x, (0,))
    rows = [isinstance(p, Shard) for p in xin]
    ein = _keep(wi, (0, 2))  # experts (dim 0) or the FFN width (dim 2)
    experts = _sharded(ein, 3, 0)
    width = _sharded(ein, 3, 2)
    woin = tuple(Shard(1) if w else p for p, w in zip(ein, width))
    rin = tuple(Replicate() for _ in xin)
    e0, _ = _offset(mesh, ein, 3, 0, wi.shape[0])
    tokens = x.shape[0] * x.shape[1]
    owned = [e or w for e, w in zip(experts, width)]
    ypl = tuple(Partial() if o else (Shard(0) if r else Replicate()) for o, r in zip(owned, rows))

    # the statistics are replicated over the expert axis: only its first rank
    # contributes them, so their gradients are counted once in the partial sums
    coord = mesh.get_coordinate()
    lead = all(coord[m] == 0 for m, o in enumerate(owned) if o)
    spl = tuple(Partial() if r or o else Replicate() for r, o in zip(rows, owned))

    def run(xl, r, a, b, c):
        y, me, ce = core(xl, r, a, b, c, e0, tokens)
        return (y, me, ce) if lead else (y, me * 0.0, ce * 0.0)

    wgrad = _grad_pl(ein, [xin])
    y, me, ce = local_call(
        run, (x, router, wi, wg, wo), (xin, rin, ein, ein, woin),
        (_grad_pl(xin, [ein]), _grad_pl(rin, [xin, ein]), wgrad, wgrad,
         _grad_pl(woin, [xin])), (ypl, spl, spl))
    rep = tuple(Replicate() for _ in xin)
    y = parallel.redistribute(y, tuple(Shard(0) if r else Replicate() for r in rows))
    return y, parallel.redistribute(me, rep), parallel.redistribute(ce, rep)


def cache_put(cache, index: torch.Tensor | slice, src) -> None:
    """``cache[:, :, index] = src`` in place (no autograd): a decode cache (B, KVH,
    T, hd) takes ``src`` (B, KVH, len, hd) at sequence slots ``index``.  Under a
    mesh ``src`` takes the cache's batch and head placements, and where the cache
    is sharded on its sequence dim (a long context's ``kv_seq``) each rank writes
    the slots in its block."""
    if not is_dtensor(cache):
        cache[:, :, index] = src.to(cache.dtype)
        return
    _, _, Replicate, Shard = _classes()
    mesh = cache.device_mesh
    src_pl = tuple(p if _shard_dim(p, 4) in (0, 1) else Replicate() for p in cache.placements)
    local = parallel.redistribute(src, src_pl).to_local().to(cache.dtype)
    c = cache.to_local()
    t0, tl = _offset(mesh, cache.placements, 4, 2, cache.shape[2])
    if (t0, tl) == (0, cache.shape[2]):
        c[:, :, index] = local
        return
    if not isinstance(index, slice):
        raise ValueError("a sequence-sharded cache takes a contiguous run of slots")
    a, b, _ = index.indices(cache.shape[2])
    lo, hi = max(a, t0), min(b, t0 + tl)  # the slots in this rank's block
    if lo < hi:
        c[:, :, lo - t0:hi - t0] = local[:, :, lo - a:hi - a]
