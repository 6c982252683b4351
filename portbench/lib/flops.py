"""Operations and bytes the algorithms need, from a cell's shapes alone.

Model FLOPs count 2 per multiply-add of a matrix product and leave recomputation out.
A roofline bound is the larger of a call's FLOPs over the peak and its bytes (each
input read once, each output written once) over the memory rate.
"""

from __future__ import annotations

from . import peaks


def causal_pairs(q_len: int, start: int = 0) -> int:
    """Visible (query, key) pairs of ``q_len`` queries at positions start.. with every
    earlier key visible: query i sees start + i + 1 keys."""
    return q_len * start + q_len * (q_len + 1) // 2


def zoo_matmul_params(m: dict) -> int:
    """Matrix parameters of a dense decoder (``model`` block of a configuration): the
    attention and GLU projections of every layer and the untied head.  The embedding
    is a lookup, not a product."""
    D, H, KVH, F, V, L = (m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"],
                          m["vocab"], m["n_layers"])
    hd = D // H
    per_layer = D * H * hd * 2 + D * KVH * hd * 2 + 3 * D * F
    return L * per_layer + D * V


def zoo_train_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 · matmul params · tokens + 12 · layers ·
    batch · heads · head_dim · visible pairs."""
    hd = m["d_model"] // m["n_heads"]
    return (6 * zoo_matmul_params(m) * batch * seq
            + 12 * m["n_layers"] * batch * m["n_heads"] * hd * causal_pairs(seq))


def zoo_serve_flops(m: dict, batch: int, q_len: int, start: int) -> float:
    """Model FLOPs of a forward over ``q_len`` new tokens a row after ``start`` cached
    ones: 2 · matmul params · tokens + 4 · layers · batch · heads · head_dim · pairs."""
    hd = m["d_model"] // m["n_heads"]
    return (2 * zoo_matmul_params(m) * batch * q_len
            + 4 * m["n_layers"] * batch * m["n_heads"] * hd * causal_pairs(q_len, start))


def attn_fwd_bound_s(m: dict, batch: int, seq: int, dtype_bytes: int, peak: float) -> float:
    """The least time of one causal attention forward (B, H, S, hd) over (B, KVH, S,
    hd): 4 · B · H · hd · pairs FLOPs against ``peak``, or q, k, v read and o written."""
    H, KVH, hd = m["n_heads"], m["n_kv_heads"], m["d_model"] // m["n_heads"]
    flops = 4 * batch * H * hd * causal_pairs(seq)
    nbytes = dtype_bytes * batch * seq * hd * (2 * H + 2 * KVH)
    return max(flops / peak, nbytes / peaks.HBM_BYTES_PER_S)


def myia_matmul_params(d: dict) -> int:
    """The tanh-MLP LM's matrix parameters: W1, W2 and Wout."""
    return 2 * d["d_model"] * d["d_hidden"] + d["d_model"] * d["vocab"]


def myia_train_flops(d: dict, batch: int, seq: int) -> float:
    return 6 * myia_matmul_params(d) * batch * seq


def myia_k1_bytes(d: dict, batch: int, seq: int) -> dict[str, int]:
    """Bytes of each elementwise cluster of the Myia LM's adjoint, f32, by kind of
    cluster: the one-hot of the labels (written, with the labels' rows read as wide as
    the vocabulary), each tanh backward (two inputs read, one output written) at the
    hidden widths D and H, and the reductions of the loss over (B, S, V) (two inputs
    read), of which a step runs two."""
    rows = batch * seq
    return {
        "onehot": 4 * 2 * rows * d["vocab"],
        "tanh_bwd_d": 4 * 3 * rows * d["d_model"],
        "tanh_bwd_h": 4 * 3 * rows * d["d_hidden"],
        "reduce": 4 * 2 * rows * d["vocab"],
    }
