"""Weights made on the device from the run's seed, in the types they are served in, in
one draw: every matrix is a slice of one normal draw scaled by the configuration's
``init_std``; norm weights are ones.  The benchmark hands the same tensors to the
program and to the reference."""

from __future__ import annotations

import math

import torch

from .traffic import generator

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _slices(buf: torch.Tensor, shapes: list[tuple[int, ...]]) -> list[torch.Tensor]:
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(buf[at:at + n].view(shape))
        at += n
    return out


def draw(seed: int, shapes: list[tuple[int, ...]], std: float, dtype, device) -> list:
    buf = torch.randn(sum(math.prod(s) for s in shapes), generator=generator(seed, 0, device),
                      dtype=dtype, device=device)
    return _slices(buf.mul_(std), shapes)


def zoo_params(m: dict, std: float, seed: int, device) -> dict:
    """A dense decoder's weights in the program's layout (see
    ``portbench/reference/internlm2.py``): matrices in ``param_dtype``, norms in f32."""
    D, H, KVH, F, V, L = (m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"],
                          m["vocab"], m["n_layers"])
    hd = D // H
    layer = [("wq", (D, H, hd)), ("wk", (D, KVH, hd)), ("wv", (D, KVH, hd)),
             ("wo", (H, hd, D)), ("wi", (D, F)), ("wg", (D, F)), ("fo", (F, D))]
    shapes = [(V, D), (D, V)] + [s for _ in range(L) for _, s in layer]
    mats = draw(seed, shapes, std, DTYPES[m["param_dtype"]], device)

    def ones():
        return torch.ones((D,), dtype=torch.float32, device=device)

    layers, it = [], iter(mats[2:])
    for _ in range(L):
        w = {name: next(it) for name, _ in layer}
        layers.append({
            "norm1": ones(),
            "mixer": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
            "norm2": ones(),
            "ffn": {"wi": w["wi"], "wg": w["wg"], "wo": w["fo"]},
        })
    return {"embed": mats[0], "layers": layers, "final_norm": ones(), "lm_head": mats[1]}


def myia_params(d: dict, std: float, seed: int, device) -> tuple:
    """The tanh-MLP LM's (emb, w1, w2, wout), f32."""
    V, D, H = d["vocab"], d["d_model"], d["d_hidden"]
    return tuple(draw(seed, [(V, D), (D, H), (H, D), (D, V)], std, torch.float32, device))
