"""Carry the reference package's parameters into the port.

The caller turns the JAX parameter pytree into numpy first
(``jax.tree.map(np.asarray, params)``), so the port never imports jax.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from .common import LayerSpec, ModelConfig
from .model import Params, check_supported, encoder_config


def _tensor(a: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read directly
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


#: Leaves of each mixer: matrices (in ``cfg.pdtype``) and f32 vectors, as
#: ``attn_init`` and ``mamba_init`` make them.
_MIXER_LEAVES = {
    "attn": (("wq", "wk", "wv", "wo"), ()),
    "mamba": (("in_proj", "conv_w", "out_proj"), ("A_log", "D_skip", "dt_bias", "gate_norm")),
}


def _leaves(tree: dict, names, dtype: torch.dtype, device: torch.device) -> Params:
    return {n: _tensor(tree[n], dtype, device) for n in names}


def _ffn(cfg: ModelConfig, spec: LayerSpec, fp: dict, device: torch.device) -> Params:
    """The dense GLU MLP, or the MoE block: its router in f32, its expert tensors and
    Kimi's ``shared`` MLP in ``cfg.pdtype``."""
    glu = ("wi", "wg", "wo")
    out = _leaves(fp, glu, cfg.pdtype, device)
    if spec.moe:
        out["router"] = _tensor(fp["router"], torch.float32, device)
        if cfg.shared_experts:
            out["shared"] = _leaves(fp["shared"], glu, cfg.pdtype, device)
    return out


def _layer(cfg: ModelConfig, spec: LayerSpec, lp: dict, device: torch.device) -> Params:
    pd, f32 = cfg.pdtype, torch.float32
    matrices, vectors = _MIXER_LEAVES[spec.mixer]
    mixer = _leaves(lp["mixer"], matrices, pd, device)
    mixer.update(_leaves(lp["mixer"], vectors, f32, device))
    p = {"norm1": _tensor(lp["norm1"], f32, device), "mixer": mixer}
    if spec.ffn:
        p["norm2"] = _tensor(lp["norm2"], f32, device)
        p["ffn"] = _ffn(cfg, spec, lp["ffn"], device)
    if spec.cross_attn:
        p["norm_x"] = _tensor(lp["norm_x"], f32, device)
        p["cross"] = _leaves(lp["cross"], _MIXER_LEAVES["attn"][0], pd, device)
    return p


def _stack(cfg: ModelConfig, segs: list, device: torch.device) -> list[Params]:
    """The layers of the reference's scan segments, unstacked in depth order."""
    segments = cfg.scan_segments()
    if len(segments) != len(segs):
        raise ValueError(f"{cfg.name} has {len(segments)} segments, the tree {len(segs)}")
    layers = []
    for (pattern, reps), seg in zip(segments, segs):
        for spec in pattern:
            check_supported(spec)
        for r in range(reps):
            for i, spec in enumerate(pattern):
                lp = seg["layers"][i]
                if reps > 1:
                    lp = _index(lp, r)
                layers.append(_layer(cfg, spec, lp, device))
    return layers


def params_from_jax(
    cfg: ModelConfig, tree: dict, device: str | torch.device = "cuda"
) -> Params:
    """The port's parameters from the reference's pytree (already numpy).

    Segments with ``reps > 1`` hold every leaf stacked on a leading axis;
    they are unstacked along it in ``stack_init``'s order (repeat-major,
    then position in the pattern), which is depth order.  Matrices come out
    in ``cfg.pdtype``; norm weights, the Mamba mixer's vectors and the MoE router
    in f32, as ``init_params`` makes them.  An encoder-decoder model's encoder
    segments unstack the same way."""
    dev = resolve_device(device)
    p: Params = {
        "embed": _tensor(tree["embed"], cfg.pdtype, dev),
        "layers": _stack(cfg, tree["segments"], dev),
        "final_norm": _tensor(tree["final_norm"], torch.float32, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _tensor(tree["lm_head"], cfg.pdtype, dev)
    if cfg.enc_dec:
        enc = tree["encoder"]
        p["encoder"] = {
            "layers": _stack(encoder_config(cfg), enc["segments"], dev),
            "final_norm": _tensor(enc["final_norm"], torch.float32, dev),
        }
    return p


def _index(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]
