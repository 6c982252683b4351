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
from .model import Params, check_supported


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


def _layer(cfg: ModelConfig, spec: LayerSpec, lp: dict, device: torch.device) -> Params:
    pd = cfg.pdtype
    matrices, vectors = _MIXER_LEAVES[spec.mixer]
    mixer = {n: _tensor(lp["mixer"][n], pd, device) for n in matrices}
    mixer.update({n: _tensor(lp["mixer"][n], torch.float32, device) for n in vectors})
    p = {"norm1": _tensor(lp["norm1"], torch.float32, device), "mixer": mixer}
    if spec.ffn:
        p["norm2"] = _tensor(lp["norm2"], torch.float32, device)
        p["ffn"] = {n: _tensor(lp["ffn"][n], pd, device) for n in ("wi", "wg", "wo")}
    return p


def params_from_jax(
    cfg: ModelConfig, tree: dict, device: str | torch.device = "cuda"
) -> Params:
    """The port's parameters from the reference's pytree (already numpy).

    Segments with ``reps > 1`` hold every leaf stacked on a leading axis;
    they are unstacked along it in ``stack_init``'s order (repeat-major,
    then position in the pattern), which is depth order.  Matrices come out
    in ``cfg.pdtype`` and norm weights and the Mamba mixer's vectors in f32, as
    ``init_params`` makes them."""
    dev = resolve_device(device)
    segments = cfg.scan_segments()
    if len(segments) != len(tree["segments"]):
        raise ValueError(
            f"{cfg.name} has {len(segments)} segments, the tree {len(tree['segments'])}"
        )
    layers = []
    for (pattern, reps), seg in zip(segments, tree["segments"]):
        for spec in pattern:
            check_supported(spec)
        for r in range(reps):
            for i, spec in enumerate(pattern):
                lp = seg["layers"][i]
                if reps > 1:
                    lp = _index(lp, r)
                layers.append(_layer(cfg, spec, lp, dev))
    p: Params = {
        "embed": _tensor(tree["embed"], cfg.pdtype, dev),
        "layers": layers,
        "final_norm": _tensor(tree["final_norm"], torch.float32, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _tensor(tree["lm_head"], cfg.pdtype, dev)
    return p


def _index(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]
