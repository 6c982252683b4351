"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  Jamba block: 8 layers, 1 attention (index 3),
MoE on every other layer (odd indices).  Our mixer is Mamba-2/SSD
(DESIGN.md §3 — the paper-era Mamba-1 selective scan and SSD share the
recurrence; SSD is the TPU-native chunked form)."""

from repro_torch.models import LayerSpec, ModelConfig

SUBQUADRATIC = True  # hybrid: constant-state mixers dominate → long_500k runs

_PERIOD = tuple(
    LayerSpec(mixer=("attn" if i == 3 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        layer_period=_PERIOD,
        num_experts=16,
        top_k=2,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        layer_period=tuple(
            LayerSpec(mixer=("attn" if i == 3 else "mamba"), moe=(i % 2 == 1))
            for i in range(8)
        ),
        num_experts=4,
        top_k=2,
        ssm_state=16,
        ssm_head_dim=16,
        capacity_factor=8.0,
        param_dtype="float32",
        compute_dtype="float32",
    )
