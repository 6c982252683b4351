"""InternLM2 1.8B — dense GQA transformer.

[arXiv:2403.17297; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544."""

from repro_torch.models import ModelConfig

SUBQUADRATIC = False  # pure full attention


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92544,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-reduced",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
