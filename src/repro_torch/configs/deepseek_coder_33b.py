"""DeepSeek-Coder 33B — dense llama-arch GQA transformer.

[arXiv:2401.14196; hf] 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256."""

from repro_torch.models import ModelConfig

SUBQUADRATIC = False


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab=32256,
        fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-reduced",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
