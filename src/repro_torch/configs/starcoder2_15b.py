"""StarCoder2 15B — dense GQA transformer with RoPE.

[arXiv:2402.19173; hf] 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152."""

from repro_torch.models import ModelConfig

SUBQUADRATIC = False


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24576,
        vocab=49152,
        mlp_act="gelu",
        fsdp=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-reduced",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        mlp_act="gelu",
        param_dtype="float32",
        compute_dtype="float32",
    )
