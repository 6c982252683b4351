"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit).  A share against them is stated beside the card's power limit, which a run
prints on an earlier line."""

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
F32_FLOPS = 67e12  # FMA outside the tensor cores (f32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12

BY_DTYPE = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
