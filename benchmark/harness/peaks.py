"""The card's published peaks: NVIDIA H100 SXM5 data sheet, dense rates
(no sparsity), at the card's full 700 W power limit. A card set below it
runs slower under load, so every result carries the card's power limit."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12      # the fastest rate of any arithmetic on float32 inputs
BF16_FLOPS_PER_S = 989e12


def flops_per_s(model: dict) -> float:
    """The peak that a configuration's step is held to: TF32's for a
    float32 model, bf16's for a bf16 one."""
    return BF16_FLOPS_PER_S if model.get("compute_dtype") == "bfloat16" else TF32_FLOPS_PER_S
