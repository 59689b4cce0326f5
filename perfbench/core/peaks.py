"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit), and the least time for a piece of work."""

BF16_FLOPS = 989e12   # tensor cores, bf16, a second
HBM_BYTES = 3.35e12   # HBM3 bytes a second
EXPS = 3.9e12         # exponentials a second on the special-function units
                      # (the FlashAttention-3 paper's figure)


def bound_ms(nbytes: float, flops: float, exps: float = 0.0) -> float:
    """The larger of the bytes over the memory rate and the operations
    (tensor-core products, or exponentials, whichever take longer) over
    their peak."""
    return max(nbytes / HBM_BYTES, flops / BF16_FLOPS, exps / EXPS) * 1e3
