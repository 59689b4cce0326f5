"""K2, the scale-1 refiner's chain of depthwise-separable blocks
(`csrc/dw_chain.cu`): N x (dw 5x5 + affine + ReLU, then the C x C 1x1).
Least bytes a chain: its input and output plane once in bf16 and every
block's weights. Operations: 2 n C 25 + 2 n C C a block (n pixels)."""

KERNELS = r"(^|[\s:])dw_block_kernel\b"


def _chained(r: dict) -> bool:
    return r["hidden_dim"] < 64 and r["in_dim"] == r["hidden_dim"] and r["kernel_size"] == 5


def launches(cfg: dict, traffic: dict) -> list:
    if "refiners" not in cfg:
        return []
    images = 2 * traffic["pairs"] if cfg["symmetric"] else traffic["pairs"]
    res = [cfg["coarse_resolution"]] + ([cfg["upsample_resolution"]] if cfg["upsample_preds"] else [])
    out = []
    for s, r in cfg["refiners"].items():
        if not _chained(r):
            continue
        C, N, k = r["hidden_dim"], 1 + r["hidden_blocks"], r["kernel_size"]
        for h, w in res:
            n = images * (h // int(s)) * (w // int(s))
            out.append((2 * n * C * 2 + N * (k * k * C * 2 + C * C * 2 + 3 * C * 4),
                        N * (2 * n * C * k * k + 2 * n * C * C), 0.0))
    return out
