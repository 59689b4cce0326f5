"""K7, Tiny RoMa's streaming correlation softmax (`csrc/corr_softmax.cu`):
warp[p] = sum_j softmax_j(<f0[p], f1[j]> / sqrt(C)) grid[j] over the 1/8
maps. Least bytes a launch: f0 and f1 in bf16, the float32 grid and warp.
Operations: 2 B L^2 C + 2 B L^2 2 products and B L^2 exponentials."""

KERNELS = r"(^|[\s:])corr_softmax(_bf16)?_kernel\b"


def launches(cfg: dict, traffic: dict) -> list:
    if not (cfg.get("fused_kernel") and cfg.get("search_mode") == "full"):
        return []
    B, C = traffic["pairs"], cfg["coarse_dim"]
    h, w = traffic["canvas"]
    L = (h // 32 * 4) * (w // 32 * 4)
    return [(2.0 * 2 * B * L * C + 4.0 * (2 * L + 2 * B * L), 2 * B * L * L * C + 2 * B * L * L * 2,
             float(B * L * L))]
