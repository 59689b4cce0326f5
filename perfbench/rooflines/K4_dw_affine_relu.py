"""K4, the wide refiners' depthwise 5x5 + affine + ReLU (`csrc/dw_affine_relu.cu`),
one launch a block of every refiner that is not chained. Least bytes a
launch: the bf16 plane in and out, the weights and the float32 scale and
shift. Operations: 2 n 25 (n = B C H W)."""

KERNELS = r"(^|[\s:])dw_affine_relu_kernel\b"


def launches(cfg: dict, traffic: dict) -> list:
    if "refiners" not in cfg:
        return []
    images = 2 * traffic["pairs"] if cfg["symmetric"] else traffic["pairs"]
    patch = cfg["dinov2"]["patch"]
    (hc, wc), (hu, wu) = cfg["coarse_resolution"], cfg["upsample_resolution"]
    passes = [(hc, wc, ("16", "8", "4", "2", "1"))]
    if cfg["upsample_preds"]:
        passes.append((hu, wu, ("8", "4", "2", "1")))
    out = []
    for h, w, scales in passes:
        for s in scales:
            r = cfg["refiners"][s]
            C, k = r["hidden_dim"], r["kernel_size"]
            if k != 5 or (C < 64 and r["in_dim"] == C):
                continue
            side = patch if s == "16" else int(s)
            n = images * C * (h // side) * (w // side)
            out += [(2 * n * 2 + k * k * C * 2 + 2 * C * 4, 2 * n * k * k, 0.0)] * (1 + r["hidden_blocks"])
    return out
