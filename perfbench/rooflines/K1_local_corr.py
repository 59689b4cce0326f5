"""K1, the local correlation (`csrc/local_corr.cu`): for every pixel the
(2r+1)^2 bilinear samples of <f0 / sqrt(C), f1> around the warp target.
Least bytes a launch: f0 and f1 in bf16, the float32 flow, the float32
output. Operations: one C-long dot for each of the (2r+2)^2 corners of
every pixel, all in range (what the data can need at most; the bytes
bound every shape here anyway), and the combine's n (C + 7 (2r+1)^2)."""

KERNELS = r"(^|[\s:])(pixel_kernel|box_chunk_kernel|combine_kernel)\b"


def launches(cfg: dict, traffic: dict) -> list:
    if "refiners" not in cfg:
        return []
    images = 2 * traffic["pairs"] if cfg["symmetric"] else traffic["pairs"]
    (hc, wc), (hu, wu) = cfg["coarse_resolution"], cfg["upsample_resolution"]
    patch = cfg["dinov2"]["patch"]
    passes = [(hc, wc, ("16", "8", "4", "2", "1"))]
    if cfg["upsample_preds"]:
        passes.append((hu, wu, ("8", "4", "2", "1")))
    out = []
    for h, w, scales in passes:
        for s in scales:
            r = cfg["refiners"][s]["local_corr_radius"]
            if r is None:
                continue
            side = patch if s == "16" else int(s)
            n = images * (h // side) * (w // side)
            C = cfg["proj_dims"][s][1]
            k2 = (2 * r + 1) ** 2
            out.append((2 * n * C * 2 + n * 2 * 4 + n * k2 * 4,
                        n * (2 * r + 2) ** 2 * 2 * C + n * (C + 7 * k2), 0.0))
    return out
