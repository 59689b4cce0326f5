"""K3, flash attention's forward (`csrc/flash_attn.cu`): softmax(q k^T /
sqrt(d)) v over DINOv2's tokens and the match decoder's. Least bytes a
launch: q, k, v and the output once in bf16. Operations: 4 B H N^2 d on
the tensor cores and B H N^2 exponentials."""

KERNELS = r"(^|[\s:])flash_fwd_kernel\b"


def launches(cfg: dict, traffic: dict) -> list:
    if "dinov2" not in cfg:
        return []
    d, dec = cfg["dinov2"], cfg["decoder"]
    hc, wc = cfg["coarse_resolution"]
    tokens = (hc // d["patch"]) * (wc // d["patch"])
    pairs = traffic["pairs"]
    out = []
    for B, N, H, D, calls in ((2 * pairs, tokens + 1, d["heads"], d["dim"] // d["heads"], d["depth"]),
                              (2 * pairs if cfg["symmetric"] else pairs, tokens, dec["heads"],
                               dec["dim"] // dec["heads"], dec["blocks"])):
        out += [(4 * B * N * H * D * 2, 4 * B * H * N * N * D, B * H * N * N)] * calls
    return out
