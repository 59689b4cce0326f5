"""K8 and K9, flash attention's backward (`csrc/flash_attn_bwd.cu`): dK, dV
(K8) and dQ (K9) of softmax(q k^T / sqrt(d)) v from q, k, v, dO, the
forward's log-sum-exp and di = rowsum(o dO), over the match decoder's
tokens in training. Least bytes a launch: q, k, v and dO read once and
its outputs written once in bf16, lse and di in float32: (4 + outputs) B N
H d 2 + 2 B H N 4. Operations: 2 B H N^2 d a GEMM, 4 GEMMs in K8 (S, dP,
dV, dK) and 3 in K9 (S, dP, dQ), and B H N^2 exponentials each (P
recomputed). The launches of one training step: one K8 and one K9 for each
decoder block; none where the configuration trains nothing."""

KERNELS = r"(^|[\s:])(dkv_kernel|dq_kernel|dkv_wgmma_kernel|dq_wgmma_kernel)\b"


def launches(cfg: dict, traffic: dict) -> list:
    if "loss" not in cfg or "decoder" not in cfg:
        return []
    d, dec = cfg["dinov2"], cfg["decoder"]
    hc, wc = cfg["coarse_resolution"]
    N = (hc // d["patch"]) * (wc // d["patch"])
    B = 2 * traffic["pairs"] if cfg["symmetric"] else traffic["pairs"]
    H, D = dec["heads"], dec["dim"] // dec["heads"]
    elem, side = B * N * H * D * 2, 2 * B * H * N * 4
    gemm, exps = 2 * B * H * N * N * D, B * H * N * N
    return [((4 + outs) * elem + side, gemms * gemm, exps)
            for _ in range(dec["blocks"]) for gemms, outs in ((4, 2), (3, 1))]
