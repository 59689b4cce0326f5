#!/usr/bin/env python3
"""Chip smoke test of the roma_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out DIR]

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from roma_torch/csrc (one nvcc per source, all
   in parallel) into build/kernels/;
3. builds full-width roma_outdoor() (ViT-L/14 24 blocks, 560 -> 864,
   symmetric, bf16) with random weights from seed 0;
4. holds every kernel against its plain PyTorch version at each shape the
   main paths give it (2 pairs per full-RoMa match, 8 pairs per Tiny RoMa
   match), plus ragged shapes where the tiling has edges (attention at
   N = 1, 63, 65, 129, 193 and 1601, both head widths, qkv views and
   contiguous tensors; the depthwise block at rows that are not 16-byte
   aligned, 1 x W and H x 1 planes, sizes off a multiple of 8; the chained
   scale-1 block one block at a time within one bf16 ulp, C = 5 to 64),
   and times the kernel (and prints it as a share of its bound), the plain
   version and, where one exists, the single PyTorch call computing the same
   function (SDPA for attention and the correlation softmax, F.grid_sample
   for the windowed gather, cuDNN's depthwise conv for the wide depthwise
   block). Local correlation runs on the inputs the main path hands it
   (captured from one default match()) and on a scattered and a smooth
   synthetic flow, with the path each 8 x 8 tile took held against
   `tile_plan`; the correlation softmax through both its entries, bf16 and
   float32. The whole-block kernel (dw_block_mm) is on no model path, as in
   the JAX package: it is checked and timed here at the scale-2 and scale-1
   shapes beside "wide depthwise kernel + cuDNN 1x1", and its launches in
   the kernels line are 0. The windowed gather runs both its modes on a
   smooth and a random flow, its in-kernel origins and `ok` held against
   the plan, the exact mode under a sync-raising debug mode, and a float32
   map (other builds of a kernel are timed side by side by
   kernel_variants.py);
5. default full RoMa: RomaMatcher.match on 2 pairs, once to warm up, once
   with the launch counters reset just before it and read just after it
   (each kernel must show exactly its expected launches), and 3 more times
   for the rate; with --profile, one more run under torch.profiler (also
   for Tiny RoMa below); then the outputs (shapes, finite, certainty in
   [0, 1], sampling);
6. match_raw on 2 pairs of uint8 canvases from two source sizes, resized
   on the device: counted (the same launches as match()), timed, held
   against match_prepped on host PIL resizes, then sample_batched; then the
   debug-size model on the GPU against the same weights on the CPU, with
   its flow differences per scale of both passes and the match decoder's
   top-2 class-logit margins where the scale-16 flows differ;
7. Tiny RoMa v1 (fused_kernel=True) on 8 pairs at 480x640, counted the same
   way (one correlation-softmax launch, nothing else), timed, beside the
   same weights with fused_kernel=False, plus one 1056x1920 pair and a
   small GPU-vs-CPU check;
8. full RoMa with smooth_warp_gather="fast", then the same weights with
   smooth_warp_gather=True ("exact"): each counted (2 windowed-gather
   launches with the default path's others), timed, outputs checked;
9. float32 (C3): K1, K2, K3 and K5's float32 entries against their plain
   versions at the main-path shapes (K1 on the captured inputs widened,
   its tile plan all per-pixel), the debug model in float32 on the
   GPU against the CPU (as in 6, with the decoder's margins), and
   full-width match() with RomaConfig(dtype="float32"), counted as the
   default path;
10. flash attention's backward, K8 (dK/dV) and K9 (dQ), against
   attention_bwd_plain in bf16 and float32 at the decoder's training shape
   (2, 1600, 8, 128) and DINOv2's (4, 1601, 16, 64) as qkv views and at
   ragged N, the forward's lse against logsumexp; a copy of the source with
   a planted fault (K8 drops its last query tile, K9 the last query tile),
   built beside the main build, must exceed the bound >= 10x; the kernels,
   the whole attention_bwd_cuda call (di + K8 + K9), the plain version and
   SDPA's whole backward timed, the launch's blocks per SM and waves
   printed, K3's forward with and without lse;
11. training: full-width roma_outdoor() at 560^2, batch 2, bf16, on
   synthetic depth batches, one warm-up and 3 timed steps, the first
   counted (K3 29, K8 5, K9 5; K1, K2, K4, K6 0), finite loss and metrics,
   DINOv2 bit-unchanged, every running statistic moved, samples/s and peak
   memory (with --profile, one step under torch.profiler); then the debug
   model's float32 train step on the GPU against the CPU (loss rel 1e-4,
   gradients under roma_torch.train.grad_parity, the rule
   tests/test_torch_train.py holds JAX and the port to);
12. prints the kernels JSON line, then {"ok": true, "device": ...} last.

Any failure exits non-zero before the last line. Detailed per-shape results
go to DIR/chip_smoke.json (default results/chip_smoke/).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_EXPS = 3.9e12         # H100 SXM5 exponentials a second (special-function units;
                           # the FlashAttention-3 paper's figure)
PAIRS = 2                  # pairs per match(); symmetric -> 4 images per pass
TINY_PAIRS = 8             # pairs per Tiny RoMa match()
TINY_HW = (480, 640)       # RESOLUTION_PRESETS["tiny_bench"]
MEGAPIXEL_HW = (1056, 1920)
# the whole-block kernel's shapes (label, B', C, side): refiner 2 in both
# passes, refiner 1's coarse pass
DW_BLOCK_MM_SHAPES = (("s2 coarse", 4, 144, 280), ("s2 upsample", 4, 144, 432),
                      ("s1 coarse", 4, 24, 560))
SEED = 0                   # weights and data

# kernel -> (TPU kernel it replaces, CUDA source)
KERNELS = {
    "local_corr": ("roma_tpu/ops/pallas/block_gather.py:194",
                   "roma_torch/csrc/local_corr.cu"),
    "dw_chain": ("roma_tpu/ops/pallas/depthwise.py:404",
                 "roma_torch/csrc/dw_chain.cu"),
    "flash_attn": ("roma_tpu/models/transformer.py:22",
                   "roma_torch/csrc/flash_attn.cu"),
    "corr_softmax": ("roma_tpu/ops/pallas/corr_softmax.py:69",
                     "roma_torch/csrc/corr_softmax.cu"),
    "windowed_sample": ("roma_tpu/ops/pallas/windowed_sample.py:266",
                        "roma_torch/csrc/windowed_sample.cu"),
    "dw_affine_relu": ("roma_tpu/ops/pallas/depthwise.py:217",
                       "roma_torch/csrc/dw_affine_relu.cu"),
    "dw_block_mm": ("roma_tpu/ops/pallas/depthwise.py:476",
                    "roma_torch/csrc/dw_block_mm.cu"),
    "flash_attn_dkv": ("jax/experimental/pallas/ops/tpu/flash_attention.py:941",
                       "roma_torch/csrc/flash_attn_bwd.cu"),
    "flash_attn_dq": ("jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
                      "roma_torch/csrc/flash_attn_bwd.cu"),
}
# the training step: full RoMa at 560^2, batch 2, bf16 (1 warm-up + 3 timed)
TRAIN_BATCH = 2
TRAIN_STEPS = 3


class SmokeFailure(RuntimeError):
    pass


def fail_if(cond: bool, msg: str) -> None:
    if cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_rounds(fn, iters: int, rounds: int = 5) -> list[float]:
    """`rounds` readings of cuda_ms, each with its own warm-up, sorted."""
    return sorted(cuda_ms(fn, iters) for _ in range(rounds))


def graph_ms_rounds(fn, iters: int, rounds: int = 5) -> list[float]:
    """Device ms per call of `fn`, `rounds` readings sorted, each a replay of
    one CUDA graph of `iters` calls: no host work between the launches,
    where a kernel takes less time on the card than its wrapper's Python
    takes on the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    out = sorted(cuda_ms(graph.replay, 2) / iters for _ in range(rounds))
    del graph
    return out


def profiled_device_ms(fn, iters: int = 10) -> float:
    """Device ms per call of `fn`: the kernels' own time in a torch.profiler
    trace of `iters` calls (host time excluded), for a library call whose
    host work can outlast its kernels (autograd), where CUDA events would
    time the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages())
    return us / 1e3 / iters


def median(xs: list[float]) -> float:
    return xs[len(xs) // 2]


def bound(bytes_moved: float, flops: float, exps: float = 0.0) -> tuple[float, str]:
    """Least ms for the work: the bytes over the memory rate, or the
    operations (tensor-core products, or exponentials on the
    special-function units, whichever takes longer) over their peak."""
    tb = bytes_moved / PEAK_BYTES * 1e3
    to = max(flops / PEAK_BF16_FLOPS * 1e3, exps / PEAK_EXPS * 1e3)
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------- kernel checks

def capture_local_corr(matcher, gen, dev) -> list:
    """(f0, f1, r, flow) of each local-correlation call of one default
    match() on 2 pairs of random images, in call order: the refiner calls
    the kernel through the module attribute, which is wrapped for this one
    match() and restored."""
    import torch

    from roma_torch.kernels import local_corr as lc

    calls, kernel = [], lc.local_correlation

    def record(f0, f1, r, flow):
        calls.append((f0.clone(), f1.clone(), r, flow.clone()))
        return kernel(f0, f1, r, flow)

    h, w = matcher.cfg.coarse_resolution
    ims = [torch.rand((PAIRS, h, w, 3), generator=gen, device=dev) for _ in range(2)]
    lc.local_correlation = record
    try:
        timed_match(matcher, *ims)
    finally:
        lc.local_correlation = kernel
    return calls


def check_local_corr(dev, gen, cfg, captured):
    """K1 at refiners 16/8/4 of both passes (B' = 4 images), on three inputs
    each: the (f0, f1, flow) the main path hands it (`captured`, from one
    default match()), random features on a scattered flow (identity + 0.3
    N(0, 1) in normalized units, the worst case for reuse) and on a
    smooth flow (`smooth_sine_grid`), each synthetic flow with one pixel far
    out of range, whose output must be exactly zero. Tolerance 1e-3
    absolute (fp32 sums in another order). The kernel reports the path of
    each 8 x 8 tile, which must equal `tile_plan`'s; both paths must take
    tiles over all inputs. Per input: mean in-range corners a pixel, the
    window-row bytes (in-range corners x C x 2) and their read rate, the
    tile window union's median and 90th percentile, reuse (corner reads
    over union pixels), the kernel's time, the bound (bytes of f0, f1, the
    flow and the output). The headline row is the captured input's, its
    plain time too. Then C = 640 and 1024 on both paths (`ragged`)."""
    import torch

    from roma_torch.kernels import local_corr as lc
    from roma_torch.ops.corr import coord_grid

    hc, hu = cfg.coarse_resolution[0], cfg.upsample_resolution[0]
    shapes = [("coarse s16", hc // 14, 512, 7), ("coarse s8", hc // 8, 512, 3),
              ("coarse s4", hc // 4, 256, 2), ("upsample s8", hu // 8, 512, 3),
              ("upsample s4", hu // 4, 256, 2)]
    got_shapes = [(f0.shape[1], f0.shape[3], r) for f0, _, r, _ in captured]
    fail_if(got_shapes != [(h, C, r) for _, h, C, r in shapes],
            f"local_corr: the main path's calls {got_shapes} are not the expected shapes")
    B = 2 * PAIRS
    rows, tiles_on = [], {"shared": 0, "pixel": 0}
    for (label, h, C, r), (cf0, cf1, _, cflow) in zip(shapes, captured):
        f0 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        f1 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        scattered = (coord_grid(h, h, device=dev).expand(B, h, h, 2)
                     + 0.3 * torch.randn((B, h, h, 2), generator=gen, device=dev)).contiguous()
        smooth = smooth_sine_grid(B, h, h, dev)
        for fl in (scattered, smooth):
            fl[0, 0, 0] = torch.tensor([40.0, -40.0], device=dev)  # far out of range
        k2 = (2 * r + 1) ** 2
        n_pix = B * h * h
        nbytes = 2 * n_pix * C * 2 + n_pix * 2 * 4 + n_pix * k2 * 4
        inputs = {}
        for kind, (a, b, fl) in (("captured", (cf0, cf1, cflow)), ("scattered", (f0, f1, scattered)),
                                 ("smooth", (f0, f1, smooth))):
            paths = torch.empty(lc.tile_plan(fl, r).shared.shape, dtype=torch.int32, device=dev)
            got = lc.local_correlation_cuda(a, b, r, fl, tile_paths=paths)
            ref = lc.local_correlation_plain(a, b, r, fl)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            fail_if(not math.isfinite(err) or err > 1e-3,
                    f"local_corr {label} {kind}: max_abs_err {err}")
            fail_if(kind != "captured" and bool((got[0, 0, 0] != 0).any()),
                    f"local_corr {label} {kind}: out-of-range pixel not zero")
            plan = lc.tile_plan(fl, r)
            fail_if(not torch.equal(paths.bool(), plan.shared),
                    f"local_corr {label} {kind}: the kernel's paths differ from tile_plan's")
            shared = int(plan.shared.sum().item())
            tiles_on["shared"] += shared
            tiles_on["pixel"] += plan.shared.numel() - shared
            corners = float(plan.corners.sum().item())
            unions = plan.union[plan.union > 0].float()
            window_bytes = corners * C * 2
            ms = cuda_ms(lambda: lc.local_correlation(a, b, r, fl), 20)
            b_ms, b_by = bound(nbytes, corners * 2 * C + n_pix * (C + 7 * k2))
            res = dict(max_abs_err=err, ms=ms, bound_ms=b_ms, bound_by=b_by,
                       shared_tiles=shared, tiles=plan.shared.numel(),
                       corners_per_pixel=corners / n_pix, window_row_bytes=window_bytes,
                       read_rate_tb_s=window_bytes / (ms * 1e-3) / 1e12,
                       union_median=torch.quantile(unions, 0.5).item(),
                       union_q90=torch.quantile(unions, 0.9).item(),
                       reuse=corners / unions.sum().item())
            inputs[kind] = res
        head = inputs["captured"]
        rows.append(dict(shape=label, dims=[B, h, h, C], radius=r, calls=1,
                         max_abs_err=max(v["max_abs_err"] for v in inputs.values()), tol=1e-3,
                         ms=head["ms"],
                         plain_ms=cuda_ms(lambda: lc.local_correlation_plain(cf0, cf1, r, cflow), 3, 1),
                         library_ms=None, bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                         inputs=inputs))
        del f0, f1, inputs
    # widths past the main path's (C = 640 and 1024, which the wrapper
    # accepts) on both paths, 2 x 45 x 53: r = 3 (per-pixel tiles only) on a
    # scattered flow, r = 7 on a smooth flow (shared tiles)
    ragged = []
    for C, r, kind in ((640, 3, "scattered"), (1024, 3, "scattered"), (640, 7, "smooth"),
                       (1024, 7, "smooth")):
        Bg, hg, wg = 2, 45, 53
        f0 = torch.randn((Bg, hg, wg, C), generator=gen, device=dev).to(torch.bfloat16)
        f1 = torch.randn((Bg, hg, wg, C), generator=gen, device=dev).to(torch.bfloat16)
        if kind == "scattered":
            fl = (coord_grid(hg, wg, device=dev).expand(Bg, hg, wg, 2)
                  + 0.3 * torch.randn((Bg, hg, wg, 2), generator=gen, device=dev)).contiguous()
        else:
            fl = smooth_sine_grid(Bg, hg, wg, dev)
        plan = lc.tile_plan(fl, r)
        paths = torch.empty(plan.shared.shape, dtype=torch.int32, device=dev)
        got = lc.local_correlation_cuda(f0, f1, r, fl, tile_paths=paths)
        err = (got - lc.local_correlation_plain(f0, f1, r, fl)).abs().max().item()
        what = f"local_corr ragged C={C} r={r} {kind}"
        fail_if(not math.isfinite(err) or err > 1e-3, f"{what}: max_abs_err {err}")
        fail_if(not torch.equal(paths.bool(), plan.shared),
                f"{what}: the kernel's paths differ from tile_plan's")
        shared = int(plan.shared.sum().item())
        fail_if(shared == (0 if r >= lc.SHARE_MIN_R else plan.shared.numel()),
                f"{what}: no tile on the {'shared' if r >= lc.SHARE_MIN_R else 'per-pixel'} path")
        tiles_on["shared"] += shared
        tiles_on["pixel"] += plan.shared.numel() - shared
        ragged.append(dict(dims=[Bg, hg, wg, C], radius=r, flow=kind, max_abs_err=err,
                           shared_tiles=shared, tiles=plan.shared.numel()))
    rows[0]["ragged"] = ragged
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], *(x["max_abs_err"] for x in ragged))
    fail_if(min(tiles_on.values()) == 0,
            f"local_corr: a path took no tile over all inputs ({tiles_on})")
    rows[0]["tiles_on"] = tiles_on
    return rows


def chain_params(model):
    """The scale-1 refiner's 9 blocks, folded as the refiner hands them to
    the chain: ws, scales, shifts, ms, biases stacked over blocks."""
    import torch

    cols = [blk.fused(torch.bfloat16) for blk in model.decoder.conv_refiner["1"].blocks()]
    return [torch.stack([c[i] for c in cols]).contiguous() for i in range(5)]


# K2's ragged shapes (B, C, H, W): H and W off the 16 x 32 (C <= 32) or 8 x 32
# tile, 1 x W and H x 1 planes, W % 8 != 0 (element-wise loads and stores),
# every padded width Cp = 16, 32, 48, 64
DW_CHAIN_RAGGED = tuple((1, C, H, W) for C in (8, 24, 40, 63)
                        for H, W in ((37, 53), (1, 70), (70, 1))) + (
    (2, 24, 45, 64), (1, 16, 21, 40), (1, 32, 19, 96), (1, 64, 13, 72), (3, 5, 17, 33))
DW_CHAIN_RAGGED_CHAIN = (1, 40, 37, 53)


def check_dw_chain(dev, gen, cfg, params):
    """K2. One block (N = 1) against block_plain_nchw elementwise at one bf16
    ulp, |kernel - plain| <= 2^-7 |plain| + 1e-5: y is rounded at the same
    point after the same FMA order, and only the mix's float32 sum order
    (tensor cores against cuBLAS) differs before z's one rounding. At both
    main-path shapes with the refiner's first block, and at DW_CHAIN_RAGGED
    with random weights. The 9-block chain at 3e-2 x max(1, max|plain|)
    (one bf16 ulp at the output's largest magnitude, compounded over the
    chain) at the main-path shapes and at one ragged shape. Every case is
    checked before a failure is raised, and a failure names each case with
    its worst error over its tolerance. Times: the chain call (9 launches and
    the weight packing) as the median of 5 replays of a CUDA graph of 5
    calls, the plain chain, and the nearest library composite, K4 + cuDNN's
    bf16 1x1 conv with bias chained nine times (a comparison, not one call:
    library_ms stays null)."""
    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import dw_affine_relu as k4
    from roma_torch.kernels import dw_chain

    failures = []

    def compare(got, ref, what, chain):
        torch.cuda.synchronize()
        g, r = got.float(), ref.float()
        d = (g - r).abs()
        err = d.max().item()
        if chain:
            tol = 3e-2 * max(1.0, r.abs().max().item())
            worst = err / tol
        else:
            tol = "2^-7 |plain| + 1e-5"
            worst = (d / (2.0 ** -7 * r.abs() + 1e-5)).max().item()
        if not math.isfinite(err) or worst > 1.0:
            failures.append(f"{what}: max_abs_err {err:.3e}, worst err/tol {worst:.3g}")
        return dict(max_abs_err=err, worst_err_over_tol=worst, tol=tol,
                    differing_share=(g != r).float().mean().item())

    def random_params(N, C):
        ws = (0.2 * torch.randn((N, 5, 5, C), generator=gen, device=dev)).to(torch.bfloat16)
        scales = 0.5 + torch.rand((N, C), generator=gen, device=dev)
        shifts = 0.1 * torch.randn((N, C), generator=gen, device=dev)
        ms = (0.2 * torch.randn((N, C, C), generator=gen, device=dev)).to(torch.bfloat16)
        biases = 0.1 * torch.randn((N, C), generator=gen, device=dev)
        return [ws, scales, shifts, ms, biases]

    def block_case(x, p, what):
        one = [t[:1] for t in p]
        return compare(dw_chain.chain_nchw(x, *one),
                       dw_chain.block_plain_nchw(x, *(t[0] for t in one)), what, False)

    ragged = []
    for B, C, H, W in DW_CHAIN_RAGGED:
        x = torch.randn((B, C, H, W), generator=gen, device=dev).to(torch.bfloat16)
        res = block_case(x, random_params(1, C), f"one block ragged {(B, C, H, W)}")
        ragged.append(dict(dims=[B, C, H, W], blocks=1, **res))
    B, C, H, W = DW_CHAIN_RAGGED_CHAIN
    x = torch.randn((B, C, H, W), generator=gen, device=dev).to(torch.bfloat16)
    p = random_params(9, C)
    res = compare(dw_chain.chain_nchw(x, *p), dw_chain.chain_plain_nchw(x, *p),
                  f"chain ragged {(B, C, H, W)}", True)
    ragged.append(dict(dims=[B, C, H, W], blocks=9, **res))

    N, C = params[0].shape[0], params[0].shape[-1]
    B = 2 * PAIRS
    cases = []
    for label, h in (("coarse s1", cfg.coarse_resolution[0]),
                     ("upsample s1", cfg.upsample_resolution[0])):
        x = torch.randn((B, C, h, h), generator=gen, device=dev).to(torch.bfloat16)
        one = block_case(x, params, f"one block {label}")
        chain = compare(dw_chain.chain_nchw(x, *params), dw_chain.chain_plain_nchw(x, *params),
                        f"chain {label}", True)
        cases.append((label, h, x, one, chain))
    fail_if(bool(failures), "dw_chain: " + "; ".join(failures))

    ws, scales, shifts, ms, biases = params
    m4 = [m.T[:, :, None, None].contiguous() for m in ms]
    b4 = biases.to(torch.bfloat16)

    def k4_cudnn(x):
        for j in range(N):
            x = F.conv2d(k4.dw5x5_affine_relu_nchw(x, ws[j], scales[j], shifts[j]), m4[j], b4[j])
        return x

    rows = []
    for label, h, x, one, chain in cases:
        n_pix = B * h * h
        weights = N * (25 * C * 2 + C * C * 2 + 3 * C * 4)
        flops = N * n_pix * (25 * C * 2 + C * C * 2 + 4 * C)
        b_ms, b_by = bound(2 * n_pix * C * 2 + weights, flops)
        ms_rounds = graph_ms_rounds(lambda: dw_chain.chain_nchw(x, *params), 5)
        lib_rounds = graph_ms_rounds(lambda: k4_cudnn(x), 5)
        rows.append(dict(shape=label, dims=[B, C, h, h], blocks=N, calls=1,
                         max_abs_err=max(one["max_abs_err"], chain["max_abs_err"]),
                         tol=chain["tol"], one_block=one, chain=chain,
                         ms=median(ms_rounds), ms_rounds=ms_rounds,
                         ms_per_launch=median(ms_rounds) / N,
                         plain_ms=cuda_ms(lambda: dw_chain.chain_plain_nchw(x, *params), 3, 1),
                         k4_cudnn_1x1_ms=median(lib_rounds), k4_cudnn_1x1_ms_rounds=lib_rounds,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         launch_floor_ms=N * 2 * n_pix * C * 2 / PEAK_BYTES * 1e3))
    rows[0]["ragged"] = ragged
    return rows


def wide_refiner_shapes(cfg) -> list[tuple[str, int, int, int]]:
    """(label, plane side, C, blocks) of every non-chained DWBlock stack of
    one match(): refiners 16/8/4/2 in the coarse pass, 8/4/2 in the
    upsample pass (scale 16 sits on DINOv2's /14 grid)."""
    hc, hu = cfg.coarse_resolution[0], cfg.upsample_resolution[0]
    side = lambda h, s: h // 14 if s == "16" else h // int(s)
    out = []
    for label, h, scales in (("coarse", hc, ("16", "8", "4", "2")),
                             ("upsample", hu, ("8", "4", "2"))):
        for s in scales:
            rc = cfg.refiners[s]
            out.append((f"{label} s{s}", side(h, s), rc.hidden_dim, 1 + rc.hidden_blocks))
    return out


def dw_inputs(gen, dev, B, C, H, W, dtype):
    """x, w (x 0.2), scale in [0.5, 1.5], shift (x 0.1), as the JAX
    package's kernel tests make them."""
    import torch

    x = torch.randn((B, C, H, W), generator=gen, device=dev).to(dtype)
    w = (0.2 * torch.randn((5, 5, C), generator=gen, device=dev)).to(dtype)
    scale = 0.5 + torch.rand((C,), generator=gen, device=dev)
    shift = 0.1 * torch.randn((C,), generator=gen, device=dev)
    return x, w, scale, shift


def check_dw_affine_relu(dev, gen, cfg):
    """K4 at every main-path shape (B' = 4 images) and at ragged ones: odd
    C, H and W off the bands; rows that are not 16-byte aligned (W = 70, 45,
    131 in bf16), 1 x W and H x 1 planes, a tensor whose size is not a
    multiple of 8 elements, float32 cases. Tolerance is
    elementwise, one bf16 ulp of the element's own value: |kernel - plain|
    <= 2^-7 |plain| + 1e-5, since only the float32 sum order differs before
    the one rounding. The kernel's time is the median of 5 replays of a
    CUDA graph of 20 calls (all kept): at the 40^2 planes a call takes about
    as long on the host as on the card. The library column is cuDNN's bf16
    depthwise conv alone (no affine, no ReLU, rounded elsewhere), a time
    yardstick only."""
    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import dw_affine_relu as k4

    def compare(x, w, sc, sh, what):
        got = k4.dw5x5_affine_relu_nchw(x, w, sc, sh)
        ref = k4.dw5x5_affine_relu_plain_nchw(x, w, sc, sh)
        torch.cuda.synchronize()
        g, r = got.float(), ref.float()
        excess = ((g - r).abs() - (2.0 ** -7 * r.abs() + 1e-5)).max().item()
        err = (g - r).abs().max().item()
        fail_if(not math.isfinite(err) or excess > 0,
                f"dw_affine_relu {what}: max_abs_err {err}, beyond one bf16 ulp by {excess}")
        return err, (g != r).float().mean().item()

    ragged = []
    bf, f32 = torch.bfloat16, torch.float32
    for B, C, H, W, dt in ((1, 1377, 37, 45, bf), (3, 144, 71, 130, bf), (2, 569, 19, 67, f32),
                           (2, 33, 70, 70, bf), (1, 9, 200, 131, bf), (3, 5, 1, 131, bf),
                           (2, 6, 77, 1, bf), (1, 3, 13, 7, bf), (1, 7, 1000, 45, bf),
                           (2, 5, 9, 45, f32), (1, 2, 1, 1, f32)):
        err, diff = compare(*dw_inputs(gen, dev, B, C, H, W, dt), f"ragged {(B, C, H, W)} {dt}")
        ragged.append(dict(dims=[B, C, H, W], dtype=str(dt), max_abs_err=err, differing_share=diff))
    B = 2 * PAIRS
    rows = []
    for label, h, C, calls in wide_refiner_shapes(cfg):
        x, w, sc, sh = dw_inputs(gen, dev, B, C, h, h, torch.bfloat16)
        err, diff = compare(x, w, sc, sh, label)
        wc = w.permute(2, 0, 1)[:, None].contiguous()
        n = B * C * h * h
        b_ms, b_by = bound(2 * n * 2 + 25 * C * 2 + 2 * C * 4, 53.0 * n)
        ms_rounds = graph_ms_rounds(lambda: k4.dw5x5_affine_relu_nchw(x, w, sc, sh), 20)
        rows.append(dict(shape=label, dims=[B, C, h, h], calls=calls, max_abs_err=err,
                         differing_share=diff, tol="2^-7 |plain| + 1e-5",
                         ms=median(ms_rounds), ms_rounds=ms_rounds,
                         plain_ms=cuda_ms(lambda: k4.dw5x5_affine_relu_plain_nchw(x, w, sc, sh), 3, 1),
                         library_ms=cuda_ms(lambda: F.conv2d(x, wc, padding=2, groups=C), 20),
                         bound_ms=b_ms, bound_by=b_by))
        del x
    rows[0]["ragged"] = ragged
    return rows


def check_dw_block_mm(dev, gen):
    """K5 at (4, 144, 280^2), (4, 144, 432^2), (4, 24, 560^2) and two ragged
    shapes (odd C padded to 48; C = 160, the largest it takes). Tolerance
    as K2's: 3e-2 x max(1, max|plain|), one bf16 ulp of the block output at
    its largest magnitude after float32 sums in another order (the kernel
    sums the 1x1 on the tensor cores). No path calls K5, so its kernels-line
    times sum one call at each of the three shapes. Beside it, "K4 + cuDNN
    1x1" is the same block as the refiner runs it, at the same shapes."""
    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import dw_affine_relu as k4
    from roma_torch.kernels import dw_block_mm as k5
    from roma_torch.kernels.dw_chain import block_plain_nchw

    def inputs(B, C, H, W):
        x, w, sc, sh = dw_inputs(gen, dev, B, C, H, W, torch.bfloat16)
        m = (0.2 * torch.randn((C, C), generator=gen, device=dev)).to(torch.bfloat16)
        bias = 0.1 * torch.randn((C,), generator=gen, device=dev)
        return x, w, sc, sh, m, bias

    def compare(args, what):
        got = k5.dw5x5_affine_relu_mm_nchw(*args)
        ref = block_plain_nchw(*args)
        torch.cuda.synchronize()
        tol = 3e-2 * max(1.0, ref.float().abs().max().item())
        err = (got.float() - ref.float()).abs().max().item()
        fail_if(not math.isfinite(err) or err > tol, f"dw_block_mm {what}: max_abs_err {err} > {tol}")
        return err, tol

    ragged = [compare(inputs(*d), f"ragged {d}")[0] for d in ((2, 37, 45, 61), (1, 160, 33, 70))]
    rows = []
    for label, B, C, h in DW_BLOCK_MM_SHAPES:
        args = inputs(B, C, h, h)
        x, w, sc, sh, m, bias = args
        err, tol = compare(args, label)
        m4, b4 = m.T[:, :, None, None].contiguous(), bias.to(torch.bfloat16)
        n_pix = B * h * h
        b_ms, b_by = bound(2 * n_pix * C * 2 + 25 * C * 2 + C * C * 2 + 3 * C * 4,
                           n_pix * (50.0 * C + 2.0 * C * C + 4 * C))
        rows.append(dict(shape=label, dims=[B, C, h, h], calls=1, max_abs_err=err, tol=tol,
                         ragged_max_abs_err=ragged,
                         ms=cuda_ms(lambda: k5.dw5x5_affine_relu_mm_nchw(*args), 20),
                         plain_ms=cuda_ms(lambda: block_plain_nchw(*args), 3, 1),
                         k4_cudnn_1x1_ms=cuda_ms(lambda: F.conv2d(
                             k4.dw5x5_affine_relu_nchw(x, w, sc, sh), m4, b4), 20),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_flash_attn(dev, gen, cfg):
    """K3 at the main-path shapes (views of a fused qkv, B' = 4 images),
    timed beside SDPA (median of 5 rounds); and, for correctness only, at
    ragged N against the 128-key tiles and the 192- or 128-row query tiles
    (1, 63, 65, 129, 193 and 1601 = DINOv2's tokens, whose last key tile
    holds 65 keys) at both head widths, as qkv views and as contiguous
    tensors, at B = 1 with 2 or 3 heads, and at 1601 with 11 heads
    (persistent blocks that take one tile or two). Tolerance elementwise,
    |kernel - plain| <= 2^-7 |plain| + 2e-3: both round their output to
    bf16 once (one or two ulps of the element apart), and the kernel's P is
    rounded to bf16 before P V. Every shape is checked before any failure
    is raised, so a failure lists each shape beyond the bound."""
    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import attention as at

    failures = []

    def compare(q, k, v, what):
        g, r = at.attention(q, k, v).float(), at.attention_plain(q, k, v).float()
        d = (g - r).abs()
        err, excess = d.max().item(), (d - (2.0 ** -7 * r.abs() + 2e-3)).max().item()
        if not math.isfinite(err) or excess > 0:
            failures.append(f"{what}: max_abs_err {err:.3e}, beyond the bound by {excess:.3e}")
        return err

    ragged = []
    for n, H in ((1, 2), (63, 2), (65, 2), (129, 2), (193, 3), (1601, 2), (1601, 11)):
        for d in at.HEAD_DIMS:
            for layout in ("qkv", "contiguous"):
                qkv = torch.randn((1, n, 3, H, d), generator=gen, device=dev).to(torch.bfloat16)
                q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
                if layout == "contiguous":
                    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                err = compare(q, k, v, f"ragged N={n} H={H} d={d} {layout}")
                ragged.append(dict(dims=[1, n, H, d], layout=layout, max_abs_err=err))
    B = 2 * PAIRS
    n16 = (cfg.coarse_resolution[0] // 14) * (cfg.coarse_resolution[1] // 14)
    shapes = [("dinov2", n16 + 1, cfg.dinov2_heads, cfg.dinov2_dim // cfg.dinov2_heads,
               cfg.dinov2_depth),
              ("decoder", n16, cfg.decoder_heads, cfg.decoder_dim // cfg.decoder_heads,
               cfg.num_decoder_blocks)]
    # views of a fused qkv projection, as Attention passes them
    inputs = []
    for label, n, H, d, calls in shapes:
        qkv = torch.randn((B, n, 3, H, d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        inputs.append((label, n, H, d, calls, q, k, v, compare(q, k, v, label)))
    fail_if(bool(failures), "flash_attn: " + "; ".join(failures))
    rows = []
    for label, n, H, d, calls, q, k, v, err in inputs:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * B * H * n * n * d
        nbytes = 4 * B * n * H * d * 2
        b_ms, b_by = bound(nbytes, flops, float(B * H * n * n))
        ms_rounds = cuda_ms_rounds(lambda: at.attention(q, k, v), 20)
        lib_rounds = cuda_ms_rounds(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        rows.append(dict(shape=label, dims=[B, n, H, d], calls=calls, ragged=ragged,
                         main_path_max_abs_err=err,
                         max_abs_err=max([err] + [r["max_abs_err"] for r in ragged]),
                         tol="2^-7 |plain| + 2e-3", ms=median(ms_rounds), ms_rounds=ms_rounds,
                         plain_ms=cuda_ms(lambda: at.attention_plain(q, k, v), 5, 1),
                         library_ms=median(lib_rounds), library_ms_rounds=lib_rounds,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def check_corr_softmax(dev, gen):
    """Tiny RoMa's coarse warp through both entries of K7 on the same
    bf16-valued features: bf16 (Tiny RoMa's, scored on the tensor cores)
    and float32 (the JAX function's type; the parent's kernel, unchanged);
    the float32 entry also on float32 randn features (which bf16 cannot
    hold) at 8 x 480x640 and the ragged 2 x 1000 x 700 x 64.
    8 pairs at 480x640 (L = 60 x 80) and one pair at 1056x1920 (L = 132 x
    240), C = 64, the real coord_grid; for correctness only, ragged L0 and
    L1 against the 128-row blocks and 64-column chunks at C = 16, 32 and 64.
    Tolerance 1e-4 absolute on normalized coordinates (fp32 sums in another
    order; the plain volume at the megapixel shape is ~4 GB). Library
    yardsticks: SDPA with the grid zero-padded to 64 value columns, in bf16
    on the flash backend (library_ms) and in float32. The bound counts the
    exponentials, one a score."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from roma_torch.kernels import corr_softmax as cs
    from roma_torch.ops.corr import coord_grid

    def feats(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def errs(f0, f1, grid, what, full=False):
        """Both entries on the bf16-valued f0, f1; with `full`, the fp32
        entry also on float32 features that bf16 cannot hold (randn)."""
        ref = cs.fused_pos_embed_plain(f0, f1, grid)
        cases = [("bf16", f0, f1, ref), ("fp32", f0.float(), f1.float(), ref)]
        if full:
            t0 = torch.randn(f0.shape, generator=gen, device=dev)
            t1 = torch.randn(f1.shape, generator=gen, device=dev)
            cases.append(("fp32 randn", t0, t1, cs.fused_pos_embed_plain(t0, t1, grid)))
        out = {}
        for name, a, b, want in cases:
            got = cs.fused_pos_embed(a, b, grid)
            torch.cuda.synchronize()
            out[name] = (got - want).abs().max().item()
            fail_if(not math.isfinite(out[name]) or out[name] > 1e-4,
                    f"corr_softmax {what} {name}: max_abs_err {out[name]}")
        return out

    ragged = []
    for B, L0, L1, C in ((2, 1000, 700, 64), (1, 129, 65, 32), (2, 60, 48, 16), (3, 17, 130, 16),
                         (1, 300, 1, 64), (2, 127, 191, 32)):
        grid = torch.rand((L1, 2), generator=gen, device=dev) * 2 - 1
        ragged.append(dict(dims=[B, L0, L1, C], **errs(feats(B, L0, C), feats(B, L1, C), grid,
                                                       f"ragged {(B, L0, L1, C)}",
                                                       full=(B, L0, L1) == (2, 1000, 700))))
    rows = []
    for label, B, (H, W), calls in (("tiny_bench 8 pairs", TINY_PAIRS, TINY_HW, 1),
                                    ("megapixel 1 pair", 1, MEGAPIXEL_HW, 0)):
        h, w = H // 8, W // 8
        L, C = h * w, 64
        f0, f1 = feats(B, L, C), feats(B, L, C)
        g0, g1 = f0.float(), f1.float()
        grid = coord_grid(h, w, device=dev).reshape(L, 2)
        err = errs(f0, f1, grid, label, full=B == TINY_PAIRS)
        got = cs.fused_pos_embed(f0, f1, grid)
        v = F.pad(grid, (0, C - 2))[None, None].expand(B, 1, L, C).contiguous()
        vb = v.to(torch.bfloat16)
        q, k, qb, kb = g0[:, None], g1[:, None], f0[:, None], f1[:, None]
        lib = F.scaled_dot_product_attention(q, k, v)[:, 0, :, :2]
        torch.cuda.synchronize()
        nbytes = 2.0 * 2 * B * L * C + 4.0 * (2 * L + 2 * B * L)
        b_ms, b_by = bound(nbytes, 2.0 * B * L * L * C, float(B * L * L))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb), 5)
        rows.append(dict(shape=label, dims=[B, L, L, C], calls=calls,
                         max_abs_err=max(max(err.values()), *(max(x for k, x in r.items()
                                                                   if k != "dims")
                                                               for r in ragged)),
                         tol=1e-4, err=err, ragged=ragged,
                         sdpa_max_abs_diff=(lib - got).abs().max().item(),
                         ms=cuda_ms(lambda: cs.fused_pos_embed(f0, f1, grid), 5),
                         fp32_ms=cuda_ms(lambda: cs.fused_pos_embed(g0, g1, grid), 5),
                         plain_ms=cuda_ms(lambda: cs.fused_pos_embed_plain(f0, f1, grid), 2, 1),
                         library_ms=lib_ms,
                         library_fp32_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5),
                         bound_ms=b_ms, bound_by=b_by))
        del f0, f1, g0, g1, q, k, v, vb, qb, kb, lib, got
        torch.cuda.empty_cache()
    return rows


def smooth_sine_grid(B: int, H: int, W: int, dev):
    """Identity + slow sinusoidal displacement, targets clipped in-bounds:
    every (8, 128) tile is window-smooth."""
    import torch

    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    dx = 2.5 * torch.sin(ys / 17.0) + 1.7 * torch.cos(xs / 29.0)
    dy = 1.5 * torch.cos(ys / 23.0) - 2.0 * torch.sin(xs / 31.0)
    tx = torch.clamp(xs + dx, 1.0, W - 2.0)
    ty = torch.clamp(ys + dy, 1.0, H - 2.0)
    g = torch.stack([2 * (tx + 0.5) / W - 1, 2 * (ty + 0.5) / H - 1], dim=-1)
    return g[None].expand(B, H, W, 2).contiguous()


def check_windowed_sample(dev, gen, cfg):
    """The scale-1 warp of both passes: feat (4, 9, h, h) bf16, channels
    last (the refiner's layout, which the kernel reads) and contiguous
    (which the public entry converts), grid (4, h, h, 2) at h = 560 and
    864, on a smooth and a random flow. The
    kernel's origins (its debug buffer) must equal plan()'s bit for bit and
    its `ok` must equal `smoothness_ok` (True on the smooth flow, False on
    the random one), in both modes; "fast" must equal the plain version;
    "exact" must launch once, raise nothing under
    torch.cuda.set_sync_debug_mode("error") (no host read of `ok`), and
    equal grid_sample on both flows. Then one float32 map at h = 560, both
    modes, and a 32-channel map with `with_ok` (plain grid_sample, the
    kernel launched once for `ok` alone). Tolerance: one bf16 ulp at the
    output's largest magnitude,
    2^-7 x max(1, max|ref|). The kernel and the plain version do the same
    float32 arithmetic in the same order and round once (so they should
    agree exactly); F.grid_sample's float32 sums in another order can move
    that rounding by one ulp. Times (CUDA events, per call): the whole call
    ("fast" on the random flow and the channels-last map is the kernels-line
    time, as random weights give the main path rough flows) in both modes on
    both flows and both layouts; the plain version with its plan;
    F.grid_sample on the float32 map. (The first version's plain-torch plan
    and padding, which ran before each launch, are timed by
    `kernel_variants.py k6`.)"""
    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import LAUNCHES
    from roma_torch.kernels import windowed_sample as kws
    from roma_torch.ops import windowed_sample as ows
    from roma_torch.ops.grid_sample import grid_sample_nchw

    B, C = 2 * PAIRS, cfg.proj_dims["1"][1]
    rows = []

    def err_of(got, ref, what):
        tol = 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
        err = (got.float() - ref.float()).abs().max().item()
        fail_if(not math.isfinite(err) or err > tol, f"windowed_sample {what}: max_abs_err {err} > {tol}")
        return err, tol

    def run_checks(feat, grid, name, what):
        """Both modes once through the kernel's wrapper on the channels-last
        map (origins and `ok` checked) and once through the public entry on
        `feat` as it is; errors and tolerances."""
        h = grid.shape[1]
        gp = ows.pad_grid(grid)
        p = ows.plan(feat, gp, (h, h))
        ok_ref = bool(ows.smoothness_ok(feat, gp, (h, h)))
        fail_if(ok_ref != (name == "smooth"), f"windowed_sample {what}: smoothness_ok {ok_ref}")
        res = {}
        for mode in ("fast", "exact"):
            ok = torch.ones((), dtype=torch.int32, device=dev)
            origins = torch.full(kws.origins_shape(grid), -1, dtype=torch.int32, device=dev)
            got = kws.windowed_sample_cuda(feat.contiguous(memory_format=torch.channels_last),
                                           grid, mode == "exact", ok, origins)
            torch.cuda.synchronize()
            fail_if(not (torch.equal(origins[..., 0], p.ybase)
                         and torch.equal(origins[..., 1], p.j0_abs)),
                    f"windowed_sample {what} {mode}: the kernel's origins differ from plan()'s")
            fail_if(bool(ok) != ok_ref, f"windowed_sample {what} {mode}: ok {bool(ok)} != {ok_ref}")
            n0 = LAUNCHES["windowed_sample"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                out, ok2 = kws.grid_sample_smooth_nchw(feat, grid, mode, with_ok=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            launched = LAUNCHES["windowed_sample"] - n0
            fail_if(launched != 1 or bool(ok2) != ok_ref or not torch.equal(out, got),
                    f"windowed_sample {what} {mode}: {launched} launches, ok {bool(ok2)}")
            ref = (ows.windowed_sample_plain(feat, gp, (h, h), p) if mode == "fast"
                   else grid_sample_nchw(feat, grid))
            res[mode] = err_of(got, ref, f"{what} {mode} vs {'plain' if mode == 'fast' else 'grid_sample'}")
        return res

    for label, h in (("coarse s1", cfg.coarse_resolution[0]),
                     ("upsample s1", cfg.upsample_resolution[0])):
        feat = torch.randn((B, C, h, h), generator=gen, device=dev).to(torch.bfloat16)
        # the refiner's maps are channels last (its 1x1 projection's layout)
        layouts = {"channels_last": feat.contiguous(memory_format=torch.channels_last),
                   "contiguous": feat}
        flows = {"smooth": smooth_sine_grid(B, h, h, dev),
                 "random": (torch.rand((B, h, h, 2), generator=gen, device=dev) * 2 - 1).contiguous()}
        checks = {(lay, name): run_checks(f, g, name, f"{label} {lay} {name}")
                  for lay, f in layouts.items() for name, g in flows.items()}
        whole = {lay: {f"{mode}_{name}": cuda_ms(lambda: kws.grid_sample_smooth_nchw(f, g, mode), 20)
                       for name, g in flows.items() for mode in ("fast", "exact")}
                 for lay, f in layouts.items()}
        rough, feat_cl = flows["random"], layouts["channels_last"]
        n_pix = B * h * h
        nbytes = B * C * h * h * 2 + n_pix * 2 * 4 + n_pix * C * 2
        b_ms, b_by = bound(nbytes, n_pix * C * 8.0)
        row = dict(shape=label, dims=[B, C, h, h], calls=1,
                   max_abs_err=max(e for c in checks.values() for e, _ in c.values()),
                   tol=min(t for c in checks.values() for _, t in c.values()),
                   errors={f"{lay} {n}": {m: e for m, (e, _) in c.items()}
                           for (lay, n), c in checks.items()},
                   ms=whole["channels_last"]["fast_random"], whole_ms=whole,
                   plain_ms=cuda_ms(lambda: ows.windowed_sample_plain(
                       feat_cl, ows.pad_grid(rough), (h, h)), 5),
                   library_ms=cuda_ms(lambda: F.grid_sample(feat_cl.float(), rough,
                                                            align_corners=False), 20),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        del feat, flows, layouts, feat_cl
    # a float32 map at the coarse shape, both flows, both modes
    h = cfg.coarse_resolution[0]
    feat32 = torch.randn((B, C, h, h), generator=gen, device=dev)
    rows[0]["float32"] = {}
    for name, g in (("smooth", smooth_sine_grid(B, h, h, dev)),
                    ("random", (torch.rand((B, h, h, 2), generator=gen, device=dev) * 2 - 1))):
        for lay, f in (("channels_last", feat32.contiguous(memory_format=torch.channels_last)),
                       ("contiguous", feat32)):
            res = run_checks(f, g.contiguous(), name, f"coarse s1 float32 {lay} {name}")
            rows[0]["float32"][f"{lay} {name}"] = dict(
                errors={m: e for m, (e, _) in res.items()},
                fast_ms=cuda_ms(lambda: kws.grid_sample_smooth_nchw(f, g, "fast"), 20))
    # a map of more than 16 channels takes grid_sample; `with_ok` asks the
    # kernel for `ok` alone (one launch, nothing staged)
    wide = torch.randn((B, 32, h, h), generator=gen, device=dev).to(torch.bfloat16)
    rows[0]["wide_ok"] = {}
    for name, g in (("smooth", smooth_sine_grid(B, h, h, dev)),
                    ("random", (torch.rand((B, h, h, 2), generator=gen, device=dev) * 2 - 1))):
        g = g.contiguous()
        n0 = LAUNCHES["windowed_sample"]
        out, ok = kws.grid_sample_smooth_nchw(wide, g, "fast", with_ok=True)
        torch.cuda.synchronize()
        launched = LAUNCHES["windowed_sample"] - n0
        ok_ref = bool(ows.smoothness_ok(wide, ows.pad_grid(g), (h, h)))
        fail_if(launched != 1 or bool(ok) != ok_ref or not torch.equal(out, grid_sample_nchw(wide, g)),
                f"windowed_sample C = {wide.shape[1]} {name}: {launched} launches, ok {bool(ok)} "
                f"(smoothness_ok {ok_ref}), or not grid_sample's output")
        rows[0]["wide_ok"][name] = bool(ok)
    return rows


def summarize(name: str, rows: list[dict], launches: int) -> dict:
    """One kernels-line entry: times summed over one match()'s calls."""
    per_match = lambda key: sum(r["calls"] * r[key] for r in rows)
    lib = None if any(r["library_ms"] is None for r in rows) else per_match("library_ms")
    b_rows = {r["bound_by"] for r in rows}
    return {
        "name": name, "route": "cuda", "source": KERNELS[name][1],
        "replaces": KERNELS[name][0], "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_match("ms"), "plain_ms": per_match("plain_ms"),
        "bound_ms": per_match("bound_ms"),
        "bound_by": b_rows.pop() if len(b_rows) == 1 else "bytes",
        "library_ms": lib,
    }


# ---------------------------------------------------------------- float32 entries (C3)

# |kernel - plain| <= F32_TOL * max(1, max|plain|), float32 sums in another order
# (measured: at most 1.5e-6 of max|plain|, K1; 1e-4 was the first proposal)
F32_TOL = 1e-5


def _f32_err(got, ref, what, failures) -> float:
    """Max |got - ref| of a float32 entry; records a failure beyond
    F32_TOL * max(1, max|ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    lim = F32_TOL * max(1.0, ref.abs().max().item())
    if not math.isfinite(err) or err > lim:
        failures.append(f"{what}: max_abs_err {err:.3e} > {lim:.3e}")
    return err


def check_float32_entries(dev, gen, cfg, captured, model) -> dict:
    """The float32 entries of K1, K2, K3 and K5 against their plain versions
    at the main-path shapes, timed: K1 on the main path's captured inputs
    widened to float32 (its tile plan must put every tile on the per-pixel
    path: the float32 entry has no shared-window path), K2's
    9-block chain with the scale-1 refiner's weights folded in float32 at
    both passes' sizes, K3 at DINOv2's and the decoder's shapes (views of a
    fused qkv, B' = 4) with its log-sum-exp, K5 at its shapes. Tolerance
    F32_TOL * max(1, max|plain|)."""
    import torch

    from roma_torch.kernels import attention as at
    from roma_torch.kernels import dw_block_mm as k5
    from roma_torch.kernels import dw_chain as k2
    from roma_torch.kernels import local_corr as k1

    failures, out = [], {"local_corr": [], "dw_chain": [], "flash_attn": [], "dw_block_mm": []}
    for f0, f1, r, flow in captured:
        a, b = f0.float().contiguous(), f1.float().contiguous()
        got = k1.local_correlation_cuda(a, b, r, flow)
        dims = list(a.shape)
        err = _f32_err(got, k1.local_correlation_plain(a, b, r, flow), f"local_corr f32 {dims}",
                       failures)
        if bool(k1.tile_plan(flow, r, torch.float32).shared.any()):
            failures.append(f"local_corr f32 {dims}: the tile plan left the per-pixel path")
        out["local_corr"].append(dict(dims=dims, radius=r, max_abs_err=err, ms=cuda_ms(
            lambda: k1.local_correlation_cuda(a, b, r, flow), 10)))

    cols = [blk.fused(torch.float32) for blk in model.decoder.conv_refiner["1"].blocks()]
    params = [torch.stack([c[i] for c in cols]).float().contiguous() for i in range(5)]
    C = params[0].shape[-1]
    for side in (cfg.coarse_resolution[0], cfg.upsample_resolution[0]):
        x = torch.randn((2 * PAIRS, C, side, side), generator=gen, device=dev)
        err = _f32_err(k2.chain_cuda_nchw(x, *params), k2.chain_plain_nchw(x, *params),
                       f"dw_chain f32 {side}", failures)
        out["dw_chain"].append(dict(dims=list(x.shape), blocks=params[0].shape[0],
                                    max_abs_err=err,
                                    ms=cuda_ms(lambda: k2.chain_cuda_nchw(x, *params), 5)))

    n16 = (cfg.coarse_resolution[0] // 14) * (cfg.coarse_resolution[1] // 14)
    for label, n, H, d in (("dinov2", n16 + 1, cfg.dinov2_heads, cfg.dinov2_dim // cfg.dinov2_heads),
                           ("decoder", n16, cfg.decoder_heads,
                            cfg.decoder_dim // cfg.decoder_heads)):
        qkv = torch.randn((2 * PAIRS, n, 3, H, d), generator=gen, device=dev)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o, lse = at.attention_cuda(q, k, v, with_lse=True)
        err = _f32_err(o, at.attention_plain(q, k, v), f"flash_attn f32 {label}", failures)
        lse_err = _f32_err(lse, at.attention_lse_plain(q, k), f"flash_attn f32 {label} lse",
                           failures)
        out["flash_attn"].append(dict(shape=label, dims=[2 * PAIRS, n, H, d], max_abs_err=err,
                                      lse_max_abs_err=lse_err,
                                      ms=cuda_ms(lambda: at.attention_cuda(q, k, v), 10)))

    for label, B, Cm, side in DW_BLOCK_MM_SHAPES:
        x = torch.randn((B, Cm, side, side), generator=gen, device=dev)
        w = 0.2 * torch.randn((5, 5, Cm), generator=gen, device=dev)
        sc = 0.5 + torch.rand((Cm,), generator=gen, device=dev)
        sh = 0.1 * torch.randn((Cm,), generator=gen, device=dev)
        m = torch.randn((Cm, Cm), generator=gen, device=dev) / math.sqrt(Cm)
        bias = 0.1 * torch.randn((Cm,), generator=gen, device=dev)
        args = (x, w, sc, sh, m, bias)
        err = _f32_err(k5.dw5x5_affine_relu_mm_cuda_nchw(*args), k2.block_plain_nchw(*args),
                       f"dw_block_mm f32 {label}", failures)
        out["dw_block_mm"].append(dict(shape=label, dims=[B, Cm, side, side], max_abs_err=err,
                                       ms=cuda_ms(lambda: k5.dw5x5_affine_relu_mm_cuda_nchw(*args),
                                                  10)))
    fail_if(bool(failures), "float32 entries: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------- K8 / K9

def bwd_lib_call(lib, q, k, v, dout, lse, di, dtype_code, which=("dkv", "dq"), outs=None):
    """(dq, dk, dv) from a library with flash_attn_bwd.cu's C entries,
    launching the kernels in `which` only, into `outs` (dq, dk, dv) or into
    outputs zero-filled first (the planted-fault copy leaves rows unset).
    No launch counter moves: this is the comparison's and the timing's
    call (also kernel_variants.py's)."""
    import ctypes

    import torch

    B, N, H, d = q.shape
    if outs is None:
        outs = tuple(torch.zeros((B, N, H, d), dtype=q.dtype, device=q.device) for _ in range(3))
    dq, dk, dv = outs
    st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                  *dout.stride()[:3])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, di)]
    tail = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                                 ctypes.c_int, ctypes.c_void_p]
    for kind, sym, res in (("dkv", "roma_flash_attn_bwd_dkv", (dk, dv)),
                           ("dq", "roma_flash_attn_bwd_dq", (dq,))):
        if kind not in which:
            continue
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * (6 + len(res)) + tail
        fn.restype = ctypes.c_int
        rc = fn(*ptrs, *(t.data_ptr() for t in res), B, N, H, d, st, 1.0 / math.sqrt(d),
                dtype_code, stream)
        fail_if(rc != 0, f"{sym} returned {rc}")
    return dq, dk, dv


# where the planted fault goes in flash_attn_bwd.cu, each anchor once: the
# bf16 (wgmma) K8 walks one query tile fewer and K9 launches one query tile's
# block fewer; so do the float32 kernels
PLANTED = (
    ("const int m_tiles = (N + kQueryTile - 1) / kQueryTile;",
     "const int m_tiles = (N + kQueryTile - 1) / kQueryTile - 1;"),
    ("const dim3 grid((a.N + kBlockRows - 1) / kBlockRows, a.H, B);",
     "const dim3 grid((a.N + kBlockRows - 1) / kBlockRows - (dkv ? 0 : 1), a.H, B);"),
    ("for (int m0 = 0; m0 < N; m0 += kRows) {",
     "for (int m0 = 0; m0 < ((N - 1) / kRows) * kRows; m0 += kRows) {"),
    ("const dim3 grid((a.N + kRows - 1) / kRows, a.H, B);",
     "const dim3 grid((a.N + kRows - 1) / kRows - (dkv ? 0 : 1), a.H, B);"),
)


def planted_source(src: str) -> str:
    """flash_attn_bwd.cu with the planted fault: K8 drops its last query
    tile, K9 the last query tile (in the bf16 and the float32 kernels)."""
    for anchor, fault in PLANTED:
        fail_if(src.count(anchor) != 1, f"planted fault: {anchor!r} is not in the source once")
        src = src.replace(anchor, fault)
    return src


def start_planted_build(tmp: Path):
    """Build `planted_source` of flash_attn_bwd.cu, started beside the main
    build."""
    import shutil

    from roma_torch.kernels import runtime

    for h in runtime.CSRC.glob("*.cuh"):
        shutil.copy(h, tmp / h.name)
    (tmp / "planted.cu").write_text(planted_source((runtime.CSRC / "flash_attn_bwd.cu").read_text()))
    lib = tmp / "libplanted.so"
    cmd = [runtime.nvcc(), *runtime.NVCC_FLAGS, "-o", str(lib), str(tmp / "planted.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def bwd_grid(lib, B: int, N: int, H: int, d: int, dtype_code: int) -> dict:
    """The launch that K8 and K9 of `lib` (a build of flash_attn_bwd.cu)
    make for (B, N, H, d): blocks, blocks an SM holds at once, SMs and waves
    (`roma_flash_attn_bwd_grid`)."""
    import ctypes

    fn = lib.roma_flash_attn_bwd_grid
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for name, dkv in (("flash_attn_dkv", 1), ("flash_attn_dq", 0)):
        g = (ctypes.c_int * 3)()
        fail_if(fn(B, N, H, d, dtype_code, dkv, g) != 0, "roma_flash_attn_bwd_grid failed")
        out[name] = dict(blocks=g[0], blocks_per_sm=g[1], sms=g[2], waves=g[0] / (g[1] * g[2]))
    return out


# |kernel - plain| <= rel * |plain| + absn * M, M the largest plain gradient of the
# call; tightened from the proposed 1e-2 M (bf16) and 1e-4 M (float32) toward
# what was measured: bf16 (P and dS rounded to bf16 before their products) at
# most 0.57 of 2^-7 |plain| + 4e-3 M, float32 0.053 of 1e-5 M
BWD_TOL = {"bfloat16": (2.0 ** -7, 8e-3), "float32": (0.0, 2e-6)}


def check_attention_bwd(dev, gen, cfg, planted) -> dict:
    """K8 and K9 against `attention_bwd_plain` (and the forward's lse
    against logsumexp of the plain logits), in bf16 and float32: at the
    decoder's training shape (2, 1600, 8, 128) and at DINOv2's (4, 1601,
    16, 64) as views of a fused qkv, and at ragged N (1, 63, 65, 129, 1601;
    both head widths, views and contiguous). Tolerance per element
    `BWD_TOL`: bf16 2^-7 |plain| + 8e-3 M (the inputs, o and dO are bf16,
    P and dS are rounded to bf16 before their products, the gradients once
    at the end), float32 2e-6 M. Then the
    planted-fault build must exceed the bound >= 10x, and at the decoder's
    training shape in bf16 the kernels (each alone, through its C entry),
    the whole `attention_bwd_cuda` call (di + K8 + K9), the plain version
    and SDPA's whole backward (its device time by the profiler, and by CUDA
    events) are timed, with K3's forward with and without
    its lse, and the launch's blocks per SM and waves are read."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import attention as at
    from roma_torch.kernels import runtime

    failures, cases = [], []

    def run(q, k, v, dout, what):
        o, lse = at.attention_cuda(q, k, v, with_lse=True)
        got = at.attention_bwd_cuda(q, k, v, o, lse, dout)
        ref = at.attention_bwd_plain(q, k, v, o, lse, dout)
        rel, absn = BWD_TOL[str(q.dtype).split(".")[1]]
        M = max(r.abs().max().item() for r in ref)
        row = dict(case=what, dims=list(q.shape), dtype=str(q.dtype))
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            d = (g.float() - r).abs()
            worst = (d / (rel * r.abs() + absn * M)).max().item()
            row[name] = dict(max_abs_err=d.max().item(), worst_over_tol=worst)
            if not math.isfinite(worst) or worst > 1:
                failures.append(f"{what} {name}: max_abs_err {d.max().item():.3e}, "
                                f"{worst:.2f}x the bound")
        lse_ref = at.attention_lse_plain(q, k)
        row["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
        if row["lse_max_abs_err"] > 1e-4 * max(1.0, lse_ref.abs().max().item()):
            failures.append(f"{what} lse: max_abs_err {row['lse_max_abs_err']:.3e}")
        cases.append(row)
        return o, lse, ref, M

    def qkv_views(B, n, H, d, dtype, contiguous=False):
        qkv = torch.randn((B, n, 3, H, d), generator=gen, device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if contiguous:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return q, k, v, torch.randn((B, n, H, d), generator=gen, device=dev).to(dtype)

    n16 = (cfg.coarse_resolution[0] // 14) * (cfg.coarse_resolution[1] // 14)
    dec = (TRAIN_BATCH, n16, cfg.decoder_heads, cfg.decoder_dim // cfg.decoder_heads)
    dino = (2 * PAIRS, n16 + 1, cfg.dinov2_heads, cfg.dinov2_dim // cfg.dinov2_heads)
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        main[dtype] = qkv_views(*dec, dtype)
        run(*main[dtype], f"decoder {dec} {dtype}")
        run(*qkv_views(*dino, dtype), f"dinov2 {dino} {dtype}")
        for n in (1, 63, 65, 129, 1601):
            for d in at.HEAD_DIMS:
                run(*qkv_views(1, n, 2, d, dtype), f"ragged N={n} d={d} {dtype}")
        run(*qkv_views(1, 193, 3, 128, dtype, contiguous=True), f"contiguous N=193 {dtype}")
    fail_if(bool(failures), "flash_attn backward: " + "; ".join(failures))

    # the planted fault: dK/dV lose the last query tile, dQ the last tile's rows
    proc, lib_path = planted
    text, _ = proc.communicate()
    fail_if(proc.returncode != 0, f"planted-fault build failed:\n{text}")
    lib = ctypes.CDLL(str(lib_path))
    planted_rows = {}
    for dtype, code in ((torch.bfloat16, 0), (torch.float32, 1)):
        q, k, v, dout = main[dtype]
        o, lse = at.attention_cuda(q, k, v, with_lse=True)
        ref = at.attention_bwd_plain(q, k, v, o, lse, dout)
        got = bwd_lib_call(lib, q, k, v, dout.contiguous(), lse, at.attention_di(o, dout), code)
        rel, absn = BWD_TOL[str(dtype).split(".")[1]]
        M = max(r.abs().max().item() for r in ref)
        ratios = {name: ((g.float() - r).abs() / (rel * r.abs() + absn * M)).max().item()
                  for name, g, r in zip(("dq", "dk", "dv"), got, ref)}
        planted_rows[str(dtype)] = ratios
        fail_if(min(ratios.values()) < 10,
                f"planted fault ({dtype}) exceeds the bound only {ratios}x, not >= 10x")

    # timing at the decoder's training shape, bf16
    q, k, v, dout = main[torch.bfloat16]
    o, lse = at.attention_cuda(q, k, v, with_lse=True)
    B, N, H, d = q.shape
    # each kernel alone, through its C entry (no di, no allocation, no host
    # work between launches beyond the ctypes call)
    lib_main, di = runtime.load(at.BWD_NAME), at.attention_di(o, dout)
    outs = tuple(torch.empty_like(q) for _ in range(3))
    dkv_ms = cuda_ms_rounds(
        lambda: bwd_lib_call(lib_main, q, k, v, dout, lse, di, 0, ("dkv",), outs), 20)
    dq_ms = cuda_ms_rounds(
        lambda: bwd_lib_call(lib_main, q, k, v, dout, lse, di, 0, ("dq",), outs), 20)
    whole_ms = cuda_ms_rounds(lambda: at.attention_bwd_cuda(q, k, v, o, lse, dout), 20)
    # the same on the device alone (CUDA-graph replay: no host time between
    # launches), and the plain di's share of it
    whole_graph_ms = graph_ms_rounds(lambda: at.attention_bwd_cuda(q, k, v, o, lse, dout), 20)
    di_graph_ms = graph_ms_rounds(lambda: at.attention_di(o, dout), 20)
    grid = bwd_grid(lib_main, B, N, H, d, 0)
    plain_ms = cuda_ms(lambda: at.attention_bwd_plain(q, k, v, o, lse, dout), 3, 1)
    leaves = [t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    dout_t = dout.transpose(1, 2)
    sdpa_call = lambda: torch.autograd.grad(sdpa_out, leaves, dout_t, retain_graph=True)
    # SDPA's autograd call can take longer on the host than on the device
    # (on an H100 80GB HBM3, CUDA events read 0.16-0.31 ms where its device time was ~0.145):
    # its device time is the yardstick, its events reading is kept beside it
    sdpa_events_ms = cuda_ms_rounds(sdpa_call, 20)
    sdpa_ms = sorted(profiled_device_ms(sdpa_call) for _ in range(3))
    fwd_ms = cuda_ms_rounds(lambda: at.attention_cuda(q, k, v), 20)
    fwd_lse_ms = cuda_ms_rounds(lambda: at.attention_cuda(q, k, v, with_lse=True), 20)
    gemm = 2.0 * B * H * N * N * d
    exps = float(B * H * N * N)
    elem = B * N * H * d * 2
    side = 2 * B * H * N * 4  # lse and di
    worst = lambda name: max(c[name]["max_abs_err"] for c in cases if "bfloat16" in c["dtype"])
    rows = {}
    for name, n_gemm, outs, ms, errs in (("flash_attn_dkv", 4, 2, dkv_ms, ("dk", "dv")),
                                         ("flash_attn_dq", 3, 1, dq_ms, ("dq",))):
        b_ms, b_by = bound((4 + outs) * elem + side, n_gemm * gemm, exps)
        rows[name] = [dict(shape="decoder train", dims=[B, N, H, d], calls=cfg.num_decoder_blocks,
                           max_abs_err=max(worst(e) for e in errs),
                           tol="2^-7 |plain| + 8e-3 max|plain|",
                           ms=median(ms), ms_rounds=ms, plain_ms=plain_ms,
                           library_ms=median(sdpa_ms), library_ms_rounds=sdpa_ms,
                           library_events_ms_rounds=sdpa_events_ms,
                           bound_ms=b_ms, bound_by=b_by, grid=grid[name])]
    return dict(rows=rows, cases=cases, planted=planted_rows, whole_ms=median(whole_ms),
                whole_ms_rounds=whole_ms, whole_graph_ms=median(whole_graph_ms),
                di_graph_ms=median(di_graph_ms), sdpa_ms=median(sdpa_ms),
                sdpa_events_ms=median(sdpa_events_ms), grid=grid,
                fwd_ms=median(fwd_ms), fwd_lse_ms=median(fwd_lse_ms), fwd_ms_rounds=fwd_ms,
                fwd_lse_ms_rounds=fwd_lse_ms)


# ---------------------------------------------------------------- training

def synthetic_depth_batch(gen, dev, B: int, hw: tuple[int, int]) -> dict:
    """One batch of the dataset contract from a seeded generator, made on
    the device: uniform images, depth 2 +- 0.3 with the top eighth missing,
    a 0.05 rad yaw and 5 cm baseline, focal 1.4 x the width."""
    import torch

    h, w = hw
    f = 1.4 * w
    K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], device=dev).expand(B, 3, 3)
    a = 0.05
    T = torch.eye(4, device=dev)
    T[0, 0], T[0, 2], T[2, 0], T[2, 2] = math.cos(a), math.sin(a), -math.sin(a), math.cos(a)
    T[0, 3] = 0.05

    def depth():
        d = 2.0 + 0.3 * (2 * torch.rand((B, h, w), generator=gen, device=dev) - 1)
        d[:, : h // 8] = 0.0
        return d

    return {"im_A": torch.rand((B, h, w, 3), generator=gen, device=dev),
            "im_B": torch.rand((B, h, w, 3), generator=gen, device=dev),
            "im_A_depth": depth(), "im_B_depth": depth(), "T_1to2": T.expand(B, 4, 4),
            "K1": K, "K2": K}


def run_training(dev, gen, card: str, profile_dir: Path | None = None) -> dict:
    """Path T: full-width roma_outdoor() (ViT-L 24 blocks, 5 decoder blocks,
    refiners with 8 hidden blocks, bf16) trained at 560^2, batch 2, on
    synthetic depth batches: one warm-up step, then 3 timed steps, the
    launch counters reset just before the first and read just after it
    (K3 29 = 24 DINOv2 without grad + 5 decoder with lse, K8 5, K9 5; K1,
    K2, K4, K6 0). Finite loss and metrics (gm_cls_loss_16 among them),
    DINOv2 bit-unchanged, every running statistic moved; samples/s and
    peak memory; with `profile_dir`, one more step under torch.profiler."""
    import torch

    from roma_torch.config import RomaConfig, TrainConfig
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.models.zoo import build_model
    from roma_torch.train.train import make_roma_train_state, make_train_step

    cfg = RomaConfig()
    state = make_roma_train_state(TrainConfig(batch_size=TRAIN_BATCH), model=build_model(cfg, SEED),
                                  device=dev)
    model = state.model
    step = make_train_step()
    dino0 = {k: t.clone() for k, t in model.encoder.dinov2.state_dict().items()}
    stats0 = {k: t.clone() for k, t in model.state_dict().items()
              if k.endswith(("running_mean", "running_var")) and "dinov2" not in k}
    batches = [synthetic_depth_batch(gen, dev, TRAIN_BATCH, cfg.coarse_resolution)
               for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    state, metrics = step(state, batches[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, all_metrics = [], []
    for i, batch in enumerate(batches[1:]):
        if i == 0:
            reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(LAUNCHES)
        all_metrics.append({k: float(v) for k, v in metrics.items()})
    res = dict(first_step_s=first_s, step_s=times, samples_per_s=TRAIN_BATCH * len(times) / sum(times),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
               metrics=all_metrics, samples=state.step)
    expected = {"flash_attn": cfg.dinov2_depth + cfg.num_decoder_blocks,
                "flash_attn_dkv": cfg.num_decoder_blocks, "flash_attn_dq": cfg.num_decoder_blocks,
                "local_corr": 0, "dw_chain": 0, "dw_affine_relu": 0, "windowed_sample": 0,
                "corr_softmax": 0, "dw_block_mm": 0}
    res["expected_launches"] = expected
    print(f"[{card}] train step full RoMa 560^2 batch {TRAIN_BATCH} bf16: first {first_s:.3f} s, "
          f"then {', '.join(f'{t:.4f}' for t in times)} s; {res['samples_per_s']:.3f} samples/s; "
          f"peak {res['peak_mem_gb']:.2f} GB; launches a step {launches}", flush=True)
    print(f"[{card}] train metrics: {json.dumps(all_metrics[-1])}", flush=True)
    for name, n in expected.items():
        fail_if(launches[name] != n, f"train step: {name}: {launches[name]} launches, expected {n}")
    for m in all_metrics:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        fail_if(bool(bad), f"train step: non-finite metrics {bad}")
    fail_if("gm_cls_loss_16" not in all_metrics[-1], "train step: no gm_cls_loss_16")
    dino1 = model.encoder.dinov2.state_dict()
    fail_if(any(not torch.equal(dino0[k], dino1[k]) for k in dino0), "train step: DINOv2 changed")
    sd = model.state_dict()
    still = [k for k in stats0 if torch.equal(stats0[k], sd[k])]
    fail_if(bool(still), f"train step: running statistics not moved: {still[:5]}")
    res["bn_statistics_moved"] = len(stats0)
    if profile_dir is not None:
        res["profile"] = profile_train_step(step, state, batches[1], profile_dir)
        print(f"[{card}] train profile: {json.dumps(res['profile'])}", flush=True)
    return res


def profile_train_step(step, state, batch, out_dir: Path) -> dict:
    """torch.profiler over one training step: wall time, device busy time
    and share, the forward's labelled stages (`roma.*` ranges: device span
    of the forward's kernels; the backward and a checkpoint's recompute run
    outside them), the top kernels by device time (table in
    out_dir/profile_train.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    dev_total = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    dev_self = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    ranges = ("roma.", "Optimizer.")  # labelled ranges, not kernels
    stages = {e.key: dev_total(e) / 1e3 for e in events if e.key.startswith(ranges)}
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(ranges)]
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_self, reverse=True)[:25]
    (out_dir / "profile_train.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall_s * 1e3), "stages_device_ms": stages,
            "top_kernels_ms": {e.key[:80]: dev_self(e) / 1e3 for e in top}}


def check_debug_train_step(dev, card: str) -> dict:
    """The debug-size model in float32, one training step on the GPU (K3's
    float32 entry with lse, K8 and K9 in float32) and on the CPU (plain
    versions) from the same weights and batch: loss and metrics rel 1e-4;
    gradients before the clip under the rule tests/test_torch_train.py holds
    JAX and the port to (`roma_torch.train.grad_parity`: 1e-3 max|g| per
    tensor, the named kink-sensitive tensors of VGG and scales 8 to 1 within
    their relative L2 bounds, conv biases before a BatchNorm below 1e-6).
    Every tensor's reading (max-abs over max|g|, relative L2) goes into the
    report."""
    import dataclasses

    import torch

    from roma_torch.config import TrainConfig
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.models.zoo import build_model, debug_roma_config
    from roma_torch.train.grad_parity import grad_mismatches
    from roma_torch.train.train import make_roma_train_state, make_train_step

    cfg = dataclasses.replace(debug_roma_config(), dtype="float32")
    g = torch.Generator().manual_seed(SEED)
    batch = synthetic_depth_batch(g, "cpu", 1, cfg.coarse_resolution)
    step = make_train_step()
    out, grads = {}, {}
    for where in ("cpu", dev):
        state = make_roma_train_state(TrainConfig(batch_size=1), model=build_model(cfg, SEED),
                                      device=where)
        reset_launches()
        state, metrics = step(state, batch)
        if where != "cpu":
            torch.cuda.synchronize()
            out["launches"] = dict(LAUNCHES)
        norm = float(metrics["grad_norm"])
        sc = max(norm, 0.01) / 0.01  # undo the clip
        grads[str(where)] = {n: p.grad.float().cpu() * sc for n, p in
                             state.model.named_parameters() if p.grad is not None}
        out[str(where)] = {k: float(v) for k, v in metrics.items()}
        model = state.model
    cpu, gpu = out["cpu"], out[str(dev)]
    bad = [k for k in cpu if abs(gpu[k] - cpu[k]) > 1e-4 * abs(cpu[k]) + 1e-12]
    bad_grads, worst = grad_mismatches(model, grads[str(dev)], grads["cpu"])
    bad += bad_grads
    readings = {n: [((grads[str(dev)][n] - r).abs().max() / r.abs().max().clamp_min(1e-30)).item(),
                    ((grads[str(dev)][n] - r).norm() / r.norm().clamp_min(1e-30)).item()]
                for n, r in grads["cpu"].items()}
    res = dict(loss_cpu=cpu["total_loss"], loss_gpu=gpu["total_loss"],
               loss_rel_diff=abs(gpu["total_loss"] - cpu["total_loss"]) / abs(cpu["total_loss"]),
               grads=worst, launches=out["launches"])
    print(f"[{card}] debug float32 train step GPU vs CPU: {json.dumps(res)}", flush=True)
    res["grad_readings"] = readings
    expected = {"flash_attn": cfg.dinov2_depth + cfg.num_decoder_blocks,
                "flash_attn_dkv": cfg.num_decoder_blocks, "flash_attn_dq": cfg.num_decoder_blocks}
    for k, v in expected.items():
        fail_if(out["launches"][k] != v, f"debug train step: {k} {out['launches'][k]} != {v}")
    fail_if(bool(bad), f"debug float32 train step GPU vs CPU: {bad[:8]}")
    return res


def run_float32_match(dev, gen, card: str) -> dict:
    """Full-width roma_outdoor() with RomaConfig(dtype="float32"): match()
    on 2 pairs counted as the default path (K1 5, K2 18, K3 29, K4 63, all
    through their float32 entries), timed, outputs checked."""
    import dataclasses

    import torch

    from roma_torch.config import RomaConfig
    from roma_torch.models.zoo import roma_outdoor

    matcher = roma_outdoor(seed=SEED, device=dev,
                           cfg=dataclasses.replace(RomaConfig(), dtype="float32"))
    warp, cert, launches, first_s, times = run_main_path(matcher, gen, dev, repeats=1)
    expected = expected_launches(matcher.cfg)
    print(f"[{card}] match() float32 on 2 pairs: first {first_s:.3f} s, then "
          f"{', '.join(f'{t:.4f}' for t in times)} s; launches {launches}", flush=True)
    for name, n in expected.items():
        fail_if(launches[name] != n, f"float32 match: {name}: {launches[name]} launches, "
                f"expected {n}")
    check_outputs(matcher, warp, cert)
    res = dict(first_match_s=first_s, match_s=times, pairs_per_s=PAIRS / min(times),
               launches=launches)
    del matcher
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- main path

def timed_match(matcher, a, b):
    import torch

    t0 = time.perf_counter()
    warp, cert = matcher.match(a, b, batched=True)
    torch.cuda.synchronize()
    return warp, cert, time.perf_counter() - t0


def run_main_path(matcher, gen, dev, repeats: int = 3):
    """match() on 2 pairs: a first run, then the counted run (launch
    counters reset just before it and read just after it), then `repeats`
    more timed runs for the rate."""
    import torch

    from roma_torch.kernels import LAUNCHES, reset_launches

    h, w = matcher.cfg.coarse_resolution
    ims = [torch.rand((PAIRS, h, w, 3), generator=gen, device=dev) for _ in range(4)]
    _, _, first_s = timed_match(matcher, ims[0], ims[1])
    reset_launches()
    warp, cert, counted_s = timed_match(matcher, ims[2], ims[3])
    launches = dict(LAUNCHES)
    times = [counted_s] + [timed_match(matcher, ims[0], ims[1])[2] for _ in range(repeats)]
    return warp, cert, launches, first_s, times


def profile_match(matcher, a, b, out_dir: Path, prefix: str, table: str) -> dict:
    """torch.profiler over one match(): device time per labelled stage (the
    `prefix`* ranges), the busy share of the wall time, and the top kernels
    by device time (table written to out_dir/table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    timed_match(matcher, a, b)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall_s = timed_match(matcher, a, b)
    events = prof.key_averages()
    dev_total = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    dev_self = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    # the labelled ranges show up twice: as host ranges and as device spans
    stages = {e.key: dev_total(e) / 1e3 for e in events if e.key.startswith(prefix)}
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(prefix)]
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_self, reverse=True)[:25]
    (out_dir / table).write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall_s * 1e3), "stages_device_ms": stages,
            "top_kernels_ms": {e.key[:80]: dev_self(e) / 1e3 for e in top}}


def check_outputs(matcher, warp, cert, shape=None, clamped: bool = True):
    """(B, H, W) of the certainty (default: full RoMa's symmetric output),
    finite values, certainty in [0, 1], a clamped warp where the matcher
    clamps, and sample()."""
    import torch

    if shape is None:
        hs, ws = matcher.cfg.upsample_resolution
        shape = (PAIRS, hs, 2 * ws)
    fail_if(tuple(warp.shape) != (*shape, 4), f"warp shape {tuple(warp.shape)}")
    fail_if(tuple(cert.shape) != tuple(shape), f"certainty shape {tuple(cert.shape)}")
    fail_if(not bool(torch.isfinite(warp).all()), "warp has non-finite values")
    fail_if(not bool(torch.isfinite(cert).all()), "certainty has non-finite values")
    fail_if(cert.min().item() < 0 or cert.max().item() > 1, "certainty outside [0, 1]")
    fail_if(clamped and warp.abs().max().item() > 1, "warp outside [-1, 1]")
    gen = torch.Generator(device=warp.device).manual_seed(0)
    m, c = matcher.sample(warp[0], cert[0], num=5000, generator=gen)
    fail_if(tuple(m.shape) != (5000, 4) or tuple(c.shape) != (5000,), "sample() shape")


def check_small_reference(seed: int, dev, dtype: str = "bfloat16"):
    """Debug-size model (full widths, 2 ViT blocks, 112 -> 224) on the GPU
    through the kernels against the same weights on the CPU through the
    plain versions, both in `dtype` (bf16, or float32 through the kernels'
    float32 entries). Differences come from rounding in other places (cuDNN
    vs CPU convolutions), so the check is on robust summaries: median |warp
    difference| < 0.02 and mean |certainty difference| < 0.05. Beside it,
    `per_scale_diffs` says at which scale the differences arise."""
    import dataclasses

    import torch

    from roma_torch.models.zoo import debug_roma_config, roma_outdoor

    cfg = dataclasses.replace(debug_roma_config(), dtype=dtype)
    gpu = roma_outdoor(cfg=cfg, seed=seed, device=dev)
    cpu = roma_outdoor(cfg=cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((1, 140, 180, 3), generator=g)
    b = torch.rand((1, 140, 180, 3), generator=g)
    wg, cg = gpu.match(a.to(dev), b.to(dev), batched=True)
    wc, cc = cpu.match(a, b, batched=True)
    dw = (wg.cpu() - wc).abs()
    dc = (cg.cpu() - cc).abs()
    res = dict(median_warp_diff=dw.median().item(), max_warp_diff=dw.max().item(),
               mean_cert_diff=dc.mean().item(), max_cert_diff=dc.max().item(),
               per_scale=per_scale_diffs(gpu, cpu, a, b, dev))
    fail_if(res["median_warp_diff"] >= 0.02 or res["mean_cert_diff"] >= 0.05,
            f"GPU vs CPU debug model disagree: {res}")
    return res


def per_scale_diffs(gpu, cpu, a, b, dev) -> dict:
    """The debug model's coarse and upsample passes on the card and on the
    CPU from the same normalized inputs (CPU resizes), per scale: max and
    99.9th percentile |dflow| (normalized coordinates) and mean |dcert|
    (certainty logits). The card's upsample pass runs twice: from its own
    coarse flow, as match() does, and from the CPU's coarse flow, which
    leaves only the upsample pass's own differences. `decoder_margins`
    reads the match decoder's class logits of the coarse pass (C1)."""
    import torch

    cfg = cpu.cfg
    (hc, wc), (hu, wu) = cfg.coarse_resolution, cfg.upsample_resolution
    sf = math.sqrt((hu * wu) / (hc * wc))
    logits = {}

    def keep(name):
        return lambda mod, args, out: logits.__setitem__(name, out[0].float().cpu())

    hooks = [m.model.decoder.embedding_decoder.register_forward_hook(keep(name))
             for name, m in (("gpu", gpu), ("cpu", cpu))]
    with torch.inference_mode():
        ac, bc = cpu._preprocess(a, b, hs=hc, ws=wc)
        au, bu = cpu._preprocess(a, b, hs=hu, ws=wu)
        coarse_cpu = cpu.model(ac, bc, symmetric=cfg.symmetric)
        coarse_gpu = gpu.model(ac.to(dev), bc.to(dev), symmetric=cfg.symmetric)
        for hk in hooks:
            hk.remove()

        def upsample(matcher, coarse, d):
            return matcher.model(au.to(d), bu.to(d), symmetric=cfg.symmetric, upsample=True,
                                 flow=coarse[1]["flow"].to(d),
                                 certainty=coarse[1]["certainty"].to(d), scale_factor=sf)

        up_cpu = upsample(cpu, coarse_cpu, "cpu")
        up_gpu = upsample(gpu, coarse_gpu, dev)
        up_fed = upsample(gpu, coarse_cpu, dev)

    def stats(got, ref):
        out = {}
        for s in ref:
            df = (got[s]["flow"].float().cpu() - ref[s]["flow"].float()).abs().flatten()
            dc = (got[s]["certainty"].float().cpu() - ref[s]["certainty"].float()).abs()
            out[f"s{s}"] = dict(max_flow=df.max().item(),
                                q999_flow=torch.quantile(df, 0.999).item(),
                                mean_cert=dc.mean().item())
        return out

    return {"coarse": stats(coarse_gpu, coarse_cpu), "upsample": stats(up_gpu, up_cpu),
            "upsample_from_cpu_coarse": stats(up_fed, up_cpu),
            "decoder_margins": decoder_margins(logits, coarse_gpu[16]["flow"].float().cpu(),
                                               coarse_cpu[16]["flow"].float())}


def decoder_margins(logits: dict, flow_gpu, flow_cpu, thresh: float = 0.1) -> dict:
    """The match decoder's top-2 class-logit margin (top1 - top2, CPU
    logits) over all scale-16 pixels and at those whose GPU and CPU flows
    differ by more than `thresh` in either coordinate, with the share of
    those pixels whose winning class differs between GPU and CPU: a flip of
    near-tied classes moves the decoded flow by a whole anchor."""
    import torch

    cpu, gpu = logits["cpu"], logits["gpu"]
    top = torch.topk(cpu, 2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    diff = (flow_gpu - flow_cpu).abs().amax(-1) > thresh
    flipped = gpu.argmax(-1) != cpu.argmax(-1)
    at = margin[diff]
    q = lambda t, x: torch.quantile(t, x).item() if t.numel() else float("nan")
    return dict(pixels=margin.numel(), differing=int(diff.sum()),
                margin_median_all=q(margin, 0.5), margin_q10_all=q(margin, 0.1),
                margin_median_differing=q(at, 0.5),
                margin_max_differing=at.max().item() if at.numel() else float("nan"),
                argmax_flipped_all=int(flipped.sum()),
                argmax_flipped_differing=int((flipped & diff).sum()))


def print_rows(card: str, rows: dict, name: str) -> None:
    for r in rows[name]:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        tol = r["tol"] if isinstance(r["tol"], str) else f"{r['tol']:.1e}"
        print(f"[{card}] {name} {r['shape']} {r['dims']}: err {r['max_abs_err']:.3e} "
              f"(tol {tol}) kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.1%} of the bound"
              + (f"; rounds {[round(t, 4) for t in r['ms_rounds']]} ms" if "ms_rounds" in r else ""),
              flush=True)


def print_attention_bwd(card: str, bwd: dict) -> None:
    """K8/K9: the worst error of each case over its bound, the planted
    fault's excess, the whole backward call beside SDPA's with the
    launch's blocks per SM and waves, K3's forward with and without its
    lse."""
    for c in bwd["cases"]:
        print(f"[{card}] flash_attn bwd {c['case']}: " + ", ".join(
            f"{n} err {c[n]['max_abs_err']:.3e} ({c[n]['worst_over_tol']:.3f} of tol)"
            for n in ("dq", "dk", "dv")) + f"; lse err {c['lse_max_abs_err']:.2e}", flush=True)
    print(f"[{card}] flash_attn bwd planted fault, error over the bound: "
          f"{json.dumps(bwd['planted'])}", flush=True)
    print(f"[{card}] flash_attn bwd at the decoder's training shape: the whole "
          f"attention_bwd_cuda call (di + K8 + K9) {bwd['whole_ms']:.4f} ms (device alone, "
          f"graph replay: {bwd['whole_graph_ms']:.4f} ms, of which the plain di "
          f"{bwd['di_graph_ms']:.4f}), SDPA's whole backward {bwd['sdpa_ms']:.4f} ms on the "
          f"device ({bwd['sdpa_events_ms']:.4f} by CUDA events, host included); "
          f"launches {json.dumps(bwd['grid'])}", flush=True)
    print(f"[{card}] flash_attn forward at the decoder's training shape: {bwd['fwd_ms']:.4f} ms "
          f"without lse, {bwd['fwd_lse_ms']:.4f} ms with lse", flush=True)


def print_windowed(card: str, rows: list[dict]) -> None:
    """K6 per shape: the whole call in both modes on both flows and maps of
    both layouts, the errors per flow and mode; the float32 map's."""
    for r in rows:
        print(f"[{card}] windowed_sample {r['shape']}: whole call ms {json.dumps(r['whole_ms'])}; "
              f"errors {json.dumps(r['errors'])}", flush=True)
    print(f"[{card}] windowed_sample float32 {rows[0]['shape']}: {json.dumps(rows[0]['float32'])}",
          flush=True)


def print_dw_chain(card: str, rows: list[dict]) -> None:
    """K2's per-shape detail: one block and chain against plain (error,
    worst error over tolerance, share of elements differing), per-launch
    time, the 9-launch floor and K4 + cuDNN 1x1; then the ragged cases."""
    for r in rows:
        one, chain = r["one_block"], r["chain"]
        print(f"[{card}] dw_chain {r['shape']}: one block err {one['max_abs_err']:.3e} "
              f"(worst {one['worst_err_over_tol']:.3f} of 2^-7|plain| + 1e-5, differing "
              f"{one['differing_share']:.2e}); chain err {chain['max_abs_err']:.3e} (worst "
              f"{chain['worst_err_over_tol']:.3f} of its tol, differing "
              f"{chain['differing_share']:.2e}); {r['ms_per_launch']:.4f} ms a launch, "
              f"9-launch floor {r['launch_floor_ms']:.4f} ms, K4 + cuDNN 1x1 x9 "
              f"{r['k4_cudnn_1x1_ms']:.4f} ms; rounds {[round(t, 4) for t in r['ms_rounds']]}",
              flush=True)
    for g in rows[0]["ragged"]:
        print(f"[{card}] dw_chain ragged {g['dims']} x{g['blocks']}: err {g['max_abs_err']:.3e} "
              f"(worst {g['worst_err_over_tol']:.3f} of tol), differing {g['differing_share']:.2e}",
              flush=True)


def print_local_corr(card: str, rows: list[dict]) -> None:
    """K1 per shape and input: error, time, share of
    tiles on the shared-window path, window-row bytes and their read rate,
    the union's median / 90th percentile, reuse; then the tile count per
    path over all inputs."""
    for r in rows:
        for kind, v in r["inputs"].items():
            print(f"[{card}] local_corr {r['shape']} {kind}: err {v['max_abs_err']:.2e}, "
                  f"{v['ms']:.4f} ms, bound {v['bound_ms']:.4f}; shared tiles "
                  f"{v['shared_tiles']}/{v['tiles']}; corners/pixel {v['corners_per_pixel']:.1f}, "
                  f"window rows {v['window_row_bytes'] / 1e9:.3f} GB at {v['read_rate_tb_s']:.2f} "
                  f"TB/s; union median {v['union_median']:.0f} / q90 {v['union_q90']:.0f} px, "
                  f"reuse {v['reuse']:.1f}", flush=True)
    for v in rows[0]["ragged"]:
        print(f"[{card}] local_corr ragged {v['dims']} r {v['radius']} {v['flow']}: err "
              f"{v['max_abs_err']:.2e}, shared tiles {v['shared_tiles']}/{v['tiles']}", flush=True)
    print(f"[{card}] local_corr tiles per path over all inputs: {rows[0]['tiles_on']}", flush=True)


def run_tiny(dev, gen, card: str, profile_dir: Path | None = None) -> dict:
    """Path A: Tiny RoMa v1 with fused_kernel=True on 8 pairs at 480x640 (a
    first call, the counted call, 3 timed calls; with `profile_dir`, one
    more under torch.profiler), one 1056x1920 pair, the same weights with
    fused_kernel=False, and a small GPU-vs-CPU check."""
    import torch

    from roma_torch.config import TinyRomaConfig
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.models.zoo import tiny_roma_v1_outdoor

    fused = tiny_roma_v1_outdoor(seed=SEED, device=dev, cfg=TinyRomaConfig(fused_kernel=True))
    H, W = TINY_HW
    ims = [torch.rand((TINY_PAIRS, H, W, 3), generator=gen, device=dev) for _ in range(2)]
    res: dict = {}
    _, _, res["first_match_s"] = timed_match(fused, *ims)
    reset_launches()
    warp, cert, counted_s = timed_match(fused, *ims)
    res["launches"] = launches = dict(LAUNCHES)
    times = [counted_s] + [timed_match(fused, *ims)[2] for _ in range(3)]
    res.update(match_s=times, pairs_per_s=TINY_PAIRS / min(times))
    print(f"[{card}] tiny match() on {TINY_PAIRS} pairs at {H}x{W} (fused_kernel=True): first "
          f"{res['first_match_s']:.3f} s, then {', '.join(f'{t:.4f}' for t in times)} s; best "
          f"{res['pairs_per_s']:.2f} pairs/s; launches {launches}", flush=True)
    for name, n in launches.items():
        fail_if(n != int(name == "corr_softmax"), f"tiny match(): {name} launched {n} times")
    check_outputs(fused, warp, cert, (TINY_PAIRS, H, W), clamped=False)
    if profile_dir is not None:
        res["profile"] = profile_match(fused, *ims, profile_dir, "tiny.", "profile_tiny.txt")
        print(f"[{card}] tiny profile: {json.dumps(res['profile'])}", flush=True)

    plain = tiny_roma_v1_outdoor(seed=SEED, device=dev)
    timed_match(plain, *ims)
    w2, c2, plain_s = timed_match(plain, *ims)
    res.update(unfused_match_s=plain_s, unfused_pairs_per_s=TINY_PAIRS / plain_s,
               fused_vs_unfused_median_warp_diff=(w2 - warp).abs().median().item(),
               fused_vs_unfused_mean_cert_diff=(c2 - cert).abs().mean().item())
    print(f"[{card}] tiny match() same weights, fused_kernel=False: {plain_s:.4f} s "
          f"({res['unfused_pairs_per_s']:.2f} pairs/s); fused {min(times):.4f} s; median "
          f"|dwarp| {res['fused_vs_unfused_median_warp_diff']:.2e}", flush=True)
    fail_if(res["fused_vs_unfused_median_warp_diff"] >= 0.02,
            "tiny fused vs unfused disagree")
    del plain, w2, c2

    Hm, Wm = MEGAPIXEL_HW
    big = [torch.rand((1, Hm, Wm, 3), generator=gen, device=dev) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    wm, cm, res["megapixel_match_s"] = timed_match(fused, *big)
    res["megapixel_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check_outputs(fused, wm, cm, (1, Hm, Wm), clamped=False)
    print(f"[{card}] tiny match() on 1 pair at {Hm}x{Wm} (L = {Hm // 8 * Wm // 8}): "
          f"{res['megapixel_match_s']:.4f} s (first call at this size), peak "
          f"{res['megapixel_peak_mem_gb']:.2f} GB", flush=True)
    del fused, big, wm, cm

    # small model check: same weights on the GPU (kernel) and the CPU (plain)
    gpu = tiny_roma_v1_outdoor(seed=SEED, device=dev, cfg=TinyRomaConfig(fused_kernel=True))
    cpu = tiny_roma_v1_outdoor(seed=SEED, device="cpu", cfg=TinyRomaConfig(fused_kernel=True))
    g = torch.Generator().manual_seed(SEED)
    a, b = (torch.rand((1, 128, 160, 3), generator=g) for _ in range(2))
    wg, cg = gpu.match(a.to(dev), b.to(dev), batched=True)
    wc, cc = cpu.match(a, b, batched=True)
    dw, dc = (wg.cpu() - wc).abs(), (cg.cpu() - cc).abs()
    res["small_reference"] = dict(median_warp_diff=dw.median().item(),
                                  max_warp_diff=dw.max().item(),
                                  mean_cert_diff=dc.mean().item(), max_cert_diff=dc.max().item())
    print(f"[{card}] tiny GPU vs CPU (128x160): {res['small_reference']}", flush=True)
    fail_if(res["small_reference"]["median_warp_diff"] >= 0.02
            or res["small_reference"]["mean_cert_diff"] >= 0.05,
            f"tiny GPU vs CPU disagree: {res['small_reference']}")
    torch.cuda.empty_cache()
    return res


def run_smooth_warp(dev, gen, card: str) -> dict:
    """Path B: full RoMa with smooth_warp_gather="fast", counted and timed
    as the default path, then one more match() that records, per pass,
    whether the scale-1 flow was window-smooth (the `with_ok` flag); then
    the same weights with smooth_warp_gather=True ("exact"), counted (2
    windowed-gather launches, no host read of `ok`) and timed the same way.
    Last, one pair of images matched in "exact" mode and with the smooth
    warp off (the default path's grid_sample): exact mode computes the same
    function, rounded once to bf16 per sample where grid_sample's float32
    sums round in another order (one bf16 ulp apart at most), so the two
    matches must agree within `match_diffs`' bounds."""
    import torch

    from roma_torch.models.zoo import roma_outdoor
    from roma_torch.ops.windowed_sample import pad_grid, smoothness_ok

    matcher = roma_outdoor(seed=SEED, device=dev, smooth_warp_gather="fast")
    cfg = matcher.cfg
    expected = dict(expected_launches(cfg), windowed_sample=2)
    res = {}
    for mode in ("fast", True):
        for refiner in matcher.model.decoder.conv_refiner.values():
            refiner.smooth_warp = mode
        warp, cert, launches, first_s, times = run_main_path(matcher, gen, dev)
        key = "fast" if mode == "fast" else "exact"
        res[key] = dict(first_match_s=first_s, match_s=times, pairs_per_s=PAIRS / min(times),
                        launches=launches)
        print(f"[{card}] match() smooth_warp_gather={mode!r} on 2 pairs: first {first_s:.3f} s, "
              f"then {', '.join(f'{t:.4f}' for t in times)} s; best "
              f"{res[key]['pairs_per_s']:.3f} pairs/s; launches {launches}", flush=True)
        for name, n in expected.items():
            fail_if(launches[name] != n,
                    f"smooth warp {key}: {name}: {launches[name]} launches, expected {n}")
        check_outputs(matcher, warp, cert)
    res["launches"] = res["fast"]["launches"]

    oks = []

    def record_ok(mod, args):
        _, y, flow = args[:3]
        oks.append(bool(smoothness_ok(y, pad_grid(flow), tuple(flow.shape[1:3]))))

    hook = matcher.model.decoder.conv_refiner["1"].register_forward_pre_hook(record_ok)
    h, w = cfg.coarse_resolution
    timed_match(matcher, *(torch.rand((PAIRS, h, w, 3), generator=gen, device=dev)
                           for _ in range(2)))
    hook.remove()
    res["ok_share"] = sum(oks) / len(oks)
    print(f"[{card}] smooth warp: window-smooth share of scale-1 warps {res['ok_share']} "
          f"({oks}; random weights give rough flows)", flush=True)

    ims = [torch.rand((PAIRS, h, w, 3), generator=gen, device=dev) for _ in range(2)]
    outs = {}
    for mode in (True, False):
        for refiner in matcher.model.decoder.conv_refiner.values():
            refiner.smooth_warp = mode
        outs[mode] = timed_match(matcher, *ims)[:2]
    res["exact_vs_default"] = cmp = match_diffs(*outs[True], *outs[False])
    print(f"[{card}] smooth warp: exact match() vs the default match(): {cmp}", flush=True)
    fail_if(not cmp["within"], f"exact smooth-warp match() disagrees with the default: {cmp}")
    del matcher
    torch.cuda.empty_cache()
    return res


def expected_launches(cfg) -> dict:
    """Launches of one default full-RoMa match()."""
    return {
        "local_corr": sum(1 for s in ("16", "8", "4") if cfg.refiners[s].local_corr_radius)
        + sum(1 for s in ("8", "4") if cfg.refiners[s].local_corr_radius),
        "dw_chain": 2 * (1 + cfg.refiners["1"].hidden_blocks),
        "flash_attn": cfg.dinov2_depth + cfg.num_decoder_blocks,
        "corr_softmax": 0,
        "windowed_sample": 0,
        "dw_affine_relu": sum(blocks for *_, blocks in wide_refiner_shapes(cfg)),
        "dw_block_mm": 0,
        "flash_attn_dkv": 0,
        "flash_attn_dq": 0,
    }


def match_diffs(warp, cert, warp_ref, cert_ref) -> dict:
    """Two matches of the same images compared with the JAX package's
    statistical bounds (`within`): mean |dwarp| < 2e-2, its 90th percentile
    < 5e-2, mean |dcert| < 2e-2."""
    import numpy as np

    dw = (warp - warp_ref).abs().cpu().numpy()
    dc = (cert - cert_ref).abs().cpu().numpy()
    cmp = dict(mean_warp_diff=float(dw.mean()), q90_warp_diff=float(np.quantile(dw, 0.9)),
               max_warp_diff=float(dw.max()), mean_cert_diff=float(dc.mean()),
               max_cert_diff=float(dc.max()))
    cmp["within"] = (cmp["mean_warp_diff"] < 2e-2 and cmp["q90_warp_diff"] < 5e-2
                     and cmp["mean_cert_diff"] < 2e-2)
    return cmp


def run_match_raw(matcher, card: str) -> dict:
    """Path C: `match_raw` on 2 pairs of uint8 canvases from two source
    sizes (480 x 640 and 600 x 800, zero-padded into a 600 x 800 bucket),
    resized on the device through PIL-parity banks: a first call, the
    counted call (the same launches as match()), 3 timed calls; then the
    output against `match_prepped` on host PIL resizes of the same images,
    with the JAX package's statistical bounds (mean |dwarp| < 2e-2, its 90th
    percentile < 5e-2, mean |dcert| < 2e-2: one-uint8-level input
    differences move a random-weight model chaotically at a few pixels),
    and `sample_batched` on the output."""
    import numpy as np
    import torch
    from PIL import Image

    from roma_torch.kernels import LAUNCHES, reset_launches

    rng = np.random.default_rng(SEED)
    shapes = [(480, 640), (600, 800), (600, 800), (480, 640)]  # A0, A1, B0, B1
    ims = [Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)) for hw in shapes]
    sizes = sorted(set(shapes))
    bucket = (600, 800)
    raw = np.zeros((len(ims), *bucket, 3), np.uint8)
    for i, im in enumerate(ims):
        raw[i, :im.height, :im.width] = np.asarray(im)
    idx = np.array([sizes.index(hw) for hw in shapes], np.int32)
    banks = matcher.build_resize_banks(sizes, bucket)

    def timed():
        t0 = time.perf_counter()
        w, c = matcher.match_raw(raw, idx, banks)
        torch.cuda.synchronize()
        return w, c, time.perf_counter() - t0

    res: dict = {}
    _, _, res["first_match_s"] = timed()
    reset_launches()
    warp, cert, counted_s = timed()
    res["launches"] = launches = dict(LAUNCHES)
    times = [counted_s] + [timed()[2] for _ in range(3)]
    res.update(match_s=times, pairs_per_s=PAIRS / min(times))
    print(f"[{card}] match_raw() on 2 pairs (480x640 and 600x800 canvases): first "
          f"{res['first_match_s']:.3f} s, then {', '.join(f'{t:.4f}' for t in times)} s; best "
          f"{res['pairs_per_s']:.3f} pairs/s; launches {launches}", flush=True)
    for name, n in expected_launches(matcher.cfg).items():
        fail_if(launches[name] != n, f"match_raw: {name}: {launches[name]} launches, expected {n}")
    check_outputs(matcher, warp, cert)

    (hc, wc), (hu, wu) = matcher.cfg.coarse_resolution, matcher.cfg.upsample_resolution
    host = lambda ids, h, w: np.stack([matcher.host_resize_np(ims[i], h, w) for i in ids])
    wh, ch = matcher.match_prepped(host((0, 1), hc, wc), host((2, 3), hc, wc),
                                   host((0, 1), hu, wu), host((2, 3), hu, wu))
    res["vs_match_prepped"] = cmp = match_diffs(warp, cert, wh, ch)
    print(f"[{card}] match_raw vs match_prepped on host PIL resizes: {cmp}", flush=True)
    fail_if(not cmp["within"], f"match_raw disagrees with match_prepped: {cmp}")

    gens = [torch.Generator(device=warp.device).manual_seed(s) for s in range(PAIRS)]
    m, c = matcher.sample_batched(warp, cert, 5000, gens)
    fail_if(tuple(m.shape) != (PAIRS, 5000, 4) or tuple(c.shape) != (PAIRS, 5000),
            "sample_batched() shape")
    ref = matcher.sample(warp[1], cert[1], 5000, torch.Generator(device=warp.device).manual_seed(1))
    fail_if(not (torch.equal(m[1], ref[0]) and torch.equal(c[1], ref[1])),
            "sample_batched() differs from sample() with the same generator")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one match() with torch.profiler")
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "chip_smoke",
                    help="directory for chip_smoke.json and the profile table")
    args = ap.parse_args()

    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU, no result",
              file=sys.stderr)
        return 2
    if not (ROOT / "roma_torch" / "__init__.py").exists():
        print("chip_smoke: roma_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import roma_torch  # noqa: F401  (sets the TF32 switches off)
    from roma_torch.kernels import runtime
    from roma_torch.models.zoo import roma_outdoor

    card = gpu_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    planted_dir = tempfile.TemporaryDirectory()
    planted = start_planted_build(Path(planted_dir.name))  # beside the main build
    report["ptxas"] = runtime.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"[{card}] built {len(runtime.SOURCES)} kernel sources in {report['build_s']:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    matcher = roma_outdoor(seed=SEED, device=dev)
    torch.cuda.synchronize()
    report["model_build_s"] = time.perf_counter() - t0
    cfg = matcher.cfg

    gen = torch.Generator(device=dev).manual_seed(SEED)
    captured = capture_local_corr(matcher, gen, dev)
    rows = {
        "local_corr": check_local_corr(dev, gen, cfg, captured),
        "dw_chain": check_dw_chain(dev, gen, cfg, chain_params(matcher.model)),
        "flash_attn": check_flash_attn(dev, gen, cfg),
        "dw_affine_relu": check_dw_affine_relu(dev, gen, cfg),
        "dw_block_mm": check_dw_block_mm(dev, gen),
    }
    bwd = check_attention_bwd(dev, gen, cfg, planted)
    planted_dir.cleanup()
    rows.update(bwd["rows"])
    report["kernel_rows"] = rows
    report["attention_bwd"] = {k: v for k, v in bwd.items() if k != "rows"}
    report["float32_entries"] = f32 = check_float32_entries(dev, gen, cfg, captured, matcher.model)
    del captured
    torch.cuda.empty_cache()
    for name in rows:
        print_rows(card, rows, name)
    print_attention_bwd(card, bwd)
    print(f"[{card}] float32 entries (C3), tolerance {F32_TOL:.0e} max(1, max|plain|): "
          + json.dumps(f32), flush=True)
    print(f"[{card}] dw_affine_relu share of elements differing from plain: "
          f"{[r['differing_share'] for r in rows['dw_affine_relu']]}; ragged "
          f"{rows['dw_affine_relu'][0]['ragged']}", flush=True)
    for r in rows["dw_block_mm"]:
        print(f"[{card}] dw_block_mm {r['shape']}: {r['ms']:.4f} ms against K4 + cuDNN 1x1 "
              f"{r['k4_cudnn_1x1_ms']:.4f} ms ({'faster' if r['ms'] < r['k4_cudnn_1x1_ms'] else 'SLOWER'})"
              + f", bound {r['bound_ms']:.4f} ms", flush=True)
    print(f"[{card}] dw_block_mm: sum {sum(r['ms'] for r in rows['dw_block_mm']):.4f} ms, K4 + "
          f"cuDNN 1x1 {sum(r['k4_cudnn_1x1_ms'] for r in rows['dw_block_mm']):.4f} ms; ragged "
          f"max_abs_err {rows['dw_block_mm'][0]['ragged_max_abs_err']}", flush=True)
    print_dw_chain(card, rows["dw_chain"])
    print_local_corr(card, rows["local_corr"])

    expected = expected_launches(cfg)
    out_dir = args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    warp, cert, launches, first_s, times = run_main_path(matcher, gen, dev)
    best = min(times)
    report.update(first_match_s=first_s, match_s=times, pairs_per_s=PAIRS / best,
                  launches=launches, expected_launches=expected)
    print(f"[{card}] match() on 2 pairs (560 -> 864, ViT-L 24 blocks, bf16): first "
          f"{first_s:.3f} s, then {', '.join(f'{t:.4f}' for t in times)} s; best "
          f"{PAIRS / best:.3f} pairs/s", flush=True)
    print(f"[{card}] launches in one match(): {launches} (expected {expected})", flush=True)
    for name, n in expected.items():
        fail_if(launches[name] != n, f"{name}: {launches[name]} launches, expected {n}")
    check_outputs(matcher, warp, cert)
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if args.profile:
        h, w = cfg.coarse_resolution
        ims = [torch.rand((PAIRS, h, w, 3), generator=gen, device=dev) for _ in range(2)]
        report["profile"] = profile_match(matcher, *ims, out_dir, "roma.", "profile_match.txt")
        print(f"[{card}] profile: {json.dumps(report['profile'])}", flush=True)
    report["match_raw"] = run_match_raw(matcher, card)
    del matcher
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        key = "small_reference" if dtype == "bfloat16" else "small_reference_float32"
        report[key] = ref = check_small_reference(SEED, dev, dtype)
        print(f"[{card}] debug model {dtype} GPU vs CPU: " + json.dumps(
            {k: v for k, v in ref.items() if k != "per_scale"}), flush=True)
        print(f"[{card}] debug model {dtype} match decoder top-2 logit margins (C1): "
              + json.dumps(ref["per_scale"]["decoder_margins"]), flush=True)
        for pass_, scales in ref["per_scale"].items():
            if pass_ == "decoder_margins":
                continue
            print(f"[{card}] debug model {dtype} GPU vs CPU, {pass_} pass per scale (|dflow| max "
                  "/ 99.9% / mean |dcert|): " + "; ".join(
                      f"{s} {v['max_flow']:.3e} / {v['q999_flow']:.3e} / {v['mean_cert']:.3e}"
                      for s, v in scales.items()), flush=True)
    report["float32_match"] = run_float32_match(dev, gen, card)

    rows["corr_softmax"] = check_corr_softmax(dev, gen)
    print_rows(card, rows, "corr_softmax")
    for r in rows["corr_softmax"]:
        print(f"[{card}] corr_softmax {r['shape']}: bf16 entry {r['ms']:.4f} ms (err "
              f"{r['err']['bf16']:.2e}), fp32 entry {r['fp32_ms']:.4f} ms (err "
              f"{r['err']['fp32']:.2e}; on fp32 randn "
              f"{r['err'].get('fp32 randn', float('nan')):.2e}), SDPA bf16 flash {r['library_ms']:.4f} ms, SDPA fp32 "
              f"{r['library_fp32_ms']:.4f} ms", flush=True)
    print(f"[{card}] corr_softmax ragged: {rows['corr_softmax'][0]['ragged']}", flush=True)
    report["tiny"] = run_tiny(dev, gen, card, out_dir if args.profile else None)
    rows["windowed_sample"] = check_windowed_sample(dev, gen, cfg)
    print_rows(card, rows, "windowed_sample")
    print_windowed(card, rows["windowed_sample"])
    report["smooth_warp"] = run_smooth_warp(dev, gen, card)
    torch.cuda.empty_cache()
    report["train"] = run_training(dev, gen, card, out_dir if args.profile else None)
    torch.cuda.empty_cache()
    report["debug_train_step"] = check_debug_train_step(dev, card)

    # each kernel's launches come from the run of the path it serves
    train = report["train"]["launches"]
    path_launches = dict(launches, corr_softmax=report["tiny"]["launches"]["corr_softmax"],
                         windowed_sample=report["smooth_warp"]["launches"]["windowed_sample"],
                         flash_attn_dkv=train["flash_attn_dkv"],
                         flash_attn_dq=train["flash_attn_dq"])
    kernels = [summarize(name, rows[name], path_launches[name]) for name in KERNELS]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[{card}] chip_smoke ran in {report['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
