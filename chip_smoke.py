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
   against match_prepped on host PIL resizes, then sample_batched (10,000
   matches a pair, its KDEs counted from zero: one a pair); then the
   debug-size model on the GPU against the same weights on the CPU, with
   its flow differences per scale of both passes and the match decoder's
   top-2 class-logit margins where the scale-16 flows differ;
7. the balanced sampler's KDE (roma::kde) at its two pool sizes (40,000
   and 20,000 points) and ragged ones against a float64 sum and beside the
   plain version, bitwise repeatable, timed beside its bound and the plain
   version; then
   Tiny RoMa v1 (fused_kernel=True) on 8 pairs at 480x640, counted the same
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
   tests/test_torch_train.py holds JAX and the port to); then the ViT
   block's other options (run_vit_swiglu): 24 ViT-L/14 blocks with the
   SwiGLU FFN, layer scale, qkv bias and drop_path 0.1 from a generator on
   the card, bf16, the final LayerNorm and the DINO head (65,536
   prototypes) on the CLS tokens of (4, 1601, 1024) tokens, AdamW on a DINO
   loss, 2 warm-up and 3 timed steps, the first counted (K3 24 with lse,
   K8 24, K9 24), each step's drop_path draws recorded (kept share within
   5 binomial standard deviations of 0.9), finite loss and gradients, each
   step's seconds (with its host enqueue time, device span, new cudaMalloc
   segments and the SM clock nvidia-smi samples meanwhile), their median,
   and peak memory above what the phase started with; its first 2 blocks
   in float32 on the card against the CPU (output and every gradient
   under grad_parity's GRAD_TOL, max-abs and relative L2);
   resize_bicubic(antialias=False) of
   a 2 x 864^2 image to 560^2, card against CPU within 1e-5 of max|CPU|;
   K8, K9 and SDPA's whole backward timed at (4, 1601, 16, 64);
12. Tiny RoMa training as its CLI composes it (roma_torch/experiments/
   train_tiny_roma_v1_outdoor.py): full width, bf16, 768x1024, batch 8, a
   data-parallel mesh of one rank over NCCL, a PairLoader over synthetic
   depth batches, train_k_steps; one warm-up, one counted step (every
   kernel 0 launches) under the sync debug mode "warn" (its synchronizing
   calls reported), 3 timed steps; finite metrics with corr_volume_loss_8,
   every running statistic moved, samples/s and peak memory; one step
   through mesh= against the same step without it; a checkpoint round
   trip;
13. the evaluation path (run_eval, run right after 6 on its matcher) on
   a two-plane world rendered from a seed in the MegaDepth layout (8
   pairs, 480x640 and 600x800): the native estimator built from
   roma_torch/native beside the kernels and bound (no fallback); exact
   warps through the batched harness engine on the card, batch 4, with and
   without device_resize (AUC@5 > 0.9); full-width roma_outdoor() through
   MegaDepthPoseEstimationBenchmark (batch 2, device_resize, native, 5000
   samples, 5 runs): the first batch's launches as expected, finite
   errors, no synchronizing call from the harness's main loop under sync
   debug mode "warn", pairs/s, the match's device time, the estimator
   pool's time, with --profile the device idle share of one eval; then
   train -> eval: Tiny RoMa trained 600 steps on the 96x128 world of
   tests/test_train_to_eval.py from `build_model`'s default init (the JAX
   package's) reaches AUC@5 > 0.5 and > untrained + 0.3 through the
   port's harness; then the tail (run_tail, on the same matcher): Tiny
   RoMa with fused_kernel=True exported by torch.export at 1 x 480x640
   with the weights as its first input, saved, loaded and run (K7 once a
   call, nothing else, bit-equal to eager); profiling.roofline of the
   default match() (FLOPs with K1-K4 counted through their roma::
   operators' formulas, each formula against FlopCounterMode over the
   operator's plain version at every signature the match gives it; bytes,
   TFLOP/s, tensor-core share; launches K1 5, K2 18, K3 29, K4 63 a
   match), pairs/s and the profiled device busy ms; the four demos on a
   rendered 480x640 pair through their main(); ResNet-50 float32 GPU vs
   CPU at every level (1e-4 of max|CPU|) and its bf16 shapes at 560^2;
   grid_sample_nearest GPU vs CPU on half-pixel ties, bit-equal;
14. SfM (run_sfm): the JAX study's bundle adjustment at its full sizes
   (experiments/sfm_scale.py's worlds and pose-graph init from the same
   seeds: 100 cams / 10k pts / 249,574 obs dense, 1k cams / 100k pts /
   846,122 obs CG; 30 LM iterations, Huber 3 px, gate 20 px), the
   deterministic 100-camera run's ATE rmse within 5% and cost within 1%
   of the JAX package's CPU reading, every run below its start; one LM
   candidate step of each device solve at lambda 1e-4 .. 1e-1 against a
   float64 oracle (at 1e-1 the camera delta within 1e-6, where the
   float32 solve alone is not, 2e-6 with atomics; the cost after it within
   1e-4 of the oracle's and, at 100 cameras, the JAX package's);
   no host sync inside an LM iteration (sync debug mode "warn"); chunked
   (iters_per_launch) against single and one NCCL rank against no mesh,
   with and without torch.use_deterministic_algorithms (gated on the
   deterministic runs, 1e-6); `reconstruct` on exact-warp matches of 8
   images rendered along tests/test_sfm.py's curved trajectory (ATE rmse <
   0.02, wall by stage); the SfM CLI (roma_torch/experiments/
   sfm_reconstruct.py --matcher roma) with full-width roma_outdoor(), each
   window pair's match counted (K1-K4 as `expected_launches`), the .npz
   finite; with --profile, 3 LM iterations of the 1k CG run traced;
15. prints the kernels JSON line, then {"ok": true, "device": ...} last.

Any failure exits non-zero before the last line. Detailed per-shape results
go to DIR/chip_smoke.json (default results/chip_smoke/).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
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
    "kde": ("none (roma_tpu/utils/kde.py is plain jnp)", "roma_torch/csrc/kde.cu"),
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


def profiled_device_ms(fn, iters: int = 10, by_kernel: dict | None = None) -> float:
    """Device ms per call of `fn`: the kernels' own time in a torch.profiler
    trace of `iters` calls (host time excluded), for a library call whose
    host work can outlast its kernels (autograd), where CUDA events would
    time the host. `by_kernel` receives each kernel's ms per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / iters
        total += ms
        if by_kernel is not None and ms > 0:
            by_kernel[e.key[:80]] = by_kernel.get(e.key[:80], 0.0) + ms
    return total


def median(xs: list[float]) -> float:
    return xs[len(xs) // 2]


def bound(bytes_moved: float, flops: float, exps: float = 0.0) -> tuple[float, str]:
    """Least ms for the work: the bytes over the memory rate, or the
    operations (tensor-core products, or exponentials on the
    special-function units, whichever takes longer) over their peak
    (`roma_torch.utils.profiling`'s H100 SXM peaks). The products are each
    kernel's FLOP formula (`flops` in its module, its operator's formula for
    FlopCounterMode) where that is what the run's data needs: K1 counts
    the corners in range, which depend on the flow, and K6 the bilinear
    arithmetic that FlopCounterMode does not count."""
    from roma_torch.utils.profiling import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_EXPS

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
    from roma_torch.utils.profiling import PEAK_BYTES

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
        flops = dw_chain.flops(*(tuple(t.shape) for t in (x, *params)))
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
        b_ms, b_by = bound(2 * n * 2 + 25 * C * 2 + 2 * C * 4,
                           k4.flops(x.shape, w.shape, sc.shape, sh.shape))
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
                           k5.flops(*(tuple(t.shape) for t in args)))
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
        flops = at.flops(q.shape, k.shape, v.shape)
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
        b_ms, b_by = bound(nbytes, cs.flops(f0.shape, f1.shape, grid.shape), float(B * L * L))
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


KDE_TOL = 2e-5  # relative, against float64; a serial float32 sum reads 7e-6 at N = 40,000


def kde_pool(n: int, gen, dev):
    """(n, 4) float32 match coordinates in [-1, 1] like a dense warp's: x_B a
    smooth function of x_A."""
    import torch

    a = torch.rand((n, 2), generator=gen, device=dev) * 2 - 1
    b = (0.8 * a + 0.15 * torch.sin(3.0 * a.flip(-1)) + 0.05).clamp(-1, 1)
    return torch.cat([a, b], -1)


def check_kde(dev, gen):
    """The balanced sampler's KDE (`roma::kde`, std 0.1) at its two pool
    sizes, 4 x 10,000 (full RoMa, `calls` PAIRS: `run_match_raw` samples
    10,000 matches a pair) and 4 x 5,000 (Tiny RoMa), against the density
    summed in float64 over direct differences (max relative error <=
    KDE_TOL), bitwise the same in two runs, and for correctness only at
    N = 1, 5, 127 and 2,049 and on uniform points. Beside the float64 sum,
    the relative difference from the plain version (`vs_plain`, reported).
    Times the kernel (median of 5 rounds of 20 calls) and the plain version
    on the card; no PyTorch call computes the same function (library_ms
    None). The bound counts the exponentials, one a pair; bytes: the points
    in, the densities out."""
    import torch

    from roma_torch.kernels import kde as kk

    def f64(x, tile=1024):
        x = x.double()
        return torch.cat([torch.exp(-((x[i:i + tile, None] - x[None]) ** 2).sum(-1) / 0.02)
                          .sum(-1) for i in range(0, x.shape[0], tile)])

    vs_plain = {}

    def rel_err(x, what):
        got = kk.op(x, 0.1, 2048)
        again = kk.op(x, 0.1, 2048)
        ref = f64(x)
        plain = kk.kde_plain(x, 0.1)
        torch.cuda.synchronize()
        fail_if(not torch.equal(got, again), f"kde {what}: two runs differ")
        err = ((got.double() - ref).abs() / ref).max().item()
        fail_if(not math.isfinite(err) or err > KDE_TOL, f"kde {what}: max_rel_err {err}")
        vs_plain[what] = ((got - plain).abs() / plain).max().item()
        return err

    ragged = {f"{kind} {n}": rel_err(x, f"{kind} N={n}")
              for n in (1, 5, 127, 2049)
              for kind, x in (("warp", kde_pool(n, gen, dev)),
                              ("uniform", torch.rand((n, 4), generator=gen, device=dev) * 2 - 1))}
    rows = []
    for label, n, calls in (("full RoMa pool", 40000, PAIRS), ("Tiny RoMa pool", 20000, 0)):
        x = kde_pool(n, gen, dev)
        u = torch.rand((n, 4), generator=gen, device=dev) * 2 - 1
        err = {"warp": rel_err(x, f"{label} warp"), "uniform": rel_err(u, f"{label} uniform")}
        b_ms, b_by = bound(n * 16.0 + n * 4.0, 0.0, float(n) * n)
        rounds = cuda_ms_rounds(lambda: kk.op(x, 0.1, 2048), 20)
        rows.append(dict(shape=label, dims=[n, 4], calls=calls, splits=kk.splits(n),
                         max_abs_err=max(*err.values(), *ragged.values()), tol=f"{KDE_TOL:.0e} relative",
                         err=err, ragged=ragged, vs_plain=vs_plain, ms=median(rounds), ms_rounds=rounds,
                         plain_ms=cuda_ms(lambda: kk.kde_plain(x, 0.1), 3, 1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
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
    its lse, and the launch's blocks per SM and waves are read
    (`time_attention_bwd`)."""
    import ctypes

    import torch

    from roma_torch.kernels import attention as at

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
    t = time_attention_bwd(*main[torch.bfloat16])
    B, N, H, d = main[torch.bfloat16][0].shape
    worst = lambda name: max(c[name]["max_abs_err"] for c in cases if "bfloat16" in c["dtype"])
    rows = {}
    for name, errs in (("flash_attn_dkv", ("dk", "dv")), ("flash_attn_dq", ("dq",))):
        b_ms, b_by = t["bound"][name]
        rows[name] = [dict(shape="decoder train", dims=[B, N, H, d], calls=cfg.num_decoder_blocks,
                           max_abs_err=max(worst(e) for e in errs),
                           tol="2^-7 |plain| + 8e-3 max|plain|",
                           ms=median(t[name]), ms_rounds=t[name], plain_ms=t["plain_ms"],
                           library_ms=median(t["sdpa_ms"]), library_ms_rounds=t["sdpa_ms"],
                           library_events_ms_rounds=t["sdpa_events_ms"],
                           bound_ms=b_ms, bound_by=b_by, grid=t["grid"][name])]
    return dict(rows=rows, cases=cases, planted=planted_rows, whole_ms=median(t["whole_ms"]),
                whole_ms_rounds=t["whole_ms"], whole_graph_ms=median(t["whole_graph_ms"]),
                di_graph_ms=median(t["di_graph_ms"]), sdpa_ms=median(t["sdpa_ms"]),
                sdpa_events_ms=median(t["sdpa_events_ms"]), grid=t["grid"],
                fwd_ms=median(t["fwd_ms"]), fwd_lse_ms=median(t["fwd_lse_ms"]),
                fwd_ms_rounds=t["fwd_ms"], fwd_lse_ms_rounds=t["fwd_lse_ms"])


def time_attention_bwd(q, k, v, dout) -> dict:
    """At q's (B, N, H, d), bf16: K8 and K9 each alone through their C
    entries (no di, no allocation, no host work between launches beyond the
    ctypes call), the whole `attention_bwd_cuda` call (di + K8 + K9) by
    CUDA events and on the device alone (CUDA-graph replay, and the plain
    di's share of it), the plain version, SDPA's whole backward (its device
    time by the profiler, with its kernels per round, and by CUDA events),
    the whole call on the profiler's clock too, K3's forward with and
    without its lse, the launch's blocks per SM and waves, and each
    backward kernel's bound. Times in ms, five rounds each (sorted)."""
    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import attention as at
    from roma_torch.kernels import runtime

    o, lse = at.attention_cuda(q, k, v, with_lse=True)
    B, N, H, d = q.shape
    lib_main, di = runtime.load(at.BWD_NAME), at.attention_di(o, dout)
    outs = tuple(torch.empty_like(q) for _ in range(3))
    t = dict(dims=[B, N, H, d])
    t["flash_attn_dkv"] = cuda_ms_rounds(
        lambda: bwd_lib_call(lib_main, q, k, v, dout, lse, di, 0, ("dkv",), outs), 20)
    t["flash_attn_dq"] = cuda_ms_rounds(
        lambda: bwd_lib_call(lib_main, q, k, v, dout, lse, di, 0, ("dq",), outs), 20)
    t["whole_ms"] = cuda_ms_rounds(lambda: at.attention_bwd_cuda(q, k, v, o, lse, dout), 20)
    t["whole_graph_ms"] = graph_ms_rounds(lambda: at.attention_bwd_cuda(q, k, v, o, lse, dout), 20)
    t["di_graph_ms"] = graph_ms_rounds(lambda: at.attention_di(o, dout), 20)
    t["grid"] = bwd_grid(lib_main, B, N, H, d, 0)
    t["plain_ms"] = cuda_ms(lambda: at.attention_bwd_plain(q, k, v, o, lse, dout), 3, 1)
    leaves = [x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    dout_t = dout.transpose(1, 2)
    sdpa_call = lambda: torch.autograd.grad(sdpa_out, leaves, dout_t, retain_graph=True)
    # SDPA's autograd call can take longer on the host than on the device
    # (on an H100 80GB HBM3, CUDA events read 0.16-0.31 ms where its device time was ~0.145):
    # its device time is the yardstick, its events reading is kept beside it
    t["sdpa_events_ms"] = cuda_ms_rounds(sdpa_call, 20)
    t["sdpa_kernels_ms"] = [{} for _ in range(3)]  # which kernels SDPA's backward ran
    t["sdpa_ms"] = sorted(profiled_device_ms(sdpa_call, by_kernel=r) for r in t["sdpa_kernels_ms"])
    # the whole call on the profiler's clock too, the one SDPA is read on
    t["whole_kernels_ms"] = [{} for _ in range(3)]
    t["whole_profiled_ms"] = sorted(
        profiled_device_ms(lambda: at.attention_bwd_cuda(q, k, v, o, lse, dout), by_kernel=r)
        for r in t["whole_kernels_ms"])
    t["fwd_ms"] = cuda_ms_rounds(lambda: at.attention_cuda(q, k, v), 20)
    t["fwd_lse_ms"] = cuda_ms_rounds(lambda: at.attention_cuda(q, k, v, with_lse=True), 20)
    gemm = 2.0 * B * H * N * N * d
    exps = float(B * H * N * N)
    elem = B * N * H * d * 2
    side = 2 * B * H * N * 4  # lse and di
    t["bound"] = {name: bound((4 + n_out) * elem + side, n_gemm * gemm, exps)
                  for name, n_gemm, n_out in (("flash_attn_dkv", 4, 2), ("flash_attn_dq", 3, 1))}
    return t


# ---------------------------------------------------------------- training

def synthetic_depth_batch(gen, dev, B: int, hw: tuple[int, int]) -> dict:
    """One batch of the dataset contract from a seeded generator, the images
    and depths made on the device: uniform images, depth 2 +- 0.3 with the
    top eighth missing,
    a 0.05 rad yaw and 5 cm baseline, focal 1.4 x the width."""
    import torch

    h, w = hw
    f = 1.4 * w
    K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    a = 0.05
    T = torch.eye(4)
    T[0, 0], T[0, 2], T[2, 0], T[2, 2] = math.cos(a), math.sin(a), -math.sin(a), math.cos(a)
    T[0, 3] = 0.05
    # made on the host, copied without a stream sync
    K, T = (t.to(dev, non_blocking=True) for t in (K, T))
    K = K.expand(B, 3, 3)

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
    from roma_torch.losses.robust_loss import robust_loss
    from roma_torch.models.zoo import build_model
    from roma_torch.train.train import make_roma_train_state, make_train_step

    cfg = RomaConfig()
    state = make_roma_train_state(TrainConfig(batch_size=TRAIN_BATCH), model=build_model(cfg, SEED),
                                  device=dev)
    model = state.model
    step = make_train_step(robust_loss)
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


def profile_train_step(step, state, batch, out_dir: Path, prefix: str = "roma.",
                       table: str = "profile_train.txt") -> dict:
    """torch.profiler over one training step: wall time, device busy time
    and share, the forward's labelled stages (`prefix` ranges, `roma.*` or
    `tiny.*`: device span of the forward's kernels; the backward and a
    checkpoint's recompute run outside them), the top kernels by device
    time (table in out_dir/`table`)."""
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
    ranges = (prefix, "Optimizer.")  # labelled ranges, not kernels
    stages = {e.key: dev_total(e) / 1e3 for e in events if e.key.startswith(ranges)}
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(ranges)]
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_self, reverse=True)[:25]
    (out_dir / table).write_text(
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
    from roma_torch.losses.robust_loss import robust_loss
    from roma_torch.models.zoo import build_model, debug_roma_config
    from roma_torch.train.grad_parity import grad_mismatches
    from roma_torch.train.train import make_roma_train_state, make_train_step

    cfg = dataclasses.replace(debug_roma_config(), dtype="float32")
    g = torch.Generator().manual_seed(SEED)
    batch = synthetic_depth_batch(g, "cpu", 1, cfg.coarse_resolution)
    step = make_train_step(robust_loss)
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


# ---------------------------------------------------------------- ViT-L SwiGLU training

# DINOv2's ViT-L/14 with the block options the matcher does not take:
# SwiGLU FFN (hidden 2736), stochastic depth 0.1, then the final LayerNorm
# and the DINO head at DINOv2's published widths on the CLS tokens; the
# input is DINOv2's training tokens at 560^2 for 2 pairs (A over B), bf16
VIT = dict(dim=1024, heads=16, depth=24, mlp_ratio=4.0, drop_path_rate=0.1)
VIT_TOKENS = (2 * PAIRS, 1601, 1024)
DINO_HEAD = dict(out_dim=65536, hidden_dim=2048, bottleneck_dim=256, nlayers=3)
VIT_WARMUP = 2  # after one, the next step still read up to twice the later ones
VIT_STEPS = 3
VIT_LR = 1e-4
VIT_PARITY_BLOCKS = 2
RESIZE_CHECK = ((2, 864, 864, 3), (560, 560))
RESIZE_TOL = 1e-5  # of max|plain|: the same float32 products in another order


@contextlib.contextmanager
def sm_clock_samples():
    """Yields a list that holds, once the block ends, the SM clock (MHz)
    nvidia-smi read every 20 ms while the block ran."""
    clocks: list[int] = []
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "20"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        first = proc.stdout.readline().strip()  # nvidia-smi is sampling from here
        clocks += [int(first)] if first.isdigit() else []
        yield clocks
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        clocks += [int(x) for x in out.split() if x.isdigit()]


def vit_swiglu_blocks(dtype, drop_path_rate: float, depth: int):
    """`depth` ViT-L/14 blocks with layer scale, qkv bias and the SwiGLU FFN."""
    import torch

    from roma_torch.models.transformer import Block

    return torch.nn.ModuleList(
        Block(VIT["dim"], VIT["heads"], VIT["mlp_ratio"], layer_scale=True, qkv_bias=True,
              dtype=dtype, ffn_layer="swiglu", drop_path_rate=drop_path_rate)
        for _ in range(depth))


def dino_loss(logits):
    """DINO's cross-entropy between the two views of each pair: the
    student's log-softmax at temperature 0.1 against the other view's
    softmax at 0.04, detached, in both directions."""
    import torch.nn.functional as F

    B = logits.shape[0] // 2

    def ce(student, teacher):
        t = F.softmax(teacher.detach() / 0.04, dim=-1)
        return -(t * F.log_softmax(student / 0.1, dim=-1)).sum(-1).mean()

    return 0.5 * (ce(logits[:B], logits[B:]) + ce(logits[B:], logits[:B]))


def run_vit_swiglu(dev, gen, card: str, profile_dir: Path | None = None) -> dict:
    """The ViT-L/14 SwiGLU stack (`VIT`: 24 blocks, 16 heads of 64, bf16,
    drop_path 0.1 from a seeded generator on the card), the final
    LayerNorm and `DINO_HEAD` on the CLS tokens of (4, 1601, 1024) tokens,
    trained with the port's AdamW on `dino_loss`: `VIT_WARMUP` steps, then
    `VIT_STEPS` timed, the launch counters reset just before the first and
    read just after it (K3 24 with lse, K8 24, K9 24; every other kernel
    0). Each step's drop_path masks are recorded as drawn (2 x 24 x 4 a
    step); their kept share must lie within 5 binomial standard deviations
    of 0.9. Finite loss and gradients. Each timed step's seconds and its
    readings (`step_readings`), their median, the memory allocated when
    the phase starts and the peak above it (with `profile_dir`, one more
    step under torch.profiler). Then
    `check_vit_parity`, `check_resize_antialias` and K8/K9 timed at this
    shape beside SDPA's whole backward (`time_attention_bwd`)."""
    import torch

    from roma_torch.config import TrainConfig
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.models import transformer
    from roma_torch.models.layers import flax_init_, layer_norm
    from roma_torch.train.train import make_optimizer

    start_mem = torch.cuda.memory_allocated()
    with torch.random.fork_rng(devices=[dev]), torch.device(dev):
        torch.manual_seed(SEED)
        blocks = flax_init_(vit_swiglu_blocks(torch.bfloat16, VIT["drop_path_rate"], VIT["depth"]))
        norm = torch.nn.LayerNorm(VIT["dim"], eps=1e-6)
        head = transformer.DINOHead(VIT["dim"], **DINO_HEAD)
    model = torch.nn.ModuleList([blocks, norm, head]).train()
    params = list(model.parameters())
    opt = make_optimizer(TrainConfig(), VIT_LR, params)
    drop_gen = torch.Generator(device=dev).manual_seed(SEED)

    def step(tokens, marks: dict | None = None):
        t0 = time.perf_counter()
        x = tokens
        for blk in blocks:
            x = blk(x, generator=drop_gen)
        loss = dino_loss(head(layer_norm(norm, x)[:, 0]))
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        t2 = time.perf_counter()
        opt.step()
        if marks is not None:  # the host's time to enqueue each part
            marks.update(forward_s=t1 - t0, backward_s=t2 - t1, optimizer_s=time.perf_counter() - t2)
        return loss.detach()

    def timed(tokens):
        """One step ending in a synchronize: its loss and readings (seconds,
        host enqueue time and its parts, device span by CUDA events, new
        cudaMalloc segments)."""
        reading = {}
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        loss = step(tokens, reading)
        ev[1].record()
        reading["enqueue_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        reading["s"] = time.perf_counter() - t0
        reading.update(device_span_ms=ev[0].elapsed_time(ev[1]), new_segments=torch.cuda.memory_stats()
                       .get("segment.all.allocated", 0) - segments)
        return loss, reading

    batches = [torch.randn(VIT_TOKENS, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(VIT_WARMUP + VIT_STEPS)]
    warmup = [timed(tokens)[1] for tokens in batches[:VIT_WARMUP]]
    warmup_s = [r["s"] for r in warmup]
    torch.cuda.reset_peak_memory_stats()
    draw_mask = transformer.drop_path_mask
    times, readings, losses, kept, finite = [], [], [], [], []
    with sm_clock_samples() as clocks:
        for i, tokens in enumerate(batches[VIT_WARMUP:]):
            masks = []

            def recorded(x, rate, generator, masks=masks):
                m = draw_mask(x, rate, generator)
                masks.append(m)
                return m

            transformer.drop_path_mask = recorded
            try:
                if i == 0:
                    reset_launches()
                loss, reading = timed(tokens)
                if i == 0:
                    launches = dict(LAUNCHES)
            finally:
                transformer.drop_path_mask = draw_mask
            times.append(reading["s"])
            readings.append(reading)
            draws = torch.cat([m.flatten() for m in masks])
            kept.append(dict(draws=draws.numel(), kept=int(draws.sum())))
            losses.append(loss.item())
            finite.append(bool(torch.stack([p.grad.isfinite().all() for p in params]).all()))
    n_params = sum(p.numel() for p in params)
    res = dict(warmup_s=warmup_s, warmup_readings=warmup, step_s=times, median_step_s=median(sorted(times)),
               step_readings=readings, sm_clock_mhz=clocks, start_mem_gb=start_mem / 1e9,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_above_start_gb=(torch.cuda.max_memory_allocated() - start_mem) / 1e9,
               launches=launches, losses=losses, drop_path=kept, params=n_params)
    expected = {name: 0 for name in KERNELS}
    expected.update(flash_attn=VIT["depth"], flash_attn_dkv=VIT["depth"], flash_attn_dq=VIT["depth"])
    res["expected_launches"] = expected
    keep = 1.0 - VIT["drop_path_rate"]
    n_draws = 2 * VIT["depth"] * VIT_TOKENS[0]
    band = 5.0 * math.sqrt(keep * (1 - keep) / n_draws)
    print(f"[{card}] ViT-L/14 SwiGLU stack ({VIT['depth']} blocks, dim {VIT['dim']}, "
          f"{VIT['heads']} heads of {VIT['dim'] // VIT['heads']}, hidden "
          f"{blocks[0].mlp.w3.in_features}, drop_path {VIT['drop_path_rate']}, bf16) + DINO head "
          f"({DINO_HEAD['out_dim']}) on {VIT_TOKENS}, {n_params} parameters, AdamW: warm-up "
          f"{', '.join(f'{t:.4f}' for t in warmup_s)} s, then {', '.join(f'{t:.4f}' for t in times)} "
          f"s (median {res['median_step_s']:.4f}); peak {res['peak_mem_gb']:.2f} GB "
          f"({res['peak_above_start_gb']:.2f} above the {res['start_mem_gb']:.2f} allocated at "
          f"the start); launches a step {launches}", flush=True)
    print(f"[{card}] ViT-L SwiGLU warm-up steps: {json.dumps(warmup)}", flush=True)
    print(f"[{card}] ViT-L SwiGLU timed steps: {json.dumps(readings)}; SM clock "
          f"{min(clocks, default=0)}-{max(clocks, default=0)} MHz (median "
          f"{median(sorted(clocks)) if clocks else 0}, {len(clocks)} nvidia-smi samples)", flush=True)
    print(f"[{card}] ViT-L SwiGLU drop_path kept per step "
          f"{[k['kept'] for k in kept]} of {n_draws} (band {keep} +- {band:.4f}); "
          f"loss {losses}", flush=True)
    for name, n in expected.items():
        fail_if(launches[name] != n, f"ViT-L SwiGLU step: {name}: {launches[name]} launches, "
                                     f"expected {n}")
    for k in kept:
        fail_if(k["draws"] != n_draws, f"ViT-L SwiGLU step: {k['draws']} drop_path draws, "
                                       f"expected {n_draws}")
        fail_if(abs(k["kept"] / k["draws"] - keep) > band,
                f"ViT-L SwiGLU step: kept share {k['kept'] / k['draws']:.4f} outside "
                f"{keep} +- {band:.4f}")
    fail_if(not all(math.isfinite(x) for x in losses), f"ViT-L SwiGLU step: loss {losses}")
    fail_if(not all(finite), "ViT-L SwiGLU step: non-finite gradients")
    if profile_dir is not None:
        res["profile"] = profile_train_step(lambda _, tokens: step(tokens), None, batches[1],
                                            profile_dir, "vit.", "profile_vit_swiglu.txt")
        print(f"[{card}] ViT-L SwiGLU profile: {json.dumps(res['profile'])}", flush=True)

    res["parity"] = check_vit_parity(blocks, dev, gen, card)
    del model, blocks, norm, head, opt, params, batches
    torch.cuda.empty_cache()
    res["resize"] = check_resize_antialias(dev, gen, card)

    # K8 and K9 alone at this shape, beside SDPA's whole backward
    B, N, D = VIT_TOKENS
    H = VIT["heads"]
    qkv = torch.randn((B, N, 3, H, D // H), generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn((B, N, H, D // H), generator=gen, device=dev).to(torch.bfloat16)
    t = time_attention_bwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dout)
    res["attention_bwd"] = t
    print(f"[{card}] flash_attn bwd at {t['dims']} bf16: K8 {median(t['flash_attn_dkv']):.4f} ms "
          f"(bound {t['bound']['flash_attn_dkv'][0]:.4f}, {t['bound']['flash_attn_dkv'][1]}), "
          f"K9 {median(t['flash_attn_dq']):.4f} ms (bound {t['bound']['flash_attn_dq'][0]:.4f}, "
          f"{t['bound']['flash_attn_dq'][1]}); the whole attention_bwd_cuda call "
          f"{median(t['whole_ms']):.4f} ms ({median(t['whole_graph_ms']):.4f} by graph replay, di "
          f"{median(t['di_graph_ms']):.4f}); SDPA's whole backward {median(t['sdpa_ms']):.4f} ms "
          f"on the device ({median(t['sdpa_events_ms']):.4f} by CUDA events); plain "
          f"{t['plain_ms']:.3f} ms; K3 {median(t['fwd_ms']):.4f} ms, with lse "
          f"{median(t['fwd_lse_ms']):.4f}; launches {json.dumps(t['grid'])}", flush=True)
    print(f"[{card}] on the profiler's clock at {t['dims']}: SDPA's backward {t['sdpa_ms']} ms, "
          f"the whole attention_bwd_cuda call {t['whole_profiled_ms']} ms; their kernels (ms a "
          f"call, each round): SDPA {json.dumps(t['sdpa_kernels_ms'])}; ours "
          f"{json.dumps(t['whole_kernels_ms'])}", flush=True)
    return res


def check_vit_parity(blocks, dev, gen, card: str) -> dict:
    """A float32 copy of the stack's first `VIT_PARITY_BLOCKS` blocks (the
    same weights, drop_path off, train mode) on (1, 1601, 1024) tokens, on
    the card (K3's float32 entry with lse, K8, K9: 2 launches each) and on
    the CPU (plain versions): the output within GRAD_TOL * max|CPU|, and
    every parameter's gradient of sum(y * w), and the input's, under
    `roma_torch.train.grad_parity` (GRAD_TOL * max|g| per tensor; no tensor
    here sits behind a BatchNorm or a ReLU kink) and within a relative L2
    error of GRAD_TOL."""
    import torch

    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.train.grad_parity import GRAD_TOL, grad_mismatches

    x = torch.randn((1,) + VIT_TOKENS[1:], generator=gen, device=dev)
    w = torch.randn(x.shape, generator=gen, device=dev)
    states = [{k: v.detach().cpu() for k, v in blk.state_dict().items()}
              for blk in blocks[:VIT_PARITY_BLOCKS]]
    out, grads = {}, {}
    for where in ("cpu", dev):
        m = vit_swiglu_blocks(torch.float32, 0.0, VIT_PARITY_BLOCKS)
        for blk, sd in zip(m, states):
            blk.load_state_dict(sd)
        m = m.to(where).train()
        xx = x.to(where).requires_grad_()
        reset_launches()
        y = xx
        for blk in m:
            y = blk(y)
        (y * w.to(where)).sum().backward()
        if where != "cpu":
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        out[str(where)] = y.detach().cpu()
        grads[str(where)] = {n: p.grad.cpu() for n, p in m.named_parameters()}
        grads[str(where)]["input"] = xx.grad.cpu()
    cpu, gpu = out["cpu"], out[str(dev)]
    rel_l2 = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    fwd = dict(max_abs_over_max=((gpu - cpu).abs().max() / cpu.abs().max()).item(),
               rel_l2=rel_l2(gpu, cpu))
    bad, worst = grad_mismatches(m, grads[str(dev)], grads["cpu"], named={})
    l2 = {n: rel_l2(grads[str(dev)][n], r) for n, r in grads["cpu"].items()}
    bad += [f"{n}: relative L2 {e:.3g} > {GRAD_TOL}" for n, e in l2.items() if e > GRAD_TOL]
    res = dict(forward=fwd, grads=worst, grad_rel_l2_max=max(l2.values()), launches=launches)
    print(f"[{card}] ViT-L SwiGLU {VIT_PARITY_BLOCKS} blocks float32 GPU vs CPU: "
          + json.dumps(res), flush=True)
    for name in ("flash_attn", "flash_attn_dkv", "flash_attn_dq"):
        fail_if(launches[name] != VIT_PARITY_BLOCKS,
                f"ViT-L parity: {name} {launches[name]} launches, expected {VIT_PARITY_BLOCKS}")
    fail_if(fwd["max_abs_over_max"] > GRAD_TOL or fwd["rel_l2"] > GRAD_TOL,
            f"ViT-L parity forward: {fwd}")
    fail_if(bool(bad), f"ViT-L parity gradients: {bad[:8]}")
    return res


def check_resize_antialias(dev, gen, card: str) -> dict:
    """`resize_bicubic(antialias=False)` (the JAX package's unwidened Keys
    cubic as two interpolation matrices) of a float32 image batch on the
    card against the CPU, within RESIZE_TOL of max|CPU|."""
    import torch

    from roma_torch.ops.resize import resize_bicubic

    shape, size = RESIZE_CHECK
    img = torch.rand(shape, generator=gen, device=dev)
    got = resize_bicubic(img, size, antialias=False)
    ms = cuda_ms(lambda: resize_bicubic(img, size, antialias=False), 10)
    ref = resize_bicubic(img.cpu(), size, antialias=False)
    fail_if(tuple(got.shape) != (shape[0], *size, shape[-1]), f"resize: shape {tuple(got.shape)}")
    err = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
    res = dict(shape=list(shape), size=list(size), max_abs_over_max=err, tol=RESIZE_TOL, ms=ms)
    print(f"[{card}] resize_bicubic(antialias=False) {shape} -> {size} GPU vs CPU: "
          + json.dumps(res), flush=True)
    fail_if(not err <= RESIZE_TOL, f"resize_bicubic(antialias=False): {err:.3e} of max|CPU|")
    return res


# the Tiny training phase: the Tiny training CLI's defaults (resolution
# "big", 768x1024, batch 8), 1 warm-up, 1 counted and 3 timed steps
TINY_TRAIN_BATCH = 8
TINY_TRAIN_STEPS = 3


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class KeepMetrics:
    """A `train_k_steps` logger that keeps each step's metrics as tensors:
    no host read while the steps run."""

    def __init__(self):
        self.rows: list[dict] = []

    def log(self, step: int, metrics: dict) -> None:
        self.rows.append(metrics)


def record_sync(message, syncs: dict[str, int]) -> None:
    """Count a synchronizing call (sync debug mode "warn") by the innermost
    line of this repository on the stack that made it; other threads'
    calls (a loader's, an uploader's, a worker's) count too, marked with
    the thread's name."""
    import traceback

    if "called a synchronizing" not in str(message):
        return
    frames = [f for f in traceback.extract_stack()[:-2] if f.filename.startswith(str(ROOT))]
    where = (f"{Path(frames[-1].filename).relative_to(ROOT)}:{frames[-1].lineno}" if frames
             else "outside the repository")
    if threading.current_thread() is not threading.main_thread():
        where += f" ({threading.current_thread().name})"
    syncs[where] = syncs.get(where, 0) + 1


def synthetic_batches(gen, dev, B: int, hw: tuple[int, int]):
    while True:
        yield synthetic_depth_batch(gen, dev, B, hw)


def run_tiny_training(dev, gen, card: str, profile_dir: Path | None = None) -> dict:
    """Path C: Tiny RoMa training as its CLI composes it, at full width
    (`TinyRomaConfig()`: XFeat 64/24, matchers 256/64, bf16) and the CLI's
    defaults (768x1024, batch 8): `initialize_distributed` + `make_mesh` at
    world size 1 over NCCL, `make_tiny_train_state(trainable="all")`,
    `make_train_step(tiny_robust_loss, the CLI's LOSS_CFG, mesh=mesh)`, a
    `PairLoader` over synthetic depth batches, `train_k_steps`. One warm-up
    step; one counted step (launch counters reset just before it, every
    kernel must read 0: K7 is off in train mode, as in JAX) under
    `torch.cuda.set_sync_debug_mode("warn")`, whose synchronizing calls are
    reported; then 3 timed steps. Finite metrics with corr_volume_loss_8
    among them, every running statistic moved; samples/s and peak memory
    (with `profile_dir`, one more step under torch.profiler). Then one step
    through `mesh=` against the same step without it, from the same state
    and batch (`compare_mesh_step`), and a checkpoint save, reload and
    `replicate` as the CLI resumes (bit-equal model, optimizer and
    counters, each tensor on its device), then one step from it."""
    import os
    import tempfile
    import warnings

    import torch
    import torch.distributed as dist

    from roma_torch.config import TrainConfig
    from roma_torch.datasets.loader import PairLoader
    from roma_torch.experiments.train_tiny_roma_v1_outdoor import LOSS_CFG, RESOLUTIONS
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.losses.robust_loss import tiny_robust_loss
    from roma_torch.parallel.mesh import (global_batch_from_host_local, initialize_distributed,
                                          make_mesh, replicate)
    from roma_torch.train.checkpoint import CheckPoint
    from roma_torch.train.train import make_tiny_train_state, make_train_step, train_k_steps

    B, hw = TINY_TRAIN_BATCH, RESOLUTIONS["big"]
    cfg = TrainConfig(batch_size=B)
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    res: dict = {"batch": B, "hw": list(hw)}
    loader = None
    try:
        fail_if(initialize_distributed(dev) != (0, 1), "tiny train: not rank 0 of 1")
        backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
        fail_if(dist.get_backend() != backend, f"tiny train: backend {dist.get_backend()}")
        mesh = make_mesh(dev)
        state = replicate(make_tiny_train_state(cfg, trainable="all", seed=SEED, device=dev), mesh)
        step = make_train_step(tiny_robust_loss, LOSS_CFG, mesh=mesh)
        stats0 = {k: t.clone() for k, t in state.model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))}
        loader = PairLoader(synthetic_batches(gen, dev, B, hw), prefetch=2, num_threads=2)
        put = lambda b: global_batch_from_host_local(b, mesh)  # noqa: E731
        log = KeepMetrics()
        t0 = time.perf_counter()
        state = train_k_steps(state, loader, step, 1, log, put)
        torch.cuda.synchronize()
        res["first_step_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        syncs: dict[str, int] = {}
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = lambda message, *a, **k: record_sync(message, syncs)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                state = train_k_steps(state, loader, step, 1, log, put)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            res["counted_step_s"] = time.perf_counter() - t0
        res["launches"] = launches = dict(LAUNCHES)
        res["syncs_in_a_step"] = syncs
        times = []
        for _ in range(TINY_TRAIN_STEPS):
            t0 = time.perf_counter()
            state = train_k_steps(state, loader, step, 1, log, put)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res.update(step_s=times, samples_per_s=B * len(times) / sum(times),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, samples=state.step)
        metrics = [{k: float(v) for k, v in m.items()} for m in log.rows]
        res["metrics"] = metrics[-1]
        print(f"[{card}] tiny train step at {hw[0]}x{hw[1]}, batch {B}, bf16, mesh of 1 over "
              f"{backend}: first {res['first_step_s']:.3f} s, counted {res['counted_step_s']:.4f} s, "
              f"then {', '.join(f'{t:.4f}' for t in times)} s; {res['samples_per_s']:.3f} "
              f"samples/s; peak {res['peak_mem_gb']:.2f} GB; launches a step {launches}",
              flush=True)
        print(f"[{card}] tiny train synchronizing calls in one step (sync debug mode warn): "
              f"{json.dumps(syncs)}", flush=True)
        print(f"[{card}] tiny train metrics: {json.dumps(metrics[-1])}", flush=True)
        for name, n in launches.items():
            fail_if(n != 0, f"tiny train step: {name} launched {n} times")
        for m in metrics:
            bad = [k for k, v in m.items() if not math.isfinite(v)]
            fail_if(bool(bad), f"tiny train step: non-finite metrics {bad}")
            fail_if("corr_volume_loss_8" not in m, "tiny train step: no corr_volume_loss_8")
        sd = state.model.state_dict()
        still = [k for k in stats0 if torch.equal(stats0[k], sd[k])]
        fail_if(bool(still), f"tiny train step: running statistics not moved: {still[:5]}")
        res["bn_statistics_moved"] = len(stats0)
        if profile_dir is not None:
            res["profile"] = profile_train_step(step, state, put(next(loader)), profile_dir,
                                                "tiny.", "profile_tiny_train.txt")
            print(f"[{card}] tiny train profile: {json.dumps(res['profile'])}", flush=True)
        loader.close()
        loader = None
        torch.cuda.empty_cache()

        res["mesh_vs_plain"] = compare_mesh_step(dev, cfg, hw, mesh, LOSS_CFG, card)

        with tempfile.TemporaryDirectory() as d:
            # as the CLI resumes: load, then replicate over the mesh (AdamW's
            # step counts stay on the host, and go through a device copy)
            ck = CheckPoint(d, "tiny_roma_v1_outdoor")
            ck.save(state)
            fresh = replicate(ck.load(make_tiny_train_state(cfg, seed=SEED + 1, device=dev)), mesh)
            a, b = state.model.state_dict(), fresh.model.state_dict()
            opt_a, opt_b = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
            same = (all(torch.equal(a[k], b[k]) for k in a) and fresh.step == state.step
                    and fresh.updates == state.updates and opt_a.keys() == opt_b.keys()
                    and all(opt_a[i][k].device == opt_b[i][k].device
                            and torch.equal(opt_a[i][k], opt_b[i][k])
                            for i in opt_a for k in opt_a[i]))
            fail_if(not same, "tiny train: checkpoint reload and replicate differ")
            del state
            fresh, met = step(fresh, put(synthetic_depth_batch(gen, dev, B, hw)))
            bad = [k for k, v in met.items() if not math.isfinite(float(v))]
            fail_if(bool(bad), f"tiny train: the step after the resume: non-finite {bad}")
            res["checkpoint_round_trip"] = "bit-equal through replicate, then a step"
    finally:
        if loader is not None:
            loader.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.empty_cache()
    return res


def compare_mesh_step(dev, cfg, hw, mesh, loss_cfg, card: str) -> dict:
    """One Tiny training step through `mesh=` (world size 1, where every
    all-reduce is the identity) against the same step without it, each from
    a fresh state of the same seed on the same batch, in turns, in bf16
    (the CLI's dtype) and in float32:

    - the loss, its terms and the running statistics of the mesh step
      within 1e-5 of the plain step's (relative; a mean of its channels'
      largest standard deviation), in both dtypes;
    - the gradients before the clip in float32, under `grad_parity`'s rule
      with no tensor named (GRAD_TOL of max|g|; the biases before a
      training BatchNorm exact zeros), and `grad_norm` within GRAD_TOL.

    The gradients are held in float32 only: the backward is not
    deterministic (atomic adds in grid_sample's and the resizes' backward),
    and in bf16 the roundings after those sums move a gradient by up to a
    fifth of its max|g| between two runs of the plain step on an H100, a
    quantized noise that no fixed bound separates from a fault. In float32
    the forward is the same on both sides, so no ReLU or loss gate flips,
    and the reordered sums move a gradient by float32 roundings only.
    Reports whether each agrees bit for bit, and the worst readings."""
    import dataclasses

    import torch

    from roma_torch.config import TinyRomaConfig
    from roma_torch.losses.robust_loss import tiny_robust_loss
    from roma_torch.models.zoo import build_model
    from roma_torch.train.grad_parity import GRAD_TOL, grad_mismatches
    from roma_torch.train.train import make_tiny_train_state, make_train_step

    batch = synthetic_depth_batch(torch.Generator(device=dev).manual_seed(SEED + 1), dev,
                                  cfg.batch_size, hw)

    def one(m, dtype):
        model = build_model(dataclasses.replace(TinyRomaConfig(), dtype=dtype), SEED)
        st = make_tiny_train_state(cfg, model=model, device=dev)
        st, met = make_train_step(tiny_robust_loss, loss_cfg, mesh=m)(st, batch)
        scale = max(float(met["grad_norm"]), cfg.grad_clip) / cfg.grad_clip
        return ({k: float(v) for k, v in met.items()},
                {n: p.grad.float() * scale for n, p in st.model.named_parameters()},
                {k: v.clone() for k, v in st.model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}, st.model)

    res: dict = {}
    for dtype in ("bfloat16", "float32"):
        (pm, pg, ps, model), (mm, mg, ms, _) = one(None, dtype), one(mesh, dtype)
        forward = max(abs(mm[k] - v) / max(abs(v), 1e-30) for k, v in pm.items()
                      if k != "grad_norm")

        def scale(k):
            var = ps[k.rsplit(".", 1)[0] + ".running_var"]
            return var.sqrt().max() if k.endswith("mean") else var.abs().max()

        stat_rel = max(((ms[k] - v).abs().max() / scale(k)).item() for k, v in ps.items())
        r = res[dtype] = dict(
            metric_rel=forward, stat_rel=stat_rel,
            bit_equal_metrics=all(mm[k] == v for k, v in pm.items() if k != "grad_norm"),
            bit_equal_stats=all(torch.equal(ms[k], v) for k, v in ps.items()),
            bit_equal_grads=all(torch.equal(mg[k], v) for k, v in pg.items()),
            grad_norms=[pm["grad_norm"], mm["grad_norm"]])
        bad = []
        if dtype == "float32":
            bad, worst = grad_mismatches(model, mg, pg, named={})
            rel = {n: ((mg[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                   for n, g in pg.items()}
            r.update(grad_norm_rel=abs(mm["grad_norm"] - pm["grad_norm"]) / pm["grad_norm"],
                     grad_readings=worst,
                     worst_grads_over_max=dict(sorted(rel.items(), key=lambda kv: -kv[1])[:5]))
        print(f"[{card}] tiny train step through mesh= vs without, {dtype}: {json.dumps(r)}",
              flush=True)
        fail_if(forward > 1e-5, f"tiny train mesh vs plain, {dtype}: metrics rel {forward}")
        fail_if(stat_rel > 1e-5, f"tiny train mesh vs plain, {dtype}: statistics {stat_rel}")
        fail_if(bool(bad), f"tiny train mesh vs plain, {dtype}: gradients {bad[:8]}")
        fail_if(r.get("grad_norm_rel", 0.0) > GRAD_TOL,
                f"tiny train mesh vs plain, {dtype}: grad_norm {r['grad_norms']}")
        del model, pg, mg
        torch.cuda.empty_cache()
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


# ---------------------------------------------------------------------------
# the evaluation path: a rendered two-plane world, the harness engine on the
# card, full-width RoMa through Mega-1500, train -> eval
# ---------------------------------------------------------------------------

PLANE_Z = (4.0, 6.0)       # near plane (world x < 0), far plane (x >= 0)
WORLD_HW = (96, 128)       # tests/test_train_to_eval.py's image size and focal
WORLD_FX = 130.0
EVAL_SIZES = ((480, 640), (600, 800))  # two source sizes, alternating on the ring
EVAL_CAMS = range(-4, 5)   # ring cameras that see both planes (10-90% near); 8 pairs
EVAL_BATCH = 2
EVAL_SAMPLES = 5000
EVAL_RUNS = 5
T2E_STEPS = 600            # tests/test_train_to_eval.py's settings
T2E_CAMS = 5


def smooth_texture(rng, n: int = 384):
    import numpy as np

    t = rng.uniform(0, 1, (n, n, 3)).astype(np.float32)
    for _ in range(2):
        for ax in (0, 1):
            t = 0.5 * t + 0.25 * (np.roll(t, 1, ax) + np.roll(t, -1, ax))
    return (t - t.min()) / (t.max() - t.min())


def ring_pose(i: int):
    """World-to-camera pose of camera i on the ring: 2 degrees of yaw and
    (0.25, 0.02, 0) of translation a step."""
    import numpy as np

    a = np.deg2rad(2.0 * i)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = [0.25 * i, 0.02 * i, 0.0]
    return T


def world_K(hw: tuple[int, int]):
    """The intrinsics of an image of size hw: the world's focal scaled with
    the width, the principal point at the center."""
    import numpy as np

    h, w = hw
    f = WORLD_FX * w / WORLD_HW[1]
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])


def _sample_texture(tex, u, v):
    import numpy as np

    n = tex.shape[0]
    u = np.clip(u, 0, n - 1.001)
    v = np.clip(v, 0, n - 1.001)
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)


def surface_points(T, K, u, v):
    """The world points that the pixels (u, v) of camera (T, K) see: the
    near plane where it lies at world x < 0, else the far plane."""
    import numpy as np

    R, t = T[:3, :3], T[:3, 3]
    c = -R.T @ t
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], -1)
    d = rays @ R
    near = c + d * ((PLANE_Z[0] - c[2]) / d[..., 2])[..., None]
    far = c + d * ((PLANE_Z[1] - c[2]) / d[..., 2])[..., None]
    use_near = near[..., 0] < 0
    return np.where(use_near[..., None], near, far), use_near


def render_two_plane(T, K, hw, tex_near, tex_far):
    """Image (H, W, 3) in [0, 1] and depth (H, W) of the two textured
    planes, by ray-plane intersection and bilinear texture lookup (the
    renderer of tests/test_train_to_eval.py at any size)."""
    import numpy as np

    h, w = hw
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5, indexing="xy")
    X, use_near = surface_points(T, K, u, v)
    img = np.zeros((h, w, 3), np.float32)
    S = 4.0  # world (x, y) in [-S, S] -> texture [0, n)
    for sel, tex in ((use_near, tex_near), (~use_near, tex_far)):
        n = tex.shape[0]
        uu = (X[..., 0] + S) / (2 * S) * (n - 1)
        vv = (X[..., 1] + S) / (2 * S) * (n - 1)
        img[sel] = _sample_texture(tex, uu[sel], vv[sel])
    depth = (X @ T[:3, :3].T + T[:3, 3])[..., 2].astype(np.float32)
    return img, depth


def write_two_plane_scene(root: Path, cams, sizes, seed: int = 3) -> dict:
    """Render the ring's cameras `cams` (camera cams[j] at sizes[j]) into
    root/images and write root/scene.npz in the MegaDepth layout, pairs
    (j, j + 1). Returns the images, depths, poses and intrinsics."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    tex_near, tex_far = smooth_texture(rng), smooth_texture(rng)
    (root / "images").mkdir(parents=True, exist_ok=True)
    world: dict[str, list] = {"imgs": [], "depths": [], "poses": [], "Ks": [], "paths": []}
    for j, (i, hw) in enumerate(zip(cams, sizes, strict=True)):
        T, K = ring_pose(i), world_K(hw)
        img, depth = render_two_plane(T, K, hw, tex_near, tex_far)
        path = f"images/r_{j}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(root / path)
        for key, val in zip(("imgs", "depths", "poses", "Ks", "paths"), (img, depth, T, K, path)):
            world[key].append(val)
    pairs = [(i, i + 1) for i in range(len(sizes) - 1)]
    np.savez(root / "scene.npz", pair_infos=np.array([[p, 0.5] for p in pairs], dtype=object),
             intrinsics=np.array(world["Ks"]), poses=np.array(world["poses"]),
             image_paths=np.array(world["paths"]))
    return world


def two_plane_warp(Ta, Tb, hw=WORLD_HW):
    """The exact one-sided warp from camera a to camera b on a grid of hw
    (normalized [x_A, y_A, x_B, y_B], (H, W, 4)) and its certainty (H, W):
    0.9 where the point lands inside B and B sees it (its depth there
    within 1% of the point's), else 0. Normalized coordinates do not depend
    on the image size (the intrinsics scale with it)."""
    import numpy as np

    h, w = hw
    K = world_K(hw)
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5, indexing="xy")
    X, _ = surface_points(Ta, K, u, v)
    Xb = X @ Tb[:3, :3].T + Tb[:3, 3]
    ub = K[0, 0] * Xb[..., 0] / Xb[..., 2] + K[0, 2]
    vb = K[1, 1] * Xb[..., 1] / Xb[..., 2] + K[1, 2]
    inside = (ub > 0) & (ub < w) & (vb > 0) & (vb < h)
    Xs, _ = surface_points(Tb, K, np.clip(ub, 0, w), np.clip(vb, 0, h))
    seen = np.abs((Xs @ Tb[:3, :3].T + Tb[:3, 3])[..., 2] - Xb[..., 2]) < 0.01 * Xb[..., 2]
    warp = np.stack([2 * u / w - 1, 2 * v / h - 1, 2 * ub / w - 1, 2 * vb / h - 1], -1)
    return warp.astype(np.float32), (0.9 * (inside & seen)).astype(np.float32)


class EngineOracle:
    """The exact two-plane warps through the harness's batched fast path:
    the device resize (`build_resize_banks`, `match_raw`), the balanced
    sampling (`sample_batched`) and the pixel conversion are RomaMatcher's
    own; `match_prepped` hands out the next pairs' exact warps, in the order
    the harness asks for them."""

    def __init__(self, warps, certs, dev):
        import torch

        from roma_torch.config import RomaConfig
        from roma_torch.models.matcher import RomaMatcher

        self.host_resize_np = RomaMatcher.host_resize_np
        self._prep_raw_impl = RomaMatcher._prep_raw_impl
        for name in ("_to_device", "match_raw", "build_resize_banks", "sample",
                     "sample_batched", "to_pixel_coordinates"):
            setattr(self, name, getattr(RomaMatcher, name).__get__(self))
        self.cfg, self.device = RomaConfig(), torch.device(dev)
        self.warps = [torch.from_numpy(w).to(dev) for w in warps]
        self.certs = [torch.from_numpy(c).to(dev) for c in certs]
        self.next = 0

    def match_prepped(self, a, b, a2=None, b2=None):
        import torch

        sel = slice(self.next, self.next + a.shape[0])
        self.next += a.shape[0]
        return torch.stack(self.warps[sel]), torch.stack(self.certs[sel])


SFM_CAMS = 8
SFM_HW = (480, 640)        # the rendered images of the SfM phase
SFM_WINDOW = 3
SFM_MATCHES = 2000         # the SfM CLI's --num_matches


def sfm_pose(i: int):
    """World-to-camera pose of camera i on tests/test_sfm.py's curved
    trajectory (4 degrees of yaw a step, centers (0.5 i, 0.4 sin 1.1 i,
    0.25 cos 0.9 i - 0.25)): collinear centers (`ring_pose`) are degenerate
    for direction-based translation averaging."""
    import numpy as np

    a = np.deg2rad(4.0 * i)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    c = np.array([0.5 * i, 0.4 * np.sin(1.1 * i), 0.25 * np.cos(0.9 * i) - 0.25])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, -R @ c
    return T


def write_sfm_scene(root: Path, n: int = SFM_CAMS, hw=SFM_HW, seed: int = 3) -> dict:
    """Render the two-plane world from `sfm_pose(0..n-1)` at hw into
    root/images (PNG), with the shared intrinsics as root/K.txt and the
    camera centers as root/centers.npy (the SfM CLI's --intrinsics and
    --gt_trajectory). Returns the poses, K, centers and paths."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    tex_near, tex_far = smooth_texture(rng), smooth_texture(rng)
    (root / "images").mkdir(parents=True, exist_ok=True)
    K = world_K(hw)
    poses = [sfm_pose(i) for i in range(n)]
    for i, T in enumerate(poses):
        img, _ = render_two_plane(T, K, hw, tex_near, tex_far)
        Image.fromarray((img * 255).astype(np.uint8)).save(root / "images" / f"sfm_{i:02d}.png")
    centers = np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])
    np.savetxt(root / "K.txt", K)
    np.save(root / "centers.npy", centers)
    return {"images": root / "images", "poses": poses, "K": K, "centers": centers,
            "intrinsics": root / "K.txt", "gt_trajectory": root / "centers.npy", "hw": hw}


class ExactWarpMatcher:
    """Stands for a matcher in the SfM CLI: `match` hands out the exact
    two-plane warps of the window pairs, in the CLI's order, at the images'
    size (one-sided (H, W, 4), certainty 0.9 where B sees the point);
    `sample` (balanced) and `to_pixel_coordinates` are Tiny RoMa's own."""

    def __init__(self, scene: dict, window: int, dev):
        import torch

        from roma_torch.config import TinyRomaConfig
        from roma_torch.models.tiny_roma import TinyRomaMatcher

        for name in ("sample", "to_pixel_coordinates"):
            setattr(self, name, getattr(TinyRomaMatcher, name).__get__(self))
        self.cfg, self.device = TinyRomaConfig(), torch.device(dev)
        n = len(scene["poses"])
        self.pairs = [(i, j) for i in range(n) for j in range(i + 1, min(i + 1 + window, n))]
        self.scene, self.next = scene, 0

    def match(self, im_a, im_b):
        import torch

        i, j = self.pairs[self.next]
        self.next += 1
        warp, cert = two_plane_warp(self.scene["poses"][i], self.scene["poses"][j],
                                    self.scene["hw"])
        return torch.from_numpy(warp).to(self.device), torch.from_numpy(cert).to(self.device)


def exact_sfm_matches(scene: dict, dev, window: int = SFM_WINDOW, num: int = SFM_MATCHES,
                      seed: int = 0) -> dict:
    """The SfM CLI's matches from the exact warps: {(i, j): (kpts_i, kpts_j)}
    in pixels, `num` balanced samples a window pair, one generator."""
    import torch

    m = ExactWarpMatcher(scene, window, dev)
    gen = torch.Generator(device=m.device).manual_seed(seed)
    h, w = scene["hw"]
    out = {}
    for i, j in list(m.pairs):
        warp, cert = m.match(None, None)
        sparse, _ = m.sample(warp, cert, num, generator=gen)
        out[(i, j)] = tuple(m.to_pixel_coordinates(sparse[:, k:k + 2], h, w).cpu().numpy()
                            for k in (0, 2))
    return out


# The JAX package's readings on the same worlds, from experiments/sfm_scale.py
# on an x86-64 CPU (Intel Xeon; float32 with its float64 refinement; SFM.md):
#   --cams 100 --pts 10000 --ba-iters 30 --device-driver --skip-scaling
#   --cams 1000 --pts 100000 --obs-per-cam 1200 --ba-iters 30 --device-driver
#       --solver cg --skip-scaling
# "jax": ATE rmse, ATE median, robust cost after 30 LM iterations. The
# deterministic 100-camera run is held to it (cost 1%, ATE rmse 5%). The
# 1k CG run's 30th iterate is no yardstick (ROADMAP C11): the float32
# triangulation of its tracks puts 1% of the start points more than 13
# units (the scene is ~20 across) apart between the JAX package's CPU, the
# port's CPU and the card, and from one start the LM branches on rounding
# (at lambda 1e-4 the float32 inner CG's step lies tens to hundreds of its
# own lengths from the exact step), the JAX package's own reading moving
# 26% with the observation order. Its gate, and the atomics runs', is
# SFM_STEP.
# "jax_step": the JAX package's one-step reading on the CPU from the same
# start state, the robust cost after each device solve's candidate step at
# SFM_STEP's lambda (`PYTHONPATH=. python tests/test_torch_sfm_cli.py step
# 100 10000 - cg,dense`); none at 1k, whose start state is the device's own.
SFM_WORLDS = {
    "dense_100": dict(cams=100, pts=10000, obs_per_cam=None, solver="dense", n_obs=249574,
                      init=(0.5396, 0.4163), jax=(0.2469, 0.1020, 106157.945),
                      steps=("dense", "cg"), jax_step={"dense": 51335900.0, "cg": 51335900.0}),
    "cg_1k": dict(cams=1000, pts=100000, obs_per_cam=1200, solver="cg", n_obs=846122,
                  init=(0.4604, 0.3681), jax=(0.3994, 0.2840, 3625130.0),
                  steps=("cg",), jax_step=None),
}
SFM_BA = dict(iters=30, huber_delta=3.0, max_err_px=20.0)
SFM_COST_RTOL, SFM_ATE_RTOL = 0.01, 0.05
SFM_CHUNK = dict(iters=12, refilter_every=5, chunk=4)
# One LM candidate step (roma_torch/experiments/sfm_study.py): each world's
# device solves ("steps") at every lambda, with atomics and deterministic,
# against schur_oracle_f64 on the same damped blocks. At `lam`: under
# deterministic algorithms the refined solve's camera delta lies within
# `dc_rtol` (relative L2) of the oracle's and the float32 solve alone (no
# float64 refinement) does not; with atomics the refined one within
# `atomics` x dc_rtol (the inner float32 CG's atomics reorder every
# matvec); the cost after the refined step within `cost_rtol` of the JAX
# package's reading and of the oracle's step. The smaller lambdas are
# reported: there the float32 CG does not converge.
SFM_STEP = dict(lams=(1e-4, 1e-3, 1e-2, 1e-1), lam=1e-1, dc_rtol=1e-6, atomics=2.0,
                cost_rtol=1e-4)


def sfm_world(name: str, dev) -> tuple[dict, object, dict]:
    """(world, the BA problem on `dev`, ATE after the pose-graph init) of
    SFM_WORLDS[name], through the port's sfm_scale (the JAX study's seeds)."""
    from roma_torch.experiments.sfm_study import study_problem

    spec = SFM_WORLDS[name]
    world, problem, ate_init = study_problem(spec["cams"], spec["pts"], spec["obs_per_cam"], dev)
    fail_if(len(world["uv"]) != spec["n_obs"],
            f"sfm {name}: {len(world['uv'])} observations, the JAX study's {spec['n_obs']}")
    return world, problem, ate_init


def run_sfm_ba(name: str, dev, card: str) -> tuple[dict, object]:
    """The study's BA on SFM_WORLDS[name] on the card (30 LM iterations,
    Huber 3 px, gate 20 px), after one untimed iteration (the process's
    first BA call initialises cuBLAS, cuSOLVER and torch.func): once with
    index_add_'s atomics (the default) and once under
    torch.use_deterministic_algorithms(True). Every run: finite, below the
    init's ATE and the cost the LM starts from. The deterministic
    100-camera run: ATE rmse within 5% and the cost within 1% of the JAX
    package's reading; the others are printed beside it (SFM_WORLDS: their
    gate is `check_sfm_steps`). Each: ATE after BA, the robust cost, wall
    and ms an LM iteration, peak memory. Returns (result, problem)."""
    import torch

    from roma_torch.experiments.sfm_scale import camera_centers
    from roma_torch.experiments.sfm_study import start_state
    from roma_torch.sfm.bundle_adjust import _ba_cost, bundle_adjust_device
    from roma_torch.sfm.metrics import absolute_trajectory_error

    spec = SFM_WORLDS[name]
    jax_rmse, _, jax_cost = spec["jax"]
    t0 = time.perf_counter()
    world, problem, ate_init = sfm_world(name, dev)
    cost_init = float(_ba_cost(start_state(problem), SFM_BA["huber_delta"]))
    res = {"cams": spec["cams"], "pts": spec["pts"], "n_obs": spec["n_obs"],
           "solver": spec["solver"], "setup_s": time.perf_counter() - t0,
           "ate_init": [ate_init["ate_rmse"], ate_init["ate_median"]], "cost_init": cost_init,
           "jax_cpu": spec["jax"]}
    fail_if(abs(ate_init["ate_rmse"] - spec["init"][0]) > 1e-4,
            f"sfm {name}: the pose-graph init's ATE {ate_init['ate_rmse']} is not the study's")
    t0 = time.perf_counter()
    bundle_adjust_device(problem, iters=1, solver=spec["solver"], huber_delta=3.0)
    res["warmup_s"] = time.perf_counter() - t0
    for mode in ("atomics", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            refined, cost = bundle_adjust_device(problem, solver=spec["solver"], **SFM_BA)
            wall_s = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        ate = absolute_trajectory_error(camera_centers(refined.cameras), world["centers"])
        res[mode] = row = {
            "ate": [ate["ate_rmse"], ate["ate_median"]], "cost": cost, "wall_s": wall_s,
            "ms_per_iter": wall_s / SFM_BA["iters"] * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cost_vs_jax": cost / jax_cost - 1, "ate_rmse_vs_jax": ate["ate_rmse"] / jax_rmse - 1}
        gated = name == "dense_100" and mode == "deterministic"
        print(f"[{card}] sfm BA {name} ({mode}): {spec['cams']} cams, {spec['pts']} pts, "
              f"{spec['n_obs']} obs, {spec['solver']}, {SFM_BA['iters']} LM iters: ATE init "
              f"{res['ate_init'][0]:.4f} / {res['ate_init'][1]:.4f} -> {ate['ate_rmse']:.4f} / "
              f"{ate['ate_median']:.4f}, robust cost {cost:.3f} (JAX CPU {jax_rmse:.4f} / "
              f"{spec['jax'][1]:.4f}, {jax_cost:.3f}: ATE rmse {row['ate_rmse_vs_jax']:+.2%}, "
              f"cost {row['cost_vs_jax']:+.2%}, "
              f"{'gated' if gated else 'not gated (C11; check_sfm_steps is its gate)'}); "
              f"{wall_s:.3f} s, {row['ms_per_iter']:.2f} ms an "
              f"LM iteration; peak {row['peak_mem_gb']:.2f} GB; world + init "
              f"{res['setup_s']:.1f} s, one warm-up iteration {res['warmup_s']:.2f} s", flush=True)
        fail_if(not (math.isfinite(cost) and cost < cost_init
                     and ate["ate_rmse"] < ate_init["ate_rmse"]),
                f"sfm {name} ({mode}): cost {cost} (init {cost_init}), ATE {ate['ate_rmse']} "
                f"(init {ate_init})")
        if gated:
            fail_if(abs(row["cost_vs_jax"]) > SFM_COST_RTOL,
                    f"sfm {name}: cost {cost} vs the JAX package's {jax_cost}")
            fail_if(abs(row["ate_rmse_vs_jax"]) > SFM_ATE_RTOL,
                    f"sfm {name}: ATE rmse {ate['ate_rmse']} vs the JAX package's {jax_rmse}")
    return res, problem


def check_sfm_steps(name: str, problem, card: str) -> list[dict]:
    """One LM candidate step from the study's start state (the init, gated
    at 20 px with the 0.9 quantile) at each of SFM_STEP's lambdas: each of
    the world's device solves, refined and float32 alone, with atomics and
    deterministic, against the float64 oracle (sfm_study.step_errors).
    Gated at SFM_STEP["lam"] (see SFM_STEP)."""
    from roma_torch.experiments import sfm_study

    spec = SFM_WORLDS[name]
    t0 = time.perf_counter()
    rows = sfm_study.step_errors(sfm_study.start_state(problem), SFM_STEP["lams"],
                                 spec["steps"], ("atomics", "deterministic"))
    wall_s = time.perf_counter() - t0
    for r in rows:
        print(f"[{card}] sfm step {name}: {json.dumps(r)}", flush=True)
    print(f"[{card}] sfm step {name}: {len(rows)} rows in {wall_s:.1f} s", flush=True)
    for r in rows:
        if r["lam"] != SFM_STEP["lam"]:
            continue
        what = f"sfm step {name} {r['solver']} ({r['mode']}) at lambda {r['lam']}"
        det = r["mode"] == "deterministic"
        tol = SFM_STEP["dc_rtol"] * (1.0 if det else SFM_STEP["atomics"])
        fail_if(not r["refined"]["dc_rel_l2"] <= tol,
                f"{what}: camera delta {r['refined']['dc_rel_l2']:.3e} from the float64 "
                f"oracle's (tolerance {tol:.1e})")
        fail_if(det and not r["float32"]["dc_rel_l2"] > tol,
                f"{what}: the float32 solve alone passes the gate too "
                f"({r['float32']['dc_rel_l2']:.3e}): the gate cannot see the refinement")
        refs = {"the oracle's step": r["oracle_cost"]}
        if spec["jax_step"] is not None:
            refs["the JAX package's"] = spec["jax_step"][r["solver"]]
        for ref_name, ref in refs.items():
            fail_if(not abs(r["refined"]["cost"] / ref - 1) <= SFM_STEP["cost_rtol"],
                    f"{what}: cost after the step {r['refined']['cost']} vs {ref_name} {ref}")
    return rows


def count_ba_syncs(problem, solver: str) -> dict:
    """Synchronizing calls (sync debug mode "warn") in two LM iterations of
    the device driver, both refiltering (refilter_every=1), a readback
    barrier after each (iters_per_launch=1): only the driver's cost
    readbacks may sync, none inside an iteration."""
    import linecache
    import warnings

    import torch

    from roma_torch.sfm.bundle_adjust import bundle_adjust_device

    syncs: dict[str, int] = {}
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *a, **k: record_sync(message, syncs)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            bundle_adjust_device(problem, iters=2, solver=solver, refilter_every=1,
                                 iters_per_launch=1, huber_delta=3.0, max_err_px=20.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    def readback(key: str) -> bool:  # a line of the repository reading the cost back
        path, _, line = key.partition(" ")[0].partition(":")
        return line.isdigit() and "float(cost)" in linecache.getline(str(ROOT / path), int(line))

    inside = {k: n for k, n in syncs.items() if not readback(k)}
    return {"syncs": syncs, "inside_an_iteration": inside}


def compare_ba_runs(problem, dev, card: str, mesh=None) -> dict:
    """The device driver (dense, 12 iterations, refilter every 5) run single
    and chunked (iters_per_launch=4), and with `mesh` against without:
    without and then with torch.use_deterministic_algorithms(True) (the
    sorted scatter in place of index_add_'s atomics). Differences: the
    cost's relative difference and the cameras' largest."""
    import torch

    from roma_torch.sfm.bundle_adjust import bundle_adjust_device

    kw = dict(iters=SFM_CHUNK["iters"], refilter_every=SFM_CHUNK["refilter_every"],
              huber_delta=3.0, max_err_px=20.0)

    def diff(a, b):
        return {"cost_rel": abs(a[1] - b[1]) / abs(b[1]),
                "cameras_max_abs": float((a[0].cameras - b[0].cameras).abs().max())}

    out = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        try:
            single = bundle_adjust_device(problem, **kw)
            again = bundle_adjust_device(problem, **kw)
            chunked = bundle_adjust_device(problem, iters_per_launch=SFM_CHUNK["chunk"], **kw)
            row = {"single_vs_single": diff(again, single), "chunked_vs_single": diff(chunked, single)}
            if mesh is not None:
                row["mesh_vs_plain"] = diff(bundle_adjust_device(problem, mesh=mesh, **kw), single)
        finally:
            torch.use_deterministic_algorithms(False)
        out["deterministic" if det else "atomics"] = row
    print(f"[{card}] sfm BA dense_100, {kw['iters']} iters, chunked ({SFM_CHUNK['chunk']}) vs "
          f"single and one NCCL rank vs no mesh: {json.dumps(out)}", flush=True)
    det = out["deterministic"]
    for what in [k for k in det if k != "single_vs_single"]:
        fail_if(det[what]["cost_rel"] > 1e-6 or det[what]["cameras_max_abs"] > 1e-6,
                f"sfm BA {what} (deterministic): {det[what]}")
    return out


def profile_ba(problem, solver: str, out_dir: Path, iters: int = 3) -> dict:
    """torch.profiler over `iters` LM iterations of the device driver:
    wall, device busy time, idle share, launches an iteration and the top
    device ops (table in out_dir/profile_sfm_ba_{solver}.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from roma_torch.sfm.bundle_adjust import bundle_adjust_device

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bundle_adjust_device(problem, iters=iters, solver=solver, huber_delta=3.0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    dev_self = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_self, reverse=True)[:12]
    (out_dir / f"profile_sfm_ba_{solver}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60))
    return {"iters": iters, "wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "kernel_launches_per_iter": sum(e.count for e in kernels) / iters,
            "top_ops_ms": {e.key[:80]: dev_self(e) / 1e3 for e in top}}


def run_sfm(dev, card: str, profile_dir: Path | None = None) -> dict:
    """Path S, SfM (roma_torch/sfm and the two SfM CLIs), on the card:
    the study's BA at its full sizes (100 cams dense; 1k cams CG) against
    the JAX package's readings; host syncs in an LM iteration; chunked vs
    single and one NCCL rank vs no mesh; `reconstruct` on exact-warp
    matches of 8 rendered images (ATE < 0.02); the SfM CLI with full-width
    roma_outdoor() (launches of each pair's match as `expected_launches`)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from roma_torch.experiments import sfm_reconstruct
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.parallel.mesh import initialize_distributed, make_mesh
    from roma_torch.sfm.metrics import absolute_trajectory_error
    from roma_torch.sfm.reconstruction import reconstruct

    res: dict = {}
    res["dense_100"], p100 = run_sfm_ba("dense_100", dev, card)
    res["dense_100"]["steps"] = check_sfm_steps("dense_100", p100, card)
    if profile_dir is not None:
        res["profile_dense_100"] = profile_ba(p100, "dense", profile_dir)
        print(f"[{card}] sfm BA dense_100 profile: {json.dumps(res['profile_dense_100'])}",
              flush=True)
    res["syncs"] = {s: count_ba_syncs(p100, s) for s in ("dense", "cg")}
    print(f"[{card}] sfm BA synchronizing calls in 2 LM iterations (sync debug mode warn): "
          f"{json.dumps(res['syncs'])}", flush=True)
    for s, r in res["syncs"].items():
        fail_if(bool(r["inside_an_iteration"]), f"sfm BA {s}: host syncs {r['inside_an_iteration']}")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    try:
        fail_if(initialize_distributed(dev) != (0, 1), "sfm: not rank 0 of 1")
        fail_if(dist.get_backend() != "nccl", f"sfm: backend {dist.get_backend()}")
        res["compare"] = compare_ba_runs(p100, dev, card, make_mesh(dev))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    del p100
    torch.cuda.empty_cache()
    res["cg_1k"], p1k = run_sfm_ba("cg_1k", dev, card)
    res["cg_1k"]["steps"] = check_sfm_steps("cg_1k", p1k, card)
    if profile_dir is not None:
        res["profile_cg_1k"] = profile_ba(p1k, "cg", profile_dir)
        print(f"[{card}] sfm BA cg_1k profile: {json.dumps(res['profile_cg_1k'])}", flush=True)
    del p1k
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        scene = write_sfm_scene(Path(tmp))
        n = len(scene["poses"])
        t0 = time.perf_counter()
        matches = exact_sfm_matches(scene, dev)
        match_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = reconstruct(matches, np.tile(scene["K"], (n, 1, 1)).astype(np.float32), n,
                          device=dev)
        ate = absolute_trajectory_error(rec.centers, scene["centers"])
        res["reconstruct_exact"] = {"images": n, "hw": list(SFM_HW), "pairs": len(matches),
                                    "num_matches": SFM_MATCHES, "match_s": match_s,
                                    "wall_s": time.perf_counter() - t0, "stages_s": rec.timings,
                                    "points": len(rec.points), "cost": rec.cost,
                                    "ate_rmse": ate["ate_rmse"], "ate_median": ate["ate_median"]}
        print(f"[{card}] sfm reconstruct on exact-warp matches ({n} images {SFM_HW[0]}x"
              f"{SFM_HW[1]}, window {SFM_WINDOW}, {SFM_MATCHES} a pair): ATE rmse "
              f"{ate['ate_rmse']:.5f}, {len(rec.points)} points, cost {rec.cost:.4g}; stages "
              f"{json.dumps(rec.timings)} s", flush=True)
        fail_if(not ate["ate_rmse"] < 0.02, f"sfm reconstruct: ATE {ate}")

        # the SfM CLI at full width: each pair's match counted
        per_pair: list[dict] = []
        expected: dict = {}

        def counted_roma_outdoor(device=None):
            from roma_torch.models.zoo import roma_outdoor

            m = roma_outdoor(seed=SEED, device=device)
            expected.update(expected_launches(m.cfg))
            inner = m.match

            def match(a, b, **kw):
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                out = inner(a, b, **kw)
                torch.cuda.synchronize()
                per_pair.append({"launches": dict(LAUNCHES),
                                 "match_ms": (time.perf_counter() - t0) * 1e3})
                return out

            m.match = match
            return m

        saved = (sfm_reconstruct.DEVICE, sfm_reconstruct.roma_outdoor)
        sfm_reconstruct.DEVICE, sfm_reconstruct.roma_outdoor = dev, counted_roma_outdoor
        out = Path(tmp) / "sfm_cli.npz"
        t0 = time.perf_counter()
        try:
            cli = sfm_reconstruct.main(["--images", str(scene["images"]), "--matcher", "roma",
                                        "--window", str(SFM_WINDOW),
                                        "--intrinsics", str(scene["intrinsics"]),
                                        "--out", str(out)])
            finding = None
        except ValueError as e:  # random weights: possibly no usable two-view geometry
            fail_if("no usable two-view geometries" not in str(e), f"sfm CLI: {e}")
            cli, finding = None, str(e)
        finally:
            sfm_reconstruct.DEVICE, sfm_reconstruct.roma_outdoor = saved
        wall_s = time.perf_counter() - t0
        fail_if(len(per_pair) != len(matches), f"sfm CLI: {len(per_pair)} matches, "
                f"expected {len(matches)}")
        for i, r in enumerate(per_pair):
            bad = {k: (r["launches"][k], n) for k, n in expected.items() if r["launches"][k] != n}
            fail_if(bool(bad), f"sfm CLI pair {i}: launches {bad} (got, expected)")
        row = {"pairs": len(per_pair), "launches_per_pair": per_pair[0]["launches"],
               "match_ms": [r["match_ms"] for r in per_pair], "wall_s": wall_s,
               "finding": finding}
        if cli is not None:
            rec = cli["reconstruction"]
            row.update(pair_ms=[cli["pair_s"][k] * 1e3 for k in sorted(cli["pair_s"])],
                       stages_s=rec.timings, points=len(rec.points), cost=rec.cost)
            fail_if(not out.exists(), "sfm CLI: no .npz written")
            saved_npz = np.load(out)
            fail_if(not all(np.isfinite(saved_npz[k]).all() for k in saved_npz.files),
                    "sfm CLI: non-finite poses or points")
        res["cli_roma"] = row
        print(f"[{card}] sfm CLI --matcher roma (full width, random weights) on {n} images, "
              f"window {SFM_WINDOW}: {len(per_pair)} pairs, each pair's launches "
              f"{per_pair[0]['launches']} (= expected_launches); match "
              f"{median(sorted(row['match_ms'])):.1f} ms a pair (median), match + sample "
              f"{median(sorted(row.get('pair_ms', [float('nan')]))):.1f} ms; stages "
              f"{json.dumps(row.get('stages_s'))} s; {row.get('points')} points; whole CLI "
              f"{wall_s:.1f} s" + (f"; FINDING: {finding}" if finding else ""), flush=True)
    torch.cuda.empty_cache()
    return res


def harness_main_thread_syncs(syncs: dict[str, int]) -> dict[str, int]:
    """The syncs `record_sync` counted in the harness's own code on the main
    thread (its keys from other threads end in the thread's name; the
    estimator jobs and the uploader run on pool threads)."""
    return {k: v for k, v in syncs.items()
            if k.startswith("roma_torch/benchmarks/") and not k.endswith(")")}


def profile_eval(run, out_dir: Path) -> dict:
    """torch.profiler over one eval: wall, device busy time and idle share,
    and the eval.* stage ranges' host and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    dev_total = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    dev_self = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    ranges = ("eval.", "roma.")
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(ranges)]
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3
    stages = {e.key: {"host_ms": e.cpu_time_total / 1e3, "device_ms": dev_total(e) / 1e3,
                      "calls": e.count}
              for e in events if e.key.startswith("eval.")
              and e.device_type == torch.autograd.DeviceType.CPU}
    (out_dir / "profile_eval.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall_s * 1e3), "stages": stages}


class CountedMatchRaw:
    """Wraps a matcher's `match_raw`: the kernel launches of the first call
    (the counters reset just before it and read just after), and CUDA events
    around every call for the match's device time."""

    def __init__(self, match_raw):
        self.inner, self.first, self.events = match_raw, None, []

    def __call__(self, *a):
        import torch

        from roma_torch.kernels import LAUNCHES, reset_launches

        if self.first is None:
            reset_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(*a)
        stop.record()
        self.events.append((start, stop))
        if self.first is None:
            self.first = dict(LAUNCHES)
        return out

    def device_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def run_eval(matcher, card: str, profile_dir: Path | None = None) -> dict:
    """Path E, the evaluation slice, on a two-plane world rendered from a
    seed into a temporary directory in the MegaDepth layout (cameras -4..4
    of the ring, each seeing both planes, 480x640 and 600x800 alternating,
    8 pairs):
    1. the native estimator built from roma_torch/native and bound, no
       numpy fallback;
    2. exact warps (EngineOracle) through the batched engine on the card,
       batch 4, with and without device_resize: AUC@5 > 0.9;
    3. `matcher`, the full-width roma_outdoor() (seed 0, bf16), through
       MegaDepthPoseEstimationBenchmark(batch_size=2, device_resize=True,
       pose_backend="native", 5000 samples, 5 RANSAC runs): the first
       batch's launches equal expected_launches, 8 x 5 finite errors; the
       first eval under sync debug mode "warn" (the harness's main thread
       must make no synchronizing call), the second timed (pairs/s on the
       host clock, the match's device time by CUDA events around each
       match_raw, the estimator pool's seconds), with --profile a third
       under torch.profiler (device idle share, eval.* stages);
    4. train -> eval (`train_to_eval`)."""
    import warnings

    import numpy as np
    import torch

    from roma_torch.benchmarks.megadepth_pose import (MegaDepthPoseEstimationBenchmark,
                                                      summarize_pose_errors)
    from roma_torch.benchmarks.pose_backends import bind_native
    from roma_torch.estimation import native

    dev = matcher.device
    res: dict = {}
    t0 = time.perf_counter()
    fn, err = bind_native()  # started beside the kernels' build: waits for it
    fail_if(fn is None, f"eval: the native estimator did not build or bind: {err!r}")
    fail_if(fn.__module__ != "roma_torch.estimation.native", f"eval: bound {fn.__module__}")
    res["native_bind_wait_s"] = time.perf_counter() - t0
    print(f"[{card}] eval: native estimator {native.LIB_PATH.relative_to(ROOT)} built and bound "
          f"(waited {res['native_bind_wait_s']:.2f} s)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        world = write_two_plane_scene(root / "eval", EVAL_CAMS,
                                      [EVAL_SIZES[j % 2] for j in range(len(EVAL_CAMS))])
        n_pairs = len(EVAL_CAMS) - 1

        def bench(**kw):
            return MegaDepthPoseEstimationBenchmark(
                data_root=str(root / "eval"), scene_names=["scene.npz"], pose_backend="native",
                sample_num=EVAL_SAMPLES, num_ransac_runs=EVAL_RUNS, **kw)

        # 2. the engine on exact geometry
        exact = [two_plane_warp(world["poses"][i], world["poses"][i + 1]) for i in range(n_pairs)]
        res["oracle"] = {}
        for resize in (True, False):
            oracle = EngineOracle([w for w, _ in exact], [c for _, c in exact], dev)
            auc = bench(batch_size=4, device_resize=resize).benchmark(oracle)
            res["oracle"][f"device_resize={resize}"] = auc
            fail_if(oracle.next != n_pairs, f"eval oracle: {oracle.next} pairs matched")
            fail_if(not auc["auc_5"] > 0.9, f"eval oracle (device_resize={resize}): {auc}")
        print(f"[{card}] eval: exact warps through the batched engine on the card (batch 4, "
              f"{n_pairs} pairs, 480x640 + 600x800): " + json.dumps(res["oracle"]), flush=True)

        # 3. full-width RoMa through Mega-1500
        raw_match = matcher.match_raw
        est_s: list[float] = []
        lock = threading.Lock()

        def full_eval():
            b = bench(batch_size=EVAL_BATCH, device_resize=True)
            inner = b.estimate_pose

            def timed_estimate(*a):
                t = time.perf_counter()
                out = inner(*a)
                with lock:
                    est_s.append(time.perf_counter() - t)
                return out

            b.estimate_pose = timed_estimate
            return b.collect_errors(matcher)

        matcher.match_raw = counted = CountedMatchRaw(raw_match)
        syncs: dict[str, int] = {}
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = lambda message, *a, **k: record_sync(message, syncs)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                errors = full_eval()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        res.update(first_eval_s=time.perf_counter() - t0, first_batch_launches=counted.first,
                   syncs=syncs)
        harness_syncs = harness_main_thread_syncs(syncs)
        print(f"[{card}] eval: synchronizing calls in one batched eval ({n_pairs // EVAL_BATCH} "
              f"batches, sync debug mode warn): harness main thread {harness_syncs or 'none'}; "
              f"all {json.dumps(syncs)}", flush=True)
        for name, n in expected_launches(matcher.cfg).items():
            fail_if(counted.first[name] != n,
                    f"eval: first batch {name}: {counted.first[name]} launches, expected {n}")
        fail_if(len(errors) != n_pairs * EVAL_RUNS, f"eval: {len(errors)} errors")
        fail_if(not np.isfinite(errors).all(), "eval: non-finite pose errors")
        fail_if(bool(harness_syncs), f"eval: the harness's main loop synchronizes: {harness_syncs}")

        matcher.match_raw = counted = CountedMatchRaw(raw_match)
        est_s.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        errors = full_eval()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fail_if(len(errors) != n_pairs * EVAL_RUNS or not np.isfinite(errors).all(),
                "eval: the timed run's errors")
        res.update(eval_s=wall, pairs_per_s=n_pairs / wall, match_device_ms=counted.device_ms(),
                   matcher_share=counted.device_ms() / 1e3 / wall, estimator_s=sum(est_s),
                   estimator_calls=len(est_s), summary=summarize_pose_errors(np.asarray(errors)))
        print(f"[{card}] eval: roma_outdoor() (560 -> 864, bf16, random weights) through "
              f"Mega-1500 (batch {EVAL_BATCH}, device_resize, native, {EVAL_SAMPLES} samples, "
              f"{EVAL_RUNS} runs), {n_pairs} pairs: {wall:.3f} s, {res['pairs_per_s']:.3f} "
              f"pairs/s; match_raw device time {res['match_device_ms']:.1f} ms "
              f"({100 * res['matcher_share']:.1f}% of the wall); estimator pool "
              f"{res['estimator_s']:.3f} s over {len(est_s)} calls; first eval (warm-up, sync "
              f"debug) {res['first_eval_s']:.3f} s; first batch launches "
              f"{json.dumps(res['first_batch_launches'])}; AUC (random weights, not gated) "
              + json.dumps(res["summary"]), flush=True)
        if profile_dir is not None:
            res["profile"] = prof = profile_eval(full_eval, profile_dir)
            print(f"[{card}] eval profile: " + json.dumps(prof), flush=True)
        matcher.match_raw = raw_match
        del counted
        torch.cuda.empty_cache()

        # 4. train -> eval
        res["train_to_eval"] = t2e = train_to_eval(dev, root / "t2e", card)
        check_train_to_eval(t2e)
    return res


def t2e_batch(world) -> dict:
    """All consecutive pairs of the world, both directions, as one batch of
    the dataset contract (numpy)."""
    import numpy as np

    keys = ("im_A", "im_B", "im_A_depth", "im_B_depth", "T_1to2")
    rows: dict[str, list] = {k: [] for k in keys}
    for i in range(len(world["imgs"]) - 1):
        for a, b in ((i, i + 1), (i + 1, i)):
            vals = (world["imgs"][a], world["imgs"][b], world["depths"][a], world["depths"][b],
                    world["poses"][b] @ np.linalg.inv(world["poses"][a]))
            for k, v in zip(keys, vals):
                rows[k].append(v)
    batch = {k: np.stack(v) for k, v in rows.items()}
    batch["T_1to2"] = batch["T_1to2"].astype(np.float32)
    K = np.tile(world["Ks"][0][None], (len(batch["im_A"]), 1, 1)).astype(np.float32)
    batch["K1"], batch["K2"] = K, K.copy()
    return batch


def train_to_eval(dev, root: Path, card: str | None = None, steps: int = T2E_STEPS,
                  seed: int = SEED, init: str = "flax") -> dict:
    """tests/test_train_to_eval.py through the port on `dev`: Tiny RoMa
    (match_dim 64, fine_match_dim 32, float32; `init` "flax": `build_model`'s
    default, the JAX package's initialisation, as the JAX test's TinyRoma
    starts, or "torch": PyTorch's module defaults; drawn from `seed`) trained `steps` steps on
    the 96x128 two-plane world (its 4 consecutive pairs, both directions:
    batch 8) with the test's loss and train settings, then AUC@5 through the
    port's Mega-1500 harness (native estimator, 2500 samples, 3 runs).
    `check_train_to_eval` holds the result to the JAX test's gates."""
    import numpy as np
    import torch

    from roma_torch.benchmarks.megadepth_pose import MegaDepthPoseEstimationBenchmark
    from roma_torch.config import TinyRomaConfig, TrainConfig
    from roma_torch.losses.robust_loss import RobustLossConfig, tiny_robust_loss
    from roma_torch.models.tiny_roma import TinyRoma, TinyRomaMatcher
    from roma_torch.models.zoo import build_model
    from roma_torch.train.train import make_tiny_train_state, make_train_step

    world = write_two_plane_scene(root, range(T2E_CAMS), [WORLD_HW] * T2E_CAMS)
    cfg = TinyRomaConfig(match_dim=64, fine_match_dim=32, dtype="float32")
    if init == "flax":  # build_model's default (ROADMAP C9)
        model = build_model(cfg, seed)
    else:  # PyTorch's module defaults, from which the same steps reach a lower AUC@5
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = TinyRoma(cfg)
    # the LR decays 5x after ~400 steps (the test's schedule)
    tcfg = TrainConfig(batch_size=8, lr_decoder=1e-3, grad_clip=1.0, steps=8 * steps,
                       milestone_frac=0.67)
    state = make_tiny_train_state(tcfg, model=model, trainable="all", device=dev)
    loss_cfg = RobustLossConfig(ce_weight=0.01, alpha={4: 0.15, 8: 0.15}, c=1e-4,
                                local_dist={4: 4}, epe_mask_prob_th=0.001,
                                corr_volume_weight=1.0)
    step = make_train_step(tiny_robust_loss, loss_cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in t2e_batch(world).items()}

    def auc():
        bench = MegaDepthPoseEstimationBenchmark(
            data_root=str(root), scene_names=["scene.npz"], pose_backend="native",
            num_ransac_runs=3, sample_num=2500)
        return bench.benchmark(TinyRomaMatcher(state.model, device=dev))

    res = {"init": init, "seed": seed, "auc_init": auc()}
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["total_loss"])
    losses = torch.stack(losses).cpu().numpy()
    res.update(train_s=time.perf_counter() - t0, loss_first=float(np.median(losses[:20])),
               loss_last=float(np.median(losses[-20:])), auc=auc())
    if card is not None:
        print(f"[{card}] train -> eval: Tiny RoMa (64/32, float32, {init} init, seed {seed}) "
              f"{steps} steps at 96x128, batch 8, in {res['train_s']:.2f} s; median loss "
              f"{res['loss_first']:.4f} -> {res['loss_last']:.4f}; AUC untrained "
              f"{json.dumps(res['auc_init'])}, trained {json.dumps(res['auc'])}", flush=True)
    return res


def check_train_to_eval(res: dict) -> None:
    """The JAX test's gates: the loss's median over the last 20 steps below
    0.85x the first 20's, AUC@5 > 0.5 and > the untrained AUC@5 + 0.3."""
    fail_if(not res["loss_last"] < 0.85 * res["loss_first"], f"train -> eval: loss {res}")
    fail_if(not res["auc"]["auc_5"] > 0.5, f"train -> eval: AUC@5 {res['auc']['auc_5']} <= 0.5")
    fail_if(not res["auc"]["auc_5"] > res["auc_init"]["auc_5"] + 0.3,
            f"train -> eval: AUC@5 {res['auc']['auc_5']} not above the untrained "
            f"{res['auc_init']['auc_5']} + 0.3")


def t2e_sweep(seeds: int = 5, inits: tuple[str, ...] = ("flax", "torch")) -> list[dict]:
    """`train_to_eval` on the GPU once per seed and initialisation, one
    JSON line a run (AUC@5, the last loss, whether the JAX test's gates
    hold), after the card's name and power limit:

        python3 -c "import chip_smoke; chip_smoke.t2e_sweep(5)"
    """
    import torch

    fail_if(not torch.cuda.is_available(), "t2e_sweep: no GPU")
    print(gpu_line(), flush=True)
    rows = []
    for init in inits:
        for seed in range(seeds):
            with tempfile.TemporaryDirectory() as tmp:
                res = train_to_eval(torch.device("cuda", 0), Path(tmp), seed=seed, init=init)
            try:
                check_train_to_eval(res)
                ok = True
            except SmokeFailure:
                ok = False
            rows.append({"init": init, "seed": seed, "auc_5": res["auc"]["auc_5"],
                         "auc_5_untrained": res["auc_init"]["auc_5"],
                         "loss_last": res["loss_last"], "train_s": res["train_s"],
                         "gates_hold": ok})
            print(json.dumps(rows[-1]), flush=True)
    return rows


# ---------------------------------------------------------------- the tail (A14)

TAIL_DEMO_FRAMES = 4


def check_export(dev, card: str) -> dict:
    """Tiny RoMa with fused_kernel=True (bf16) exported on the card at
    1 x 480x640 through `export_tiny_roma` (weights as the first input),
    saved to bytes and loaded back in this process: each call of the loaded
    program launches K7 once and nothing else, and its four outputs equal
    the eager model's (the same kernel on the same inputs) bit for bit."""
    import torch

    from roma_torch.config import TinyRomaConfig
    from roma_torch.export import export_tiny_roma, load_exported
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.models.zoo import build_model

    cfg = TinyRomaConfig(fused_kernel=True)
    model = build_model(cfg, SEED).to(dev).eval()
    params = dict(model.state_dict())
    t0 = time.perf_counter()
    res = export_tiny_roma(params, hw=TINY_HW, cfg=cfg)
    export_s = time.perf_counter() - t0
    run = load_exported(res.serialized)
    g = torch.Generator(device=dev).manual_seed(SEED)
    a, b = (torch.rand((1, *TINY_HW, 3), generator=g, device=dev) for _ in range(2))
    with torch.no_grad():
        ref = model(a, b)
        run(params, a, b)  # a first call
        calls = []
        for _ in range(2):
            reset_launches()
            out = run(params, a, b)
            torch.cuda.synchronize()
            calls.append(dict(LAUNCHES))
    ref = (ref[8]["flow"], ref[8]["certainty"], ref[4]["flow"], ref[4]["certainty"])
    equal = [bool(torch.equal(o, r)) for o, r in zip(out, ref)]
    out = dict(bytes=len(res.serialized), flops=res.flops, bytes_accessed=res.bytes_accessed,
               peak_memory=res.peak_memory, export_s=export_s, launches=calls,
               bit_equal_eager=equal)
    print(f"[{card}] tail: exported Tiny RoMa (fused_kernel, bf16, 1 x {TINY_HW}): "
          f"{out['bytes']} bytes, {res.flops / 1e9:.4f} GFLOP, "
          f"{res.bytes_accessed / 1e9:.4f} GB accessed, peak "
          f"{'not measured' if res.peak_memory is None else f'{res.peak_memory / 1e6:.1f} MB'}, "
          f"exported in {export_s:.1f} s; launches a call {calls}; bit-equal to eager "
          f"{equal}", flush=True)
    for c in calls:
        fail_if(c != dict({k: 0 for k in c}, corr_softmax=1),
                f"tail export: a call of the loaded program launched {c}, not K7 once")
    fail_if(not all(equal), f"tail export: outputs differ from the eager kernel path {equal}")
    return out


class CaptureOps:
    """Within, the first call of each ``roma::`` operator at each argument
    signature (shapes, dtypes, other arguments) is kept: (op, args)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        calls = self.calls = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "roma":
                    key = (func.name(), *(
                        (tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") else a
                        for a in args))
                    calls.setdefault(key, (func, args))
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def check_op_flops(matcher, a, b, card: str) -> list[dict]:
    """Each ``roma::`` operator that one default match() calls, at each
    argument signature it is called with: its FLOP formula against
    FlopCounterMode over the operator's plain version on the same CUDA
    inputs. They must be equal."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    from roma_torch.kernels import PLAIN

    with CaptureOps() as cap:
        matcher.match(a, b, batched=True)
    rows = []
    for key, (func, args) in cap.calls.items():
        with FlopCounterMode(display=False) as fc, torch.inference_mode():
            PLAIN[func.name().split("::")[1]](*args)
        formula = flop_registry[func._overloadpacket](*args, out_val=None)
        rows.append(dict(op=func.name(), shapes=[list(x[0]) if isinstance(x, tuple) else x
                                                 for x in key[1:]],
                         formula=int(formula), flop_counter=int(fc.get_total_flops())))
    bad = [r for r in rows if r["formula"] != r["flop_counter"]]
    print(f"[{card}] tail: FLOP formulas against FlopCounterMode on the plain versions, "
          f"{len(rows)} signatures of one match(): "
          + "; ".join(f"{r['op']} {r['shapes'][0]} {r['formula']}" for r in rows), flush=True)
    fail_if(not rows, "tail: no roma:: operator captured in match()")
    fail_if(bool(bad), f"tail: FLOP formulas differ from FlopCounterMode: {bad}")
    return rows


def run_tail(matcher, dev, gen, card: str) -> dict:
    """The tail (A14) on the card: the export with K7 (`check_export`);
    `profiling.roofline` of the default match() on 2 pairs (FLOPs with K1-K4
    counted through their operators' formulas, bytes, TFLOP/s, tensor-core
    share), launches per match K1 5, K2 18, K3 29, K4 63, each operator's
    FLOP formula against FlopCounterMode (`check_op_flops`), pairs/s and
    the profiled device busy ms; the four demos on a rendered 480x640 pair
    (demo_match, demo_match_tiny, demo_fundamental, demo_3D_effect with
    TAIL_DEMO_FRAMES frames), full RoMa through this run's matcher, each
    writing its files, a full-RoMa demo's match launching as match() does;
    ResNet-50 in float32 at 1 x 224^2 on the card against the same weights
    on the CPU at every level (1e-4 x max|CPU|), and in bf16 at 1 x 560^2
    for the shapes; `grid_sample_nearest` on the card against the CPU on a
    grid of exact half-pixel ties and random points, bit-equal."""
    import numpy as np
    import torch

    from roma_torch.demo import demo_3D_effect, demo_fundamental, demo_match, demo_match_tiny
    from roma_torch.kernels import LAUNCHES, reset_launches
    from roma_torch.models.layers import flax_init_
    from roma_torch.models.resnet import ResNet50
    from roma_torch.ops.grid_sample import grid_sample_nearest
    from roma_torch.utils import profiling

    t_start = time.perf_counter()
    res: dict = {"export": check_export(dev, card)}

    h, w = matcher.cfg.coarse_resolution
    a, b = (torch.rand((PAIRS, h, w, 3), generator=gen, device=dev) for _ in range(2))
    match = lambda x, y: matcher.match(x, y, batched=True)  # noqa: E731
    reset_launches()
    roof = profiling.roofline(match, a, b, iters=3)
    # roofline runs match 1 + 3 + 1 times (warm-up, timed, counted)
    launches = {k: v // 5 for k, v in LAUNCHES.items()}
    expected = expected_launches(matcher.cfg)
    res["roofline"] = dict(seconds=roof.seconds, flops=roof.flops,
                           bytes_accessed=roof.bytes_accessed, tflops=roof.achieved_tflops,
                           tensor_core_share=roof.tensor_core_utilization,
                           hbm_share=roof.hbm_utilization, report=roof.report(),
                           launches_per_match=launches)
    print(f"[{card}] tail: roofline of match() on 2 pairs: {roof.report()}; "
          f"{roof.flops / 1e12:.4f} TFLOP, {roof.bytes_accessed / 1e9:.3f} GB accessed; "
          f"launches a match {launches}", flush=True)
    fail_if(any(LAUNCHES[k] != 5 * n for k, n in expected.items()),
            f"tail: launches over 5 matches {dict(LAUNCHES)}, expected 5 x {expected}")
    res["op_flops"] = check_op_flops(matcher, a, b, card)
    times = [timed_match(matcher, a, b)[2] for _ in range(5)]
    res["match_s"] = times
    res["pairs_per_s"] = PAIRS / min(times)
    res["device_busy_ms"] = profiled_device_ms(lambda: match(a, b), 3)
    print(f"[{card}] tail: match() {', '.join(f'{t:.4f}' for t in times)} s, best "
          f"{res['pairs_per_s']:.3f} pairs/s; device busy {res['device_busy_ms']:.2f} ms a "
          "match (profiled)", flush=True)

    # the demos on a rendered pair, full RoMa through this run's matcher
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        world = write_two_plane_scene(root, (0, 1), ((480, 640), (480, 640)))
        pa, pb = (str(root / p) for p in world["paths"])
        pair = ["--im_A_path", pa, "--im_B_path", pb, "--device", str(dev)]
        saved = [m.roma_outdoor for m in (demo_match, demo_fundamental, demo_3D_effect)]
        for m in (demo_match, demo_fundamental, demo_3D_effect):
            m.roma_outdoor = lambda device=None: matcher
        demos = {}
        try:
            for name, fn, extra, files in (
                    ("demo_match", demo_match.main, ["--save_path", f"{tmp}/w.jpg"], ["w.jpg"]),
                    ("demo_match_tiny", demo_match_tiny.main, ["--save_path", f"{tmp}/t.jpg"],
                     ["t.jpg"]),
                    ("demo_fundamental", demo_fundamental.main, [], []),
                    ("demo_3D_effect", demo_3D_effect.main,
                     ["--save_path", f"{tmp}/gif/f", "--frames", str(TAIL_DEMO_FRAMES)],
                     [f"gif/f_{i:03d}.jpg" for i in range(TAIL_DEMO_FRAMES)])):
                reset_launches()
                t0 = time.perf_counter()
                out = fn(pair + extra)
                torch.cuda.synchronize()
                demos[name] = row = dict(s=time.perf_counter() - t0, launches=dict(LAUNCHES))
                fail_if(not all((root / f).exists() for f in files), f"tail {name}: no {files}")
                if name == "demo_fundamental":
                    fail_if(out is None or tuple(np.shape(out.model)) != (3, 3)
                            or not np.isfinite(out.model).all(), f"tail {name}: F {out}")
                    row["F"] = np.asarray(out.model).tolist()
                    row["inlier_share"] = float(np.mean(out.inliers))
                if name != "demo_match_tiny":
                    fail_if(any(row["launches"][k] != n for k, n in expected.items()),
                            f"tail {name}: launches {row['launches']}, expected {expected}")
        finally:
            for m, f in zip((demo_match, demo_fundamental, demo_3D_effect), saved):
                m.roma_outdoor = f
    res["demos"] = demos
    print(f"[{card}] tail: demos on a rendered 480x640 pair: " + json.dumps(demos), flush=True)

    # ResNet-50: float32 on the card against the CPU, then bf16 shapes
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        net = flax_init_(ResNet50(dtype=torch.float32))
    x = torch.rand((1, 3, 224, 224), generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        ref = net(x)
        got = net.to(dev)(x.to(dev))
        errs = {s: ((got[s].cpu() - ref[s]).abs().max() / ref[s].abs().max()).item()
                for s in ref}
        net.dtype = torch.bfloat16
        big = net(torch.rand((1, 3, 560, 560), generator=gen, device=dev))
    shapes = {s: list(t.shape) for s, t in big.items()}
    res["resnet50"] = dict(float32_err_over_max=errs, bf16_shapes=shapes)
    print(f"[{card}] tail: ResNet-50 float32 1x224^2 GPU vs CPU |d|/max|CPU| per level "
          f"{errs}; bf16 1x560^2 shapes {shapes}", flush=True)
    fail_if(any(not e <= 1e-4 for e in errs.values()), f"tail ResNet-50: {errs}")
    fail_if(shapes != {1: [1, 3, 560, 560], 2: [1, 64, 280, 280], 4: [1, 256, 140, 140],
                       8: [1, 512, 70, 70], 16: [1, 1024, 35, 35], 32: [1, 2048, 18, 18]},
            f"tail ResNet-50 bf16 shapes {shapes}")

    # nearest sampling: half-pixel ties (pixel coordinates k + 0.5) and random points
    g = torch.Generator().manual_seed(SEED)
    feat = torch.randn((2, 6, 8, 5), generator=g).to(torch.bfloat16)
    ties = torch.stack(torch.meshgrid(torch.arange(-1, 9) * 0.25 - 1.0,
                                      torch.arange(-1, 7) / 3.0 - 1.0, indexing="xy"), -1)
    pts = torch.rand((2, 40, 2), generator=g) * 2.4 - 1.2
    near = {}
    for name, grid in (("ties", ties[None].expand(2, -1, -1, -1)), ("points", pts)):
        for pad in ("zeros", "border"):
            ref = grid_sample_nearest(feat, grid, pad)
            got = grid_sample_nearest(feat.to(dev), grid.to(dev), pad).cpu()
            near[f"{name} {pad}"] = bool(torch.equal(got, ref))
    res["grid_sample_nearest_bit_equal"] = near
    print(f"[{card}] tail: grid_sample_nearest GPU vs CPU bit-equal {near}", flush=True)
    fail_if(not all(near.values()), f"tail grid_sample_nearest: {near}")
    res["tail_s"] = time.perf_counter() - t_start
    print(f"[{card}] tail phase took {res['tail_s']:.1f} s", flush=True)
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
    and `sample_batched` on the output (10,000 matches a pair, the
    benchmark's RoMa cells' count), its launches counted from zero
    (`sample_launches`: one KDE a pair)."""
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
    reset_launches()
    m, c = matcher.sample_batched(warp, cert, 10000, gens)
    torch.cuda.synchronize()
    res["sample_launches"] = dict(LAUNCHES)
    fail_if(LAUNCHES["kde"] != PAIRS, f"sample_batched: {LAUNCHES['kde']} KDEs, expected {PAIRS}")
    fail_if(tuple(m.shape) != (PAIRS, 10000, 4) or tuple(c.shape) != (PAIRS, 10000),
            "sample_batched() shape")
    ref = matcher.sample(warp[1], cert[1], 10000, torch.Generator(device=warp.device).manual_seed(1))
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
    # cuBLAS's workspace for deterministic GEMMs (the SfM phase's comparison
    # under torch.use_deterministic_algorithms); Hopper's default size
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
    from roma_torch.benchmarks.pose_backends import bind_native
    from roma_torch.kernels import runtime
    from roma_torch.models.zoo import roma_outdoor

    card = gpu_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    planted_dir = tempfile.TemporaryDirectory()
    planted = start_planted_build(Path(planted_dir.name))  # beside the main build
    # the native estimator (g++) builds beside the kernels too; run_eval waits for it
    threading.Thread(target=bind_native, daemon=True).start()
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
    report["eval"] = run_eval(matcher, card, out_dir if args.profile else None)
    report["tail"] = run_tail(matcher, dev, gen, card)
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
    rows["kde"] = check_kde(dev, gen)
    print_rows(card, rows, "kde")
    print(f"[{card}] kde ragged (max relative error): {rows['kde'][0]['ragged']}; against the "
          f"plain version (max relative difference): {rows['kde'][0]['vs_plain']}", flush=True)
    report["tiny"] = run_tiny(dev, gen, card, out_dir if args.profile else None)
    rows["windowed_sample"] = check_windowed_sample(dev, gen, cfg)
    print_rows(card, rows, "windowed_sample")
    print_windowed(card, rows["windowed_sample"])
    report["smooth_warp"] = run_smooth_warp(dev, gen, card)
    torch.cuda.empty_cache()
    report["train"] = run_training(dev, gen, card, out_dir if args.profile else None)
    torch.cuda.empty_cache()
    report["debug_train_step"] = check_debug_train_step(dev, card)
    torch.cuda.empty_cache()
    report["vit_swiglu"] = run_vit_swiglu(dev, gen, card, out_dir if args.profile else None)
    torch.cuda.empty_cache()
    report["tiny_train"] = run_tiny_training(dev, gen, card, out_dir if args.profile else None)
    torch.cuda.empty_cache()
    report["sfm"] = run_sfm(dev, card, out_dir if args.profile else None)

    # each kernel's launches come from the run of the path it serves
    train = report["train"]["launches"]
    path_launches = dict(launches, corr_softmax=report["tiny"]["launches"]["corr_softmax"],
                         windowed_sample=report["smooth_warp"]["launches"]["windowed_sample"],
                         flash_attn_dkv=train["flash_attn_dkv"],
                         flash_attn_dq=train["flash_attn_dq"],
                         kde=report["match_raw"]["sample_launches"]["kde"])
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
