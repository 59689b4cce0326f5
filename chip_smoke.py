#!/usr/bin/env python3
"""Chip smoke test of the roma_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out DIR]

1. prints the card's name and power limit (nvidia-smi);
2. builds the three CUDA kernels from roma_torch/csrc (one nvcc each, in
   parallel) into build/kernels/;
3. builds full-width roma_outdoor() (ViT-L/14 24 blocks, 560 -> 864,
   symmetric, bf16) with random weights from seed 0;
4. holds every kernel against its plain PyTorch version at each shape the
   main path gives it (2 pairs per match), and times the kernel, the plain
   version and, where one exists, the single PyTorch call computing the
   same function (SDPA for attention);
5. runs RomaMatcher.match on 2 pairs: once to warm up, once with the launch
   counters reset just before it and read just after it (each kernel must
   show exactly its expected launches), and 3 more times for the rate;
   with --profile, one more run under torch.profiler;
6. checks the outputs (shapes, finite, certainty in [0, 1], sampling) and
   holds the debug-size model on the GPU against the same weights run on
   the CPU through the plain versions;
7. prints the kernels JSON line, then {"ok": true, "device": ...} last.

Any failure exits non-zero before the last line. Detailed per-shape results
go to DIR/chip_smoke.json (default results/chip_smoke/).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PAIRS = 2                  # pairs per match(); symmetric -> 4 images per pass
SEED = 0                   # weights and data

# kernel -> (TPU kernel it replaces, CUDA source)
KERNELS = {
    "local_corr": ("roma_tpu/ops/pallas/block_gather.py:194",
                   "roma_torch/csrc/local_corr.cu"),
    "dw_chain": ("roma_tpu/ops/pallas/depthwise.py:404",
                 "roma_torch/csrc/dw_chain.cu"),
    "flash_attn": ("roma_tpu/models/transformer.py:22",
                   "roma_torch/csrc/flash_attn.cu"),
}


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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    tb, tf = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------- kernel checks

def check_local_corr(dev, gen, cfg):
    """Refiners 16/8/4 in both passes: (name, B', h, w, C, r, calls per match)."""
    import torch

    from roma_torch.kernels import local_corr as lc
    from roma_torch.ops.corr import coord_grid
    from roma_torch.ops.local_corr import corner_coords

    hc, hu = cfg.coarse_resolution[0], cfg.upsample_resolution[0]
    shapes = [("coarse s16", hc // 14, 512, 7), ("coarse s8", hc // 8, 512, 3),
              ("coarse s4", hc // 4, 256, 2), ("upsample s8", hu // 8, 512, 3),
              ("upsample s4", hu // 4, 256, 2)]
    B = 2 * PAIRS
    rows = []
    for label, h, C, r in shapes:
        f0 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        f1 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        flow = (coord_grid(h, h, device=dev).expand(B, h, h, 2)
                + 0.3 * torch.randn((B, h, h, 2), generator=gen, device=dev)).contiguous()
        flow[0, 0, 0] = torch.tensor([40.0, -40.0], device=dev)  # far out of range
        got = lc.local_correlation(f0, f1, r, flow)
        ref = lc.local_correlation_plain(f0, f1, r, flow)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        fail_if(not math.isfinite(err) or err > 1e-3, f"local_corr {label}: max_abs_err {err}")
        fail_if(bool((got[0, 0, 0] != 0).any()), f"local_corr {label}: out-of-range pixel not zero")
        # data-dependent work: only in-range corners are read and dotted
        x0, y0, _, _ = corner_coords(flow, h, h, r)
        d = torch.arange(2 * r + 2, device=dev) - r
        nx = ((x0[..., None] + d >= 0) & (x0[..., None] + d < h)).sum(-1)
        ny = ((y0[..., None] + d >= 0) & (y0[..., None] + d < h)).sum(-1)
        corners = float((nx * ny).sum().item())
        k2 = (2 * r + 1) ** 2
        n_pix = B * h * h
        flops = corners * 2 * C + n_pix * (C + 7 * k2)
        nbytes = 2 * n_pix * C * 2 + n_pix * 2 * 4 + n_pix * k2 * 4
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(shape=label, dims=[B, h, h, C], radius=r, calls=1,
                         max_abs_err=err, tol=1e-3,
                         ms=cuda_ms(lambda: lc.local_correlation(f0, f1, r, flow), 20),
                         plain_ms=cuda_ms(lambda: lc.local_correlation_plain(f0, f1, r, flow), 3, 1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_dw_chain(dev, gen, cfg, model):
    import torch

    from roma_torch.kernels import dw_chain

    refiner = model.decoder.conv_refiner["1"]
    dt = torch.bfloat16
    cols = [blk.fused(dt) for blk in refiner.blocks()]
    params = [torch.stack([c[i] for c in cols]).contiguous() for i in range(5)]
    N, C = params[0].shape[0], params[0].shape[-1]
    B = 2 * PAIRS
    rows = []
    for label, h in (("coarse s1", cfg.coarse_resolution[0]),
                     ("upsample s1", cfg.upsample_resolution[0])):
        x = torch.randn((B, C, h, h), generator=gen, device=dev).to(dt)
        got = dw_chain.chain_nchw(x, *params)
        ref = dw_chain.chain_plain_nchw(x, *params)
        torch.cuda.synchronize()
        scale = max(1.0, ref.float().abs().max().item())
        err = (got.float() - ref.float()).abs().max().item()
        tol = 3e-2 * scale
        fail_if(not math.isfinite(err) or err > tol, f"dw_chain {label}: max_abs_err {err} > {tol}")
        n_pix = B * h * h
        flops = N * n_pix * (25 * C * 2 + C * C * 2 + 4 * C)
        nbytes = 2 * n_pix * C * 2 + N * (25 * C * 2 + C * C * 2 + 3 * C * 4)
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(shape=label, dims=[B, C, h, h], blocks=N, calls=1,
                         max_abs_err=err, tol=tol,
                         ms=cuda_ms(lambda: dw_chain.chain_nchw(x, *params), 10),
                         plain_ms=cuda_ms(lambda: dw_chain.chain_plain_nchw(x, *params), 3, 1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_flash_attn(dev, gen, cfg):
    import torch
    import torch.nn.functional as F

    from roma_torch.kernels import attention as at

    B = 2 * PAIRS
    n16 = (cfg.coarse_resolution[0] // 14) * (cfg.coarse_resolution[1] // 14)
    shapes = [("dinov2", n16 + 1, cfg.dinov2_heads, cfg.dinov2_dim // cfg.dinov2_heads,
               cfg.dinov2_depth),
              ("decoder", n16, cfg.decoder_heads, cfg.decoder_dim // cfg.decoder_heads,
               cfg.num_decoder_blocks)]
    rows = []
    for label, n, H, d, calls in shapes:
        # views of a fused qkv projection, as Attention passes them
        qkv = torch.randn((B, n, 3, H, d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        got = at.attention(q, k, v)
        ref = at.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        fail_if(not math.isfinite(err) or err > 2e-2, f"flash_attn {label}: max_abs_err {err}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * B * H * n * n * d
        nbytes = 4 * B * n * H * d * 2
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(shape=label, dims=[B, n, H, d], calls=calls,
                         max_abs_err=err, tol=2e-2,
                         ms=cuda_ms(lambda: at.attention(q, k, v), 20),
                         plain_ms=cuda_ms(lambda: at.attention_plain(q, k, v), 5, 1),
                         library_ms=cuda_ms(
                             lambda: F.scaled_dot_product_attention(qt, kt, vt), 20),
                         bound_ms=b_ms, bound_by=b_by))
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


def profile_match(matcher, gen, dev, out_dir: Path) -> dict:
    """torch.profiler over one match(): device time per labelled stage
    (the roma.* ranges), the busy share of the wall time, and the top
    kernels by device time (table written to out_dir)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    h, w = matcher.cfg.coarse_resolution
    a, b = (torch.rand((PAIRS, h, w, 3), generator=gen, device=dev) for _ in range(2))
    timed_match(matcher, a, b)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall_s = timed_match(matcher, a, b)
    events = prof.key_averages()
    dev_total = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    dev_self = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    # the roma.* ranges show up twice: as host ranges and as device spans
    stages = {e.key: dev_total(e) / 1e3 for e in events if e.key.startswith("roma.")}
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("roma.")]
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_self, reverse=True)[:25]
    (out_dir / "profile_match.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall_s * 1e3), "stages_device_ms": stages,
            "top_kernels_ms": {e.key[:80]: dev_self(e) / 1e3 for e in top}}


def check_outputs(matcher, warp, cert):
    import torch

    hs, ws = matcher.cfg.upsample_resolution
    fail_if(tuple(warp.shape) != (PAIRS, hs, 2 * ws, 4), f"warp shape {tuple(warp.shape)}")
    fail_if(tuple(cert.shape) != (PAIRS, hs, 2 * ws), f"certainty shape {tuple(cert.shape)}")
    fail_if(not bool(torch.isfinite(warp).all()), "warp has non-finite values")
    fail_if(not bool(torch.isfinite(cert).all()), "certainty has non-finite values")
    fail_if(cert.min().item() < 0 or cert.max().item() > 1, "certainty outside [0, 1]")
    fail_if(warp.abs().max().item() > 1, "warp outside [-1, 1]")
    gen = torch.Generator(device=warp.device).manual_seed(0)
    m, c = matcher.sample(warp[0], cert[0], num=10000, generator=gen)
    fail_if(tuple(m.shape) != (10000, 4) or tuple(c.shape) != (10000,), "sample() shape")


def check_small_reference(seed: int, dev):
    """Debug-size model (full widths, 2 ViT blocks, 112 -> 224) on the GPU
    through the kernels against the same weights on the CPU through the
    plain versions, both bf16. Differences come from bf16 rounding in other
    places (cuDNN vs CPU convolutions), so the check is on robust summaries:
    median |warp difference| < 0.02 and mean |certainty difference| < 0.05."""
    import torch

    from roma_torch.models.zoo import debug_roma_config, roma_outdoor

    cfg = debug_roma_config()
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
               mean_cert_diff=dc.mean().item(), max_cert_diff=dc.max().item())
    fail_if(res["median_warp_diff"] >= 0.02 or res["mean_cert_diff"] >= 0.05,
            f"GPU vs CPU debug model disagree: {res}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one match() with torch.profiler")
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "chip_smoke",
                    help="directory for chip_smoke.json and the profile table")
    args = ap.parse_args()

    import torch

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
    report["ptxas"] = runtime.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"[{card}] built {len(runtime.SOURCES)} kernels in {report['build_s']:.1f} s", flush=True)

    t0 = time.perf_counter()
    matcher = roma_outdoor(seed=SEED, device=dev)
    torch.cuda.synchronize()
    report["model_build_s"] = time.perf_counter() - t0
    cfg = matcher.cfg

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {
        "local_corr": check_local_corr(dev, gen, cfg),
        "dw_chain": check_dw_chain(dev, gen, cfg, matcher.model),
        "flash_attn": check_flash_attn(dev, gen, cfg),
    }
    report["kernel_rows"] = rows
    for name, rs in rows.items():
        for r in rs:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"[{card}] {name} {r['shape']} {r['dims']}: err {r['max_abs_err']:.3e} "
                  f"(tol {r['tol']:.1e}) kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
                  flush=True)

    expected = {
        "local_corr": sum(1 for s in ("16", "8", "4") if cfg.refiners[s].local_corr_radius)
        + sum(1 for s in ("8", "4") if cfg.refiners[s].local_corr_radius),
        "dw_chain": 2 * (1 + cfg.refiners["1"].hidden_blocks),
        "flash_attn": cfg.dinov2_depth + cfg.num_decoder_blocks,
    }
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
        report["profile"] = profile_match(matcher, gen, dev, out_dir)
        print(f"[{card}] profile: {json.dumps(report['profile'])}", flush=True)
    del matcher
    torch.cuda.empty_cache()
    report["small_reference"] = check_small_reference(SEED, dev)
    print(f"[{card}] debug model GPU vs CPU: {report['small_reference']}", flush=True)

    kernels = [summarize(name, rows[name], launches[name]) for name in KERNELS]
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
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
