#!/usr/bin/env python3
"""Times builds of one kernel against each other on one GPU: local
correlation (K1), the whole-block kernel (K5), the windowed gather (K6) or
flash attention's backward (K8 and K9).

    python3 kernel_variants.py {k1,k5,k6,k89} SOURCE [SOURCE ...] [--out DIR]

Each SOURCE is a `local_corr.cu` (k1), `dw_block_mm.cu` (k5),
`windowed_sample.cu` (k6) or `flash_attn_bwd.cu` (k89): this checkout's
own (roma_torch/csrc/),
another checkout's, or an edited copy to compare (a design alternative, or
an ablation that leaves a phase out), built with this checkout's nvcc
flags and headers. Every source must have this checkout's C entry; a K5
build reports its own shared memory (`roma_dw_block_mm_smem`). Shapes: K1 at the main path's
five (B' = 4: coarse 40^2 x 512 r 7, 70^2 x 512 r 3, 140^2 x 256 r 2;
upsample 108^2 x 512 r 3, 216^2 x 256 r 2) on a scattered flow (identity
+ 0.3 N(0, 1)) and a smooth one (`chip_smoke.smooth_sine_grid`); K5 at
chip_smoke.py's DW_BLOCK_MM_SHAPES; K6 on the scale-1 maps of both passes
(4 x 9 x 560^2 and 864^2, bf16, channels last) at a smooth and a random
flow in "fast" and "exact" mode, and, once for all builds, the
plain-torch plan and edge-padded grid copy that the first version of K6
ran before each launch (`first_plan`; CUDA events, mean of 10 calls, host
time included); K8 and K9, each alone, in bf16 at the match decoder's
training shape (2, 1600, 8, 128) and DINOv2's (4, 1601, 16, 64), q, k and
v as views of a fused qkv, with each build's launch (blocks, blocks an SM
holds, SMs: `roma_flash_attn_bwd_grid`, where the build has it). Each
build is checked against the plain version (a build that leaves work out
reports its error and is timed all the same) and timed (K1: CUDA events,
mean of 30 calls; K5 and K8/K9: of 20; K6: the device time of a CUDA-graph
replay of 20 calls, median of 5), in the order given and then in reverse;
both readings are kept.
Prints the ptxas report of each build (registers, spills, performance
notes) and one line per case;
results go to DIR/<kernel>_variants.json. Exits non-zero without a GPU, or
if a build fails or a launch returns an error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build(sources, kernel):
    """One library a source, all nvcc started together."""
    from roma_torch.kernels import runtime

    runtime.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        lib = runtime.BUILD_DIR / f"{kernel}_variant{i}.so"
        procs.append((src, lib, subprocess.Popen(
            [runtime.nvcc(), *runtime.NVCC_FLAGS, "-I", str(runtime.CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = [], {}
    for src, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kernel_variants: build of {src} failed\n{text}")
        ptxas[str(src)] = [ln.split(":", 1)[-1].strip() for ln in text.splitlines()
                           if any(w in ln for w in ("registers", "spill", "Performance"))]
        libs.append(ctypes.CDLL(str(lib)))
    return libs, ptxas


def k1_cases(libs, sources, dev, gen):
    import torch

    import chip_smoke
    from roma_torch.kernels import runtime
    from roma_torch.kernels.local_corr import SHARE_MIN_R
    from roma_torch.ops.corr import coord_grid
    from roma_torch.ops.local_corr import local_correlation as plain

    fns = []
    for lib in libs:
        fn = lib.roma_local_corr
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)

    def call(fn, f0, f1, r, fl):
        B, H, W, C = f0.shape
        out = torch.empty((B, H, W, (2 * r + 1) ** 2), device=dev)
        extra = [None, None]  # the tile map and the shared tiles' scores, from SHARE_MIN_R
        if r >= SHARE_MIN_R:
            extra = [torch.empty((B, -(-H // 8), -(-W // 8)), dtype=torch.int32, device=dev),
                     torch.empty((B, H, W, (2 * r + 2) ** 2), device=dev)]
        scale = (1.0 / torch.sqrt(torch.tensor(float(C)))).item()
        rc = fn(f0.data_ptr(), f1.data_ptr(), fl.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in extra),
                B, H, W, C, r, scale, runtime.stream_handle(f0))
        if rc:
            raise SystemExit(f"kernel_variants: k1 launch failed ({rc})")
        return out

    B = 2 * chip_smoke.PAIRS
    for label, h, C, r in (("coarse s16", 40, 512, 7), ("coarse s8", 70, 512, 3),
                           ("coarse s4", 140, 256, 2), ("upsample s8", 108, 512, 3),
                           ("upsample s4", 216, 256, 2)):
        f0 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        f1 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        scattered = (coord_grid(h, h, device=dev).expand(B, h, h, 2)
                     + 0.3 * torch.randn((B, h, h, 2), generator=gen, device=dev)).contiguous()
        for kind, fl in (("scattered", scattered),
                         ("smooth", chip_smoke.smooth_sine_grid(B, h, h, dev))):
            ref = plain(f0, f1, r, fl)
            errs = [(call(f, f0, f1, r, fl) - ref).abs().max().item() for f in fns]
            yield f"{label} {kind}", errs, [lambda f=f: call(f, f0, f1, r, fl) for f in fns], \
                lambda fn: chip_smoke.cuda_ms(fn, 30)


def k5_cases(libs, sources, dev, gen):
    import torch

    import chip_smoke
    from roma_torch.kernels import runtime
    from roma_torch.kernels.dw_chain import block_plain_nchw

    fns = []
    for lib in libs:
        fn, smem = lib.roma_dw_block_mm, lib.roma_dw_block_mm_smem
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_longlong
        fns.append((fn, smem))

    def call(f, x, w, sc, sh, m, bias):
        fn, smem = f
        B, C, H, W = x.shape
        z = torch.empty_like(x)
        rc = fn(x.data_ptr(), z.data_ptr(), w.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                m.data_ptr(), bias.data_ptr(), B, C, H, W, smem(C), runtime.stream_handle(x))
        if rc:
            raise SystemExit(f"kernel_variants: k5 launch failed ({rc})")
        return z

    for label, B, C, h in chip_smoke.DW_BLOCK_MM_SHAPES:
        x, w, sc, sh = chip_smoke.dw_inputs(gen, dev, B, C, h, h, torch.bfloat16)
        m = (0.2 * torch.randn((C, C), generator=gen, device=dev)).to(torch.bfloat16)
        bias = 0.1 * torch.randn((C,), generator=gen, device=dev)
        args = (x, w, sc, sh, m, bias)
        ref = block_plain_nchw(*args).float()
        errs = [(call(f, *args).float() - ref).abs().max().item() for f in fns]
        yield label, errs, [lambda f=f: call(f, *args) for f in fns], \
            lambda fn: chip_smoke.cuda_ms(fn, 20)


def k6_cases(libs, sources, dev, gen):
    import torch

    import chip_smoke
    from roma_torch.kernels import runtime
    from roma_torch.ops import windowed_sample as ows
    from roma_torch.ops.grid_sample import grid_sample_nchw

    fns = []
    for lib in libs:
        fn = lib.roma_windowed_sample
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)

    def call(fn, feat, g, exact):
        B, C, H, W = feat.shape
        out = torch.empty((B, C) + tuple(g.shape[1:3]), dtype=feat.dtype, device=dev)
        rc = fn(feat.data_ptr(), g.data_ptr(), out.data_ptr(), None, None, B, C, H, W,
                g.shape[1], g.shape[2], ows.frame_width(W), 0, int(exact),
                runtime.stream_handle(feat))
        if rc:
            raise SystemExit(f"kernel_variants: k6 launch failed ({rc})")
        return out

    for h, f, flows in k6_inputs(dev, gen):
        for name, g in flows.items():
            for exact in (False, True):
                ref = (grid_sample_nchw(f, g) if exact else
                       ows.windowed_sample_plain(f, ows.pad_grid(g), (h, h))).float()
                errs = [(call(fn, f, g, exact).float() - ref).abs().max().item() for fn in fns]
                label = f"{h} {name} {'exact' if exact else 'fast'}"
                yield label, errs, [lambda fn=fn, g=g, e=exact: call(fn, f, g, e) for fn in fns], \
                    lambda fn: chip_smoke.median(chip_smoke.graph_ms_rounds(fn, 20))


def k89_cases(libs, sources, dev, gen):
    import torch

    import chip_smoke
    from roma_torch.kernels import attention as at

    for label, dims in (("decoder train", (2, 1600, 8, 128)), ("dinov2", (4, 1601, 16, 64))):
        B, N, H, d = dims
        qkv = torch.randn((B, N, 3, H, d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        dout = torch.randn((B, N, H, d), generator=gen, device=dev).to(torch.bfloat16)
        o, lse = at.attention_cuda(q, k, v, with_lse=True)
        args = (q, k, v, dout, lse, at.attention_di(o, dout), 0)
        ref = at.attention_bwd_plain(q, k, v, o, lse, dout)
        outs = tuple(torch.empty_like(q) for _ in range(3))
        for which, grads in (("dkv", (1, 2)), ("dq", (0,))):
            errs = []
            for lib in libs:
                got = chip_smoke.bwd_lib_call(lib, *args, (which,))
                errs.append(max((got[i].float() - ref[i]).abs().max().item() for i in grads))
            yield f"{label} {list(dims)} {which}", errs, \
                [lambda lib=lib, w=which: chip_smoke.bwd_lib_call(lib, *args, (w,), outs)
                 for lib in libs], lambda fn: chip_smoke.cuda_ms(fn, 20)


def k6_inputs(dev, gen):
    """(h, channels-last bf16 map (4, 9, h, h), {flow name: grid}) at both
    scale-1 shapes."""
    import torch

    import chip_smoke

    for h in (560, 864):
        feat = torch.randn((4, 9, h, h), generator=gen, device=dev).to(torch.bfloat16)
        flows = {"smooth": chip_smoke.smooth_sine_grid(4, h, h, dev),
                 "random": (torch.rand((4, h, h, 2), generator=gen, device=dev) * 2 - 1)}
        yield h, feat.contiguous(memory_format=torch.channels_last), \
            {n: g.contiguous() for n, g in flows.items()}


def k6_first_plan(dev, gen):
    """ms of the host-side work the first version of K6 did before each
    launch: the edge-padded copy of the grid, the plain-torch plan and the
    stacked per-tile origins, at each shape and flow."""
    import torch

    import chip_smoke
    from roma_torch.ops import windowed_sample as ows

    def first_plan(feat, grid):
        gp = ows.pad_grid(grid.float())
        p = ows.plan(feat, gp, tuple(grid.shape[1:3]))
        return gp, torch.stack([p.ybase, p.j0_abs], dim=-1).reshape(feat.shape[0], -1, 2).contiguous()

    return {f"{h} {name}": chip_smoke.cuda_ms(lambda: first_plan(f, g), 10)
            for h, f, flows in k6_inputs(dev, gen) for name, g in flows.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("k1", "k5", "k6", "k89"))
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "kernel_variants")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    libs, ptxas = build(args.sources, args.kernel)
    report = {"card": chip_smoke.gpu_line(), "sources": [str(s) for s in args.sources],
              "ptxas": ptxas, "rows": []}
    print(report["card"], flush=True)
    for src, regs in ptxas.items():
        print(f"{src}: {regs}", flush=True)
    cases = {"k1": k1_cases, "k5": k5_cases, "k6": k6_cases, "k89": k89_cases}[args.kernel]
    if args.kernel == "k89":  # each build's launch at the decoder's training shape
        report["grids"] = [chip_smoke.bwd_grid(lib, 2, 1600, 8, 128, 0)
                           if hasattr(lib, "roma_flash_attn_bwd_grid") else None for lib in libs]
        print(f"launch at (2, 1600, 8, 128): {json.dumps(report['grids'])}", flush=True)
    n = len(libs)
    for label, errs, calls, timer in cases(libs, args.sources, dev, gen):
        ms = [[] for _ in range(n)]
        for i in list(range(n)) + list(reversed(range(n))):
            ms[i].append(timer(calls[i]))
        report["rows"].append(dict(case=label, ms=ms, max_abs_err=errs))
        print(f"{label}: " + "; ".join(
            f"{s.parent.name}/{s.name} {t[0]:.4f} / {t[1]:.4f} ms (err {e:.2e})"
            for s, t, e in zip(args.sources, ms, errs)), flush=True)
    if args.kernel == "k6":
        report["first_plan_ms"] = k6_first_plan(dev, gen)
        print(f"first version's plan + padding, ms a call: {json.dumps(report['first_plan_ms'])}",
              flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"{args.kernel}_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
