#!/usr/bin/env python3
"""Times builds of the local-correlation kernel (K1) against each other on
one GPU.

    python3 k1_variants.py SOURCE [SOURCE ...] [--out DIR]

Each SOURCE is a `local_corr.cu` (this checkout's is
roma_torch/csrc/local_corr.cu; another checkout's or an edited copy's to
compare), built with this checkout's nvcc flags and headers. Its C entry
is told by its text: the first version's (f0, f1, flow, out, ...), or
this one's with the tile map and the score buffer. At the main path's five
K1 shapes (B' = 4: coarse 40^2 x 512 r 7, 70^2 x 512 r 3, 140^2 x 256 r 2;
upsample 108^2 x 512 r 3, 216^2 x 256 r 2), on a scattered flow
(identity + 0.3 N(0, 1)) and a smooth one (`chip_smoke.smooth_sine_grid`),
each source is timed (CUDA events, mean of 30 launches) in the order
given and then in reverse, and checked against the plain version. Prints
the ptxas register report of each build and one line per shape and flow;
results go to DIR/k1_variants.json. Exits non-zero without a GPU, or if a
build fails or a launch returns an error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = (("coarse s16", 40, 512, 7), ("coarse s8", 70, 512, 3), ("coarse s4", 140, 256, 2),
          ("upsample s8", 108, 512, 3), ("upsample s4", 216, 256, 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "k1_variants")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from roma_torch.kernels import runtime
    from roma_torch.ops.corr import coord_grid
    from roma_torch.ops.local_corr import local_correlation as plain

    dev = torch.device("cuda", 0)
    runtime.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, report = {}, {"card": chip_smoke.gpu_line(), "ptxas": {}, "rows": []}
    for i, src in enumerate(args.sources):
        lib = runtime.BUILD_DIR / f"k1_variant{i}.so"
        r = subprocess.run([runtime.nvcc(), *runtime.NVCC_FLAGS, "-I", str(runtime.CSRC),
                            "-o", str(lib), str(src)], capture_output=True, text=True)
        if r.returncode:
            print(f"k1_variants: build of {src} failed\n{r.stdout}{r.stderr}", file=sys.stderr)
            return 1
        regs = [ln.split(":", 1)[1].strip() for ln in (r.stdout + r.stderr).splitlines()
                if "registers" in ln]
        report["ptxas"][str(src)] = regs
        print(f"{src}: " + " | ".join(regs), flush=True)
        text = src.read_text()
        kind = 2 if "void* scores" in text else (1 if "void* tile_paths" in text else 0)
        fn = ctypes.CDLL(str(lib)).roma_local_corr
        fn.argtypes = ([ctypes.c_void_p] * (4 + kind) + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[str(src)] = (fn, kind)

    def run(src, f0, f1, r, fl):
        fn, kind = libs[src]
        B, H, W, C = f0.shape
        out = torch.empty((B, H, W, (2 * r + 1) ** 2), device=dev)
        extra = []
        if kind >= 1:  # the tile map; this checkout's entry takes null below r = 5
            extra.append(torch.empty((B, -(-H // 8), -(-W // 8)), dtype=torch.int32, device=dev)
                         if kind == 1 or r >= 5 else None)
        if kind == 2:
            extra.append(torch.empty((B, H, W, (2 * r + 2) ** 2), device=dev) if r >= 5 else None)
        scale = (1.0 / torch.sqrt(torch.tensor(float(C)))).item()
        rc = fn(f0.data_ptr(), f1.data_ptr(), fl.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in extra),
                B, H, W, C, r, scale, runtime.stream_handle(f0))
        if rc != 0:
            raise RuntimeError(f"k1_variants: {src} returned {rc}")
        return out

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    B = 2 * chip_smoke.PAIRS
    for label, h, C, r in SHAPES:
        f0 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        f1 = torch.randn((B, h, h, C), generator=gen, device=dev).to(torch.bfloat16)
        scattered = (coord_grid(h, h, device=dev).expand(B, h, h, 2)
                     + 0.3 * torch.randn((B, h, h, 2), generator=gen, device=dev)).contiguous()
        for kind, fl in (("scattered", scattered), ("smooth", chip_smoke.smooth_sine_grid(B, h, h, dev))):
            ref = plain(f0, f1, r, fl)
            ms = {s: [] for s in libs}
            err = {}
            for order in (list(libs), list(libs)[::-1]):
                for src in order:
                    err[src] = (run(src, f0, f1, r, fl) - ref).abs().max().item()
                    ms[src].append(chip_smoke.cuda_ms(lambda: run(src, f0, f1, r, fl), 30))
            row = dict(shape=label, flow=kind, ms=ms, max_abs_err=err)
            report["rows"].append(row)
            print(f"[{report['card']}] {label} {kind}: " + "; ".join(
                f"{Path(s).parent.name}/{Path(s).name} {v[0]:.4f} / {v[1]:.4f} ms "
                f"(err {err[s]:.1e})" for s, v in ms.items()), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "k1_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
