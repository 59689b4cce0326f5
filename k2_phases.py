#!/usr/bin/env python3
"""Phase breakdown of the chained scale-1 block kernel (K2) on one GPU.

    python3 k2_phases.py [--out DIR]

Copies roma_torch into DIR once per variant, with phases of
csrc/dw_chain.cu switched off (the TMA halo load, the widening to float
rows, the depthwise pass, the mix, the store), builds each copy's K2 and
times one launch at the main path's two shapes (4 x 24 x 560^2 and 864^2;
median of 5 replays of a CUDA graph of 20 launches). A copy with a phase
off computes garbage: only its time means anything, against "all" with
every phase on. Exits non-zero without a GPU, or if a phase's source text
is not found (the kernel changed). Results go to DIR/k2_phases.json.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# phase -> (text in csrc/dw_chain.cu, its replacement with the phase off)
PHASES = {
    "stage": ("""mbar_expect_tx(bar, 2u * C * G::kRows * kSLD);
        tma_load_4d(smem_addr(stage), &xmap, bar, x0 - 8, y0 - 2, 0, b);""",
              "mbar_arrive(bar);"),
    "widen": ("const int n = C * G::kRows * kUnits;", "const int n = 0;"),
    "depthwise": ("for (int c = c_first, p = p_first; p < G::kPatches;)",
                  "for (int c = c_first, p = p_first; false;)"),
    "mix": ("        if (n0 >= G::kPix) break;  // warp-uniform",
            "        if (n0 >= 0) break;  // warp-uniform"),
    "store": ("const int n = C * TH * kChunks;", "const int n = 0;"),
}
# variant -> phases switched off
VARIANTS = {
    "all": (),
    **{f"no_{p}": (p,) for p in PHASES},
    **{f"only_{p}": tuple(q for q in PHASES if q != p) for p in PHASES},
    "loop_only": tuple(PHASES),
}
SHAPES = ((4, 24, 560), (4, 24, 864))


def time_package(pkg: Path) -> dict:
    """Times one K2 launch from the roma_torch under `pkg`; run in a
    process of its own, since the package is imported from there."""
    sys.path.insert(0, str(pkg))
    import torch

    from roma_torch.kernels import dw_chain, runtime

    runtime.build(["dw_chain"])
    lib, fn = dw_chain._kernel()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for B, C, h in SHAPES:
        x = torch.randn((B, C, h, h), generator=gen, device=dev).to(torch.bfloat16)
        z = torch.empty_like(x)
        ws = (0.2 * torch.randn((1, 5, 5, C), generator=gen, device=dev)).to(torch.bfloat16)
        ms = (0.2 * torch.randn((1, C, C), generator=gen, device=dev)).to(torch.bfloat16)
        vec = [0.5 + torch.rand((1, C), generator=gen, device=dev) for _ in range(3)]
        taps, mt, bias = dw_chain.pack_params(ws, vec[0], vec[1], ms, vec[2])
        plan = dw_chain.tile_plan(B, C, h, h)

        def launch():
            rc = fn(x.data_ptr(), z.data_ptr(), taps.data_ptr(), mt.data_ptr(), bias.data_ptr(),
                    B, C, h, h, plan.smem_bytes, runtime.stream_handle(x))
            runtime.check(lib, dw_chain.NAME, rc)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            launch()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                launch()
        times = []
        for _ in range(5):
            graph.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 20)
        out[f"{B}x{C}x{h}^2"] = sorted(times)[2]
        del graph
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "k2_phases")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)  # internal: one package
    args = ap.parse_args()
    if args.time is not None:
        print(json.dumps(time_package(args.time)))
        return 0

    import torch

    src = (ROOT / "roma_torch" / "csrc" / "dw_chain.cu").read_text()
    for name, (text, _) in PHASES.items():
        if src.count(text) != 1:
            print(f"k2_phases: the {name} phase's text is not in dw_chain.cu once", file=sys.stderr)
            return 1
    if not torch.cuda.is_available():
        print("k2_phases: no GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = {}
    for variant, off in VARIANTS.items():
        text = src
        for p in off:
            text = text.replace(*PHASES[p])
        pkg = args.out / variant
        shutil.rmtree(pkg, ignore_errors=True)
        shutil.copytree(ROOT / "roma_torch", pkg / "roma_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (pkg / "roma_torch" / "csrc" / "dw_chain.cu").write_text(text)
        run = subprocess.run([sys.executable, __file__, "--time", str(pkg)],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            print(f"k2_phases: {variant} failed:\n{run.stderr[-3000:]}", file=sys.stderr)
            return 1
        results[variant] = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"[{card}] {variant} (off: {', '.join(off) or 'none'}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in results[variant].items()), flush=True)
    (args.out / "k2_phases.json").write_text(json.dumps({"card": card, "ms": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
