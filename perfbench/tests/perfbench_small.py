"""Cells of BENCHMARK.json at sizes a CPU test run holds: the same code
paths, the debug widths of full RoMa (two ViT blocks, one decoder block,
one hidden block a refiner, 112 -> 224; training: 2 pairs at 112^2, the
three followed steps over a pool of 3) and narrow Tiny matchers."""

from __future__ import annotations

import copy
import dataclasses

from perfbench.core import cells

ROMA = dict(coarse_resolution=[112, 112], upsample_resolution=[224, 224])
TRAFFIC_ROMA = dict(canvas=[160, 160], sizes=[[120, 160], [160, 120], [160, 106], [106, 160]],
                    num=500, pool=2, warmup=1, checked=1, profiled_calls=2)
TRAFFIC_TRAIN = dict(pairs=2, resolution=[112, 112], pool=3, texture=256, profiled_calls=2)
TINY = dict(match_dim=32, fine_match_dim=16)
TRAFFIC_TINY = dict(canvas=[64, 96], sizes=[[64, 96]], pairs=2, pool=2, warmup=1, checked=1,
                    profiled_calls=2)


def small(name: str, dtype: str = "float32", **traffic) -> cells.Cell:
    cell = cells.load(name)
    cfg = copy.deepcopy(cell.cfg)
    cfg["dtype"] = dtype
    t = dict(cell.traffic)
    if cfg["family"] == "roma":
        cfg.update(ROMA)
        cfg["dinov2"]["depth"] = 2
        cfg["decoder"]["blocks"] = 1
        for r in cfg["refiners"].values():
            r["hidden_blocks"] = 1
        t.update(TRAFFIC_TRAIN if "followed" in t else TRAFFIC_ROMA)
    else:
        cfg.update(TINY)
        t.update(TRAFFIC_TINY, num=min(t["num"], 300))
    t.update(traffic)
    return dataclasses.replace(cell, cfg=cfg, traffic=t)
