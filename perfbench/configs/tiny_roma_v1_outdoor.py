"""tiny_roma_v1_outdoor: the port's `TinyRomaMatcher` driven as users drive it
from host images (uint8 images uploaded and made float in [0, 1],
`match(batched=True)`, then per pair `sample` and the matches read back,
or the dense warp left on the device), and its plain reference
(`perfbench/reference/tiny.py`). Where the traffic keeps calls in flight
(`in_flight` > 1, the warp left on the device), the images come from
pinned host memory, as a loader with `pin_memory` hands them, and are
uploaded without blocking the host."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from perfbench.core.program import Outputs, counted, synchronize
from perfbench.reference.tiny import TinyRoma


def reference_model(cfg: dict) -> torch.nn.Module:
    return TinyRoma(cfg)


def reference_dense(model, prec, batch, device, cfg):
    x = torch.from_numpy(batch.raw).to(device).float() / 255.0
    B = x.shape[0] // 2
    return model.match(prec, x[:B], x[B:])


def port_config(cfg: dict):
    from roma_torch.config import TinyRomaConfig

    keys = ("coarse_dim", "fine_dim", "match_dim", "fine_match_dim", "num_matcher_blocks",
            "exact_softmax", "fused_kernel", "search_mode", "coarse_iters", "sample_thresh",
            "dtype")
    return TinyRomaConfig(**{k: cfg[k] for k in keys})


class Program:
    def __init__(self, cfg: dict, traffic: dict, state: dict, device):
        from roma_torch.models.tiny_roma import TinyRoma as PortTinyRoma
        from roma_torch.models.tiny_roma import TinyRomaMatcher

        with torch.device("meta"):
            model = PortTinyRoma(port_config(cfg))
        model.load_state_dict(state, assign=True)
        self.device = torch.device(device)
        self.matcher = TinyRomaMatcher(model, device=self.device)
        self.num = traffic["num"]
        self.ahead = traffic.get("in_flight", 1) > 1 and self.device.type == "cuda"
        self.pinned = {}
        self.gens = [torch.Generator(device=self.device) for _ in range(traffic["pairs"])]

    def call(self, batch, seeds, syncs=None) -> Outputs:
        with record_function("bench.upload"):
            if self.ahead:
                raw = self.pinned.get(id(batch))
                if raw is None:
                    raw = self.pinned[id(batch)] = torch.from_numpy(batch.raw).pin_memory()
                x = raw.to(self.device, non_blocking=True).float().div_(255.0)
            else:
                x = torch.from_numpy(batch.raw).to(self.device).float().div_(255.0)
        B = x.shape[0] // 2
        with counted(syncs):
            warp, cert = self.matcher.match(x[:B], x[B:], batched=True)
        if not self.num:
            if not self.ahead:
                synchronize(self.device)
            return Outputs(warp, cert)
        for g, s in zip(self.gens, seeds):
            g.manual_seed(s)
        with record_function("bench.sample"), counted(syncs):
            out = [self.matcher.sample(w, c, num=self.num, generator=g)
                   for w, c, g in zip(warp, cert, self.gens)]
        with record_function("bench.readback"):
            return Outputs(warp, cert, torch.stack([m for m, _ in out]).cpu(),
                           torch.stack([c for _, c in out]).cpu())
