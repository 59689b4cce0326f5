"""What a call returns, host syncs counted around the program's entries,
and the control that stands in for the program."""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from perfbench.reference import sampling
from perfbench.reference.common import Precision


@dataclasses.dataclass
class Outputs:
    warp: torch.Tensor                    # (B, H, W, 4) on the device
    cert: torch.Tensor                    # (B, H, W) on the device
    matches: torch.Tensor | None = None   # (B, num, 4) on the host
    mcert: torch.Tensor | None = None     # (B, num) on the host


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class SyncCounter:
    """Counts the synchronizing calls that sync debug mode "warn" reports
    while a `counted` block runs."""

    def __init__(self):
        self.n = 0


@contextlib.contextmanager
def counted(syncs: SyncCounter | None):
    if syncs is None:
        yield
        return
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        yield
    syncs.n += sum("synchroniz" in str(w.message) for w in seen)


class Control:
    """The reference in the program's place, computed in the control's
    precision (`Precision("float8")`), sampling included."""

    def __init__(self, cfgmod, cfg: dict, traffic: dict, state: dict, device):
        self.cfgmod, self.cfg, self.device = cfgmod, cfg, torch.device(device)
        self.model = reference_on(cfgmod, cfg, state, self.device)
        self.num = traffic["num"]
        self.prec = Precision("float8")

    def call(self, batch, seeds, syncs=None) -> Outputs:
        warp, cert = self.cfgmod.reference_dense(self.model, self.prec, batch, self.device, self.cfg)
        if not self.num:
            return Outputs(warp, cert)
        out = [sampling.sample(self.prec, w, c, self.num, self.cfg["sample_thresh"],
                               generator(self.device, s))
               for w, c, s in zip(warp, cert, seeds)]
        return Outputs(warp, cert, torch.stack([m for m, _ in out]).cpu(),
                       torch.stack([c for _, c in out]).cpu())


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def reference_on(cfgmod, cfg: dict, state: dict, device) -> torch.nn.Module:
    """The plain reference with the benchmark's weights, float32 on `device`."""
    with torch.device("meta"):
        model = cfgmod.reference_model(cfg)
    model.load_state_dict(state, assign=True)
    return model.to(device).float().eval()
