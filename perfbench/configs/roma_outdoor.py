"""roma_outdoor: the port's `RomaMatcher` driven as users drive it from host
images (uint8 canvases uploaded, `match_raw`, `sample_batched`, the matches
read back), and its plain reference (`perfbench/reference/roma.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from perfbench.core.program import Outputs, counted, synchronize
from perfbench.reference.roma import Roma


ANCHOR_SIGMA = 6.0  # anchors


def reference_model(cfg: dict) -> torch.nn.Module:
    return Roma(cfg)


@torch.no_grad()
def shape_weights(state: dict, cfg: dict) -> None:
    """A trained match decoder scores neighbouring anchors alike and keeps its
    certainty logit moderate. Independent random rows do neither: the
    4,096 anchors are then near-tied all over the grid, and any two
    precisions pick anchors far apart. So the head's anchor
    rows are smoothed over the 64 x 64 anchor grid (a Gaussian of
    ANCHOR_SIGMA anchors, their spread kept) and its certainty row scaled
    to a tenth. Program and reference get the same weights."""
    w = state["decoder.embedding_decoder.to_out.weight"]
    res = cfg["decoder"]["cls_res"]
    n = int(3 * ANCHOR_SIGMA)
    x = torch.arange(-n, n + 1, device=w.device, dtype=w.dtype)
    k = torch.exp(-x * x / (2 * ANCHOR_SIGMA ** 2))
    k = k / k.sum()
    rows = w[:res * res].T.reshape(-1, 1, res, res)
    sm = F.conv2d(F.pad(rows, (n, n, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    sm = F.conv2d(F.pad(sm, (0, 0, n, n), mode="reflect"), k.view(1, 1, -1, 1))
    sm = sm * (rows.std() / sm.std())
    w[:res * res] = sm.reshape(-1, res * res).T
    w[res * res:] *= 0.1


def reference_dense(model, prec, batch, device, cfg):
    raw = torch.from_numpy(batch.raw).to(device)
    return model.match(prec, raw, batch.sizes)


def port_config(cfg: dict):
    from roma_torch.config import GPConfig, RefinerConfig, RomaConfig

    d, g, dec = cfg["dinov2"], cfg["gp"], cfg["decoder"]
    refiners = {s: RefinerConfig(r["in_dim"], r["hidden_dim"], r["displacement_emb_dim"],
                                 r["local_corr_radius"], r["kernel_size"], r["hidden_blocks"])
                for s, r in cfg["refiners"].items()}
    return RomaConfig(
        coarse_resolution=tuple(cfg["coarse_resolution"]),
        upsample_resolution=tuple(cfg["upsample_resolution"]),
        upsample_preds=cfg["upsample_preds"], symmetric=cfg["symmetric"],
        attenuate_cert=cfg["attenuate_cert"], sample_thresh=cfg["sample_thresh"],
        gp=GPConfig(g["gp_dim"], g["kernel_temperature"], g["sigma_noise"], g["basis"]),
        gp_dim=g["gp_dim"], dinov2_depth=d["depth"], dinov2_dim=d["dim"],
        dinov2_heads=d["heads"], decoder_dim=dec["dim"], cls_res=dec["cls_res"],
        num_decoder_blocks=dec["blocks"], decoder_heads=dec["heads"],
        refine_init=cfg["refine_init"], disp_emb_gain=cfg["disp_emb_gain"],
        smooth_warp_gather=cfg["smooth_warp_gather"], refiners=refiners,
        proj_dims={s: tuple(v) for s, v in cfg["proj_dims"].items()}, dtype=cfg["dtype"])


class Program:
    """The system under test, its weights the benchmark's, its resize banks
    built once for the traffic's sizes and canvas."""

    def __init__(self, cfg: dict, traffic: dict, state: dict, device):
        from roma_torch.models.matcher import RomaMatcher, RomaModel

        with torch.device("meta"):
            model = RomaModel(port_config(cfg))
        model.load_state_dict(state, assign=True)
        self.device = torch.device(device)
        self.matcher = RomaMatcher(model, device=self.device)
        self.banks = self.matcher.build_resize_banks([tuple(s) for s in traffic["sizes"]],
                                                     tuple(traffic["canvas"]))
        self.num = traffic["num"]
        self.gens = [torch.Generator(device=self.device) for _ in range(traffic["pairs"])]

    def call(self, batch, seeds, syncs=None) -> Outputs:
        with record_function("bench.upload"):
            raw = torch.from_numpy(batch.raw).to(self.device)
            idx = torch.from_numpy(batch.idx).to(self.device)
        with counted(syncs):
            warp, cert = self.matcher.match_raw(raw, idx, self.banks)
        if not self.num:
            synchronize(self.device)
            return Outputs(warp, cert)
        for g, s in zip(self.gens, seeds):
            g.manual_seed(s)
        with record_function("bench.sample"), counted(syncs):
            m, c = self.matcher.sample_batched(warp, cert, self.num, self.gens)
        with record_function("bench.readback"):
            return Outputs(warp, cert, m.cpu(), c.cpu())
