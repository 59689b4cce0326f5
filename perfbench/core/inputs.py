"""The pool of input batches, made from the seed at set-up and kept in host
memory as users hold images.

A traffic file gives `pairs` a call, the `canvas` (Hc, Wc) every image is
padded to, the source `sizes` [(h, w)] and the `pool` of batches. Every
seed draws the same multiset of sizes (each size as often as the others,
round-robin over the pool's images) in its own order, so seeds change the
content and the order and never the work. The two images of a pair are two
overlapping views of one scene, as users match: crops of one texture
(random fields at 1/16, 1/4 and 1/1 of the canvas, upsampled, summed), B's
shifted from A's by up to an eighth of the canvas, zero outside the image;
made on the device, a batch at a time, and copied to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core.seeds import derive

# the texture's layers: (share of the intensity, noise at 1 / down of the
# canvas, upsampled); every scale of feature map sees detail of its own
TEXTURE = ((0.4, 16), (0.3, 4), (0.3, 1))


@dataclasses.dataclass
class Batch:
    raw: np.ndarray          # (2 pairs, Hc, Wc, 3) uint8: the A images over the B images
    sizes: list              # (h, w) of each image, at the canvas's top-left
    idx: np.ndarray          # (2 pairs,) int64: each image's row in traffic["sizes"]


def make_pool(traffic: dict, seed: int, device) -> list[Batch]:
    pairs, pool = traffic["pairs"], traffic["pool"]
    hc, wc = traffic["canvas"]
    sizes = [tuple(s) for s in traffic["sizes"]]
    n = 2 * pairs * pool
    rng = np.random.default_rng(derive(seed, "sizes"))
    order = rng.permutation(np.arange(n) % len(sizes))
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "images"))
    mh, mw = hc // 8, wc // 8
    rows = torch.arange(hc, device=device)[None, :, None]
    cols = torch.arange(wc, device=device)[None, None, :]
    out = []
    for b in range(pool):
        ids = order[2 * pairs * b:2 * pairs * (b + 1)]
        th, tw = hc + mh, wc + mw
        tex = 0.0
        for share, down in TEXTURE:
            noise = torch.rand((pairs, 3, -(-th // down), -(-tw // down)), generator=gen,
                               device=device)
            tex = tex + share * F.interpolate(noise, size=(th, tw), mode="bilinear",
                                              align_corners=False)
        shift = torch.randint(0, 1 << 30, (pairs, 2), generator=gen, device=device).cpu()
        views = [tex[:, :, :hc, :wc]]
        views.append(torch.stack([tex[p, :, dy:dy + hc, dx:dx + wc] for p, (dy, dx)
                                  in enumerate(zip(shift[:, 0] % (mh + 1), shift[:, 1] % (mw + 1)))]))
        x = torch.cat(views) * 255.0
        hs = torch.tensor([sizes[i][0] for i in ids], device=device)[:, None, None]
        ws = torch.tensor([sizes[i][1] for i in ids], device=device)[:, None, None]
        x = x.round() * ((rows < hs) & (cols < ws))[:, None]
        out.append(Batch(raw=x.to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy(),
                         sizes=[sizes[i] for i in ids], idx=ids.astype(np.int64)))
    return out
