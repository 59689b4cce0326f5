"""Weights made from the seed on the device, in one draw, under the names of
the reference's modules (the upstream state-dict names, which the program
loads as they are).

Every float leaf is a view of one normal draw, scaled by its role, so that
activations keep their scale through depth as in a trained network (the
deltas of the refiners a few pixels, not hundreds): a convolution followed
by a BatchNorm (and its ReLU) and the MLPs' first layer He-normal (std
sqrt(2 / fan_in)), every other convolution and linear layer LeCun-normal
(std sqrt(1 / fan_in)) but the heads that emit (dx, dy, certainty) (3
output channels: RoMa's refiners, Tiny's matchers) at a tenth of that, their
biases 0.02 N; norm scales and layer scales
1 + 0.1 N, norm shifts and running means 0.1 N, running variances
exp(0.1 N); tokens and position embeddings 0.02 N. Integer leaves
(BatchNorm's counters) are 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.core.seeds import derive


def _before_relu(model: nn.Module) -> set[str]:
    """Names of the layers whose output a ReLU or GELU takes (through a
    BatchNorm): convolutions followed by a BatchNorm, and MLPs' fc1."""
    out = set()
    for prefix, m in model.named_modules():
        if isinstance(m, nn.Sequential):
            kids = list(m.named_children())
            for (a, x), (_, y) in zip(kids, kids[1:]):
                if isinstance(x, nn.Conv2d) and isinstance(y, nn.BatchNorm2d):
                    out.add(f"{prefix}.{a}" if prefix else a)
        elif prefix.endswith("mlp.fc1"):
            out.add(prefix)
    return out


def _roles(model: nn.Module) -> dict[str, tuple[str, float]]:
    roles = {}
    he = _before_relu(model)
    for prefix, m in model.named_modules():
        name = (prefix + ".") if prefix else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            head = isinstance(m, nn.Conv2d) and m.out_channels == 3
            gain = 2.0 if prefix in he else 0.01 if head else 1.0
            roles[name + "weight"] = ("scale", math.sqrt(gain / fan_in))
            roles[name + "bias"] = ("scale", 0.02)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            roles[name + "weight"] = ("one", 0.1)
            roles[name + "bias"] = ("scale", 0.1)
            roles[name + "running_mean"] = ("scale", 0.1)
            roles[name + "running_var"] = ("exp", 0.1)
    return roles


def make(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of `model` (built on any device, meta included)."""
    spec = model.state_dict()
    roles = _roles(model)
    floats = [(k, v.shape) for k, v in spec.items() if v.is_floating_point()]
    ints = [k for k, v in spec.items() if not v.is_floating_point()]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    z = torch.randn(sum(math.prod(s) for _, s in floats), generator=gen, device=device)
    out, off = {}, 0
    with torch.no_grad():
        for k, shape in floats:
            n = math.prod(shape)
            t = z[off:off + n].view(shape)
            off += n
            role, a = roles.get(k, ("one" if k.endswith("gamma") else "scale",
                                    0.1 if k.endswith("gamma") else 0.02))
            if role == "one":
                t.mul_(a).add_(1.0)
            elif role == "exp":
                t.mul_(a).exp_()
            else:
                t.mul_(a)
            out[k] = t
    zeros = torch.zeros(len(ints), dtype=torch.int64, device=device)
    out.update({k: zeros[i] for i, k in enumerate(ints)})
    return out
