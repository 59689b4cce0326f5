"""VGG19-bn fine-feature pyramid {1: 64ch, 2: 128ch, 4: 256ch, 8: 512ch}.

The layer list is torchvision's ``vgg19_bn().features[:40]`` (conv, BN,
ReLU, ..., max-pool), so the state_dict keys are the reference RoMa's
``encoder.cnn.layers.{idx}``. The pyramid records the activation before
each max-pool; BN runs in float32, on running statistics in eval mode and
on batch statistics in train mode (`batch_norm_train`, flax's
``BatchNorm(momentum=0.9)``, as the JAX package's VGG19).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from roma_torch.models.layers import batch_norm, batch_norm_train, conv2d

# convs per stage, channels per stage (VGG-19 cfg E through block4)
_STAGES = [(2, 64), (2, 128), (4, 256), (4, 512)]


class VGG19(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        layers: list[nn.Module] = []
        in_c = 3
        for n_convs, ch in _STAGES:
            for _ in range(n_convs):
                layers += [nn.Conv2d(in_c, ch, 3, padding=1), nn.BatchNorm2d(ch),
                           nn.ReLU(inplace=True)]
                in_c = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.layers = nn.Sequential(*layers)
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        """(B, 3, H, W) -> {scale: (B, C, H/scale, W/scale)} in self.dtype."""
        dt = self.dtype
        feats: dict[int, torch.Tensor] = {}
        scale = 1
        x = x.to(dt)
        last = len(_STAGES)
        for layer in self.layers:
            if isinstance(layer, nn.MaxPool2d):
                feats[scale] = x
                if len(feats) == last:
                    break  # the final pool's output is never used
                x = layer(x)
                scale *= 2
            elif isinstance(layer, nn.Conv2d):
                x = conv2d(layer, x, dt)
            elif isinstance(layer, nn.BatchNorm2d):
                x = (batch_norm_train(layer, x, 0.9, False) if self.training
                     else batch_norm(layer, x))
            else:
                x = torch.relu(x).to(dt)
        return feats
