"""The optimizer of upstream's training recipe, written out: the gradients'
global norm clipped to `clip` (g * clip / norm where norm >= clip), then
AdamW (PyTorch's: the weight decayed by lr * weight_decay first, the
moments' bias corrected, eps outside the square root), one learning rate
a parameter group."""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, groups: list[tuple[list[torch.Tensor], float]], betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01, clip: float | None = None):
        self.groups = groups
        self.b1, self.b2 = betas
        self.eps, self.wd, self.clip = eps, weight_decay, clip
        self.t = 0
        self.m = {id(p): torch.zeros_like(p) for ps, _ in groups for p in ps}
        self.v = {id(p): torch.zeros_like(p) for ps, _ in groups for p in ps}

    def params(self) -> list[torch.Tensor]:
        return [p for ps, _ in self.groups for p in ps]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, then update every parameter with a gradient; returns the
        gradients' global norm before the clip."""
        grads = [p.grad for p in self.params() if p.grad is not None]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if self.clip is not None and norm >= self.clip:
            for g in grads:
                g.mul_(self.clip / norm)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for ps, lr in self.groups:
            for p in ps:
                if p.grad is None:
                    continue
                m, v = self.m[id(p)], self.v[id(p)]
                m.mul_(self.b1).add_(p.grad, alpha=1 - self.b1)
                v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1 - self.b2)
                p.mul_(1 - lr * self.wd)
                p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))
        return norm

    def first_moment(self, p: torch.Tensor) -> torch.Tensor:
        """The gradient of the first step as the update took it: m / (1 - b1)
        after one step."""
        return self.m[id(p)] / (1 - self.b1)
