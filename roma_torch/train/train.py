"""Training step and state for full RoMa, a port of the JAX package's
``train/train.py`` (`make_roma_train_state`, `make_train_step`,
`train_k_steps`, `ema_update`, `init_ema`).

The recipe: gradient clipping by global norm to 0.01 (optax's
``clip_by_global_norm``: scaled by max_norm / norm where norm >= max_norm,
written out here, since ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm), then AdamW (weight decay 0.01, eps 1e-8 outside the square root, as
optax's ``adamw``) with per-group learning rates: the CNN encoder (VGG) at
``lr_encoder * batch_size``, the decoder at ``lr_decoder * batch_size``,
DINOv2 frozen (``requires_grad=False``, out of the optimizer), each rate
times ``lr_decay`` once the samples seen reach 90% of the schedule. The
step counts samples, as the reference's GLOBAL_STEP does.

Data parallelism (the JAX package's mesh) is later work: one process, one
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from roma_torch.config import RomaConfig, TrainConfig
from roma_torch.losses.robust_loss import RobustLossConfig, robust_loss


@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its optimizer and the counters: `step`
    counts samples, `updates` optimizer steps (optax's schedule count)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    cfg: TrainConfig
    step: int = 0
    updates: int = 0

    def trainable(self) -> list[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def lr_multiplier(cfg: TrainConfig, updates: int) -> float:
    """`_adamw_with_schedule`'s factor for the update after `updates`
    earlier ones: lr_decay once updates * batch_size reaches the milestone
    (steps * milestone_frac, counted in samples), else 1."""
    milestone = int(cfg.steps * cfg.milestone_frac)
    return cfg.lr_decay if updates * cfg.batch_size >= milestone else 1.0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm is at
    least `max_norm`, every gradient becomes g / norm * max_norm. Returns
    the norm before clipping."""
    norm = global_norm(grads)
    if norm >= max_norm:
        for g in grads:
            g.copy_(g / norm.to(g.dtype) * max_norm)
    return norm


def make_roma_train_state(cfg: TrainConfig = TrainConfig(), roma_cfg: RomaConfig | None = None,
                          seed: int = 0, device=None, model=None) -> TrainState:
    """Full-RoMa training state with the reference's parameter groups: the
    CNN encoder at lr_encoder, the decoder at lr_decoder, DINOv2 frozen.
    `model` (a RomaModel) is built from `roma_cfg` and `seed` when None;
    it is moved to `device` (default: the GPU) and set to train mode."""
    from roma_torch.device import resolve_device
    from roma_torch.models.zoo import build_model

    model = model if model is not None else build_model(roma_cfg or RomaConfig(), seed)
    model = model.to(resolve_device(device)).train()
    model.encoder.dinov2.requires_grad_(False)
    encoder = [p for p in model.encoder.cnn.parameters()]
    decoder = [p for p in model.decoder.parameters()]
    opt = torch.optim.AdamW(
        [{"params": encoder, "lr": cfg.lr_encoder * cfg.batch_size, "base_lr":
          cfg.lr_encoder * cfg.batch_size},
         {"params": decoder, "lr": cfg.lr_decoder * cfg.batch_size, "base_lr":
          cfg.lr_decoder * cfg.batch_size}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    return TrainState(model=model, optimizer=opt, cfg=cfg)


def _to_device(batch: Mapping[str, Any], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(loss_fn: Callable = robust_loss, loss_cfg: RobustLossConfig | None = None):
    """The train step: ``step(state, batch) -> (state, metrics)``.

    batch: {im_A, im_B (B,H,W,3), im_A_depth, im_B_depth (B,H,W), T_1to2
    (B,4,4), K1, K2 (B,3,3)}, arrays or tensors (moved to the model's
    device), the reference's dataset item contract, channels-last. The
    images go in as they come (the JAX step does not normalise them).
    metrics: the loss's terms, `total_loss` and `grad_norm` (before the
    clip), as detached tensors. The model decodes A -> B only
    (`symmetric=False`), as the JAX package's full-RoMa train state does."""
    kwargs = {} if loss_cfg is None else {"cfg": loss_cfg}

    def step(state: TrainState, batch: Mapping[str, Any]):
        model = state.model.train()
        device = next(model.parameters()).device
        batch = _to_device(batch, device)
        corresps = model(batch["im_A"], batch["im_B"], symmetric=False)
        loss, metrics = loss_fn(corresps, batch, **kwargs)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in state.trainable() if p.grad is not None]
        norm = clip_by_global_norm(grads, state.cfg.grad_clip)
        mult = lr_multiplier(state.cfg, state.updates)
        for group in state.optimizer.param_groups:
            group["lr"] = group["base_lr"] * mult
        state.optimizer.step()
        state.step += int(batch["im_A"].shape[0])
        state.updates += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(total_loss=loss.detach(), grad_norm=norm.detach())
        return state, metrics

    return step


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.999) -> dict[str, torch.Tensor]:
    """One EMA step, decay * e + (1 - decay) * p for each named tensor, in
    place (the JAX package's is pure; here the EMA owns its tensors)."""
    for name, e in ema_params.items():
        e.copy_(decay * e + (1.0 - decay) * params[name])
    return ema_params


@torch.no_grad()
def init_ema(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An EMA of `params` (e.g. ``dict(model.named_parameters())``) in
    tensors of its own, so that the EMA never aliases the parameters."""
    return {name: p.detach().clone() for name, p in params.items()}


def train_k_steps(state: TrainState, loader, step_fn, k: int, logger=None, device_put=None,
                  ema_params: dict[str, torch.Tensor] | None = None, ema_decay: float = 0.999):
    """Run k optimizer steps off a batch iterator. With `ema_params`, also
    keep the EMA of the parameters and return (state, ema_params)."""
    use_ema = ema_params is not None
    for _ in range(k):
        batch = next(loader)
        if device_put is not None:
            batch = device_put(batch)
        state, metrics = step_fn(state, batch)
        if use_ema:
            ema_update(ema_params, dict(state.model.named_parameters()), decay=ema_decay)
        if logger is not None:
            logger.log(state.step, metrics)
    if use_ema:
        return state, ema_params
    return state
