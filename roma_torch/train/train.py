"""Training step and state for Tiny RoMa and full RoMa, a port of the JAX
package's ``train/train.py`` (`make_optimizer`, `make_tiny_train_state`,
`make_roma_train_state`, `make_train_step`, `train_k_steps`, `ema_update`,
`init_ema`).

The recipe: gradient clipping by global norm to 0.01 (optax's
``clip_by_global_norm``: g / norm * max_norm where norm >= max_norm,
written out here without a host branch, since
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm), then AdamW
(weight decay 0.01, eps 1e-8 outside the square root, as optax's
``adamw``). Full RoMa: per-group learning rates, the CNN encoder (VGG) at
``lr_encoder * batch_size``, the decoder at ``lr_decoder * batch_size``,
DINOv2 frozen (``requires_grad=False``, out of the optimizer), each rate
times ``lr_decay`` once the samples seen reach 90% of the schedule. Tiny
RoMa: one rate, ``lr_decoder * batch_size``, with `make_optimizer`'s
warm-up factor besides; its frozen roots (`trainable`) keep their
gradients (the ``grad_norm`` metric covers every parameter's, as the JAX
step's ``optax.global_norm(grads)``) but take no update, no weight decay
and no part in the clip's norm (optax's ``multi_transform`` with
``set_to_zero``). The step counts samples, as the reference's GLOBAL_STEP
does.

Data parallelism: `make_train_step(mesh=...)` runs the forward and the loss
inside `parallel.mesh.data_parallel` (global batch statistics and global
means, as the JAX package's GSPMD step) and averages the gradients over
the mesh's group before the clip.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from roma_torch.config import RomaConfig, TinyRomaConfig, TrainConfig
from roma_torch.losses.robust_loss import RobustLossConfig, tiny_robust_loss
from roma_torch.parallel.mesh import all_reduce_grads, all_reduce_metrics, data_parallel


def lr_multiplier(cfg: TrainConfig, updates: int) -> float:
    """`_adamw_with_schedule`'s factor for the update after `updates`
    earlier ones: lr_decay once updates * batch_size reaches the milestone
    (steps * milestone_frac, counted in samples), else 1."""
    milestone = int(cfg.steps * cfg.milestone_frac)
    return cfg.lr_decay if updates * cfg.batch_size >= milestone else 1.0


def warmup_lr_multiplier(cfg: TrainConfig, updates: int) -> float:
    """`make_optimizer`'s factor: `lr_multiplier` times, when
    warmup_samples > 0, min(1, (samples + batch_size) / warmup_samples)
    with samples = updates * batch_size."""
    mult = lr_multiplier(cfg, updates)
    if cfg.warmup_samples > 0:
        mult *= min(1.0, (updates * cfg.batch_size + cfg.batch_size) / cfg.warmup_samples)
    return mult


@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its optimizer and the counters: `step`
    counts samples, `updates` optimizer steps (optax's schedule count).
    `schedule(cfg, updates)` is the learning-rate factor of the next
    update, and `forward_kw` what the step passes to the model besides the
    two images."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    cfg: TrainConfig
    step: int = 0
    updates: int = 0
    schedule: Callable[[TrainConfig, int], float] = lr_multiplier
    forward_kw: dict = dataclasses.field(default_factory=dict)

    def trainable(self) -> list[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place, ``where(norm < max_norm, g,
    g / norm * max_norm)``, with no branch on the host: every gradient is
    divided by where(keep, 1, norm) and multiplied by where(keep, 1,
    max_norm), so a kept gradient is bit-unchanged. Returns the norm before
    clipping."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def make_optimizer(cfg: TrainConfig, lr: float, params) -> torch.optim.AdamW:
    """The AdamW of the JAX package's `make_optimizer` (one group at `lr`,
    weight decay 0.01); its schedule is `warmup_lr_multiplier`, which the
    step applies, and the clip the step's."""
    params = list(params)
    return torch.optim.AdamW([{"params": params, "lr": lr, "base_lr": lr}],
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


# the JAX package's frozen roots (its trunk is `backbone`, here `xfeat`)
FROZEN_ROOTS = {"all": set(), "fine_only": {"xfeat", "coarse_matcher"},
                "matchers_only": {"xfeat"}}


def make_tiny_train_state(cfg: TrainConfig = TrainConfig(), model=None, trainable: str = "all",
                          seed: int = 0, device=None) -> TrainState:
    """Tiny RoMa training state. `trainable`: "all"; "fine_only" (the fork's
    staged recipe: trunk and coarse matcher frozen, the fine matcher
    trained); "matchers_only" (the XFeat trunk frozen, the shipped tiny
    configuration). `model` (a TinyRoma) is built from TinyRomaConfig() and
    `seed` when None; it is moved to `device` (default: the GPU) and set to
    train mode. Frozen parameters still get gradients (for `grad_norm`)
    and their BatchNorm statistics still move in train mode."""
    from roma_torch.device import resolve_device
    from roma_torch.models.zoo import build_model

    if trainable not in FROZEN_ROOTS:
        raise ValueError(f"trainable must be one of {sorted(FROZEN_ROOTS)}, got {trainable!r}")
    model = model if model is not None else build_model(TinyRomaConfig(), seed)
    model = model.to(resolve_device(device)).train()
    frozen = FROZEN_ROOTS[trainable]
    params = [p for name, p in model.named_parameters() if name.split(".")[0] not in frozen]
    opt = make_optimizer(cfg, cfg.lr_decoder * cfg.batch_size, params)
    return TrainState(model=model, optimizer=opt, cfg=cfg, schedule=warmup_lr_multiplier)


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
    return TrainState(model=model, optimizer=opt, cfg=cfg, forward_kw={"symmetric": False})


def _to_device(batch: Mapping[str, Any], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(loss_fn: Callable = tiny_robust_loss, loss_cfg: RobustLossConfig | None = None,
                    mesh=None):
    """The train step: ``step(state, batch) -> (state, metrics)``.

    batch: {im_A, im_B (B,H,W,3), im_A_depth, im_B_depth (B,H,W), T_1to2
    (B,4,4), K1, K2 (B,3,3)}, arrays or tensors (moved to the model's
    device), the reference's dataset item contract, channels-last. The
    images go in as they come (the JAX step does not normalise them).
    metrics: the loss's terms, `total_loss` and `grad_norm` (every
    parameter's gradient, before the clip), as detached tensors. The model
    takes `state.forward_kw` besides the images (full RoMa decodes A -> B
    only, ``symmetric=False``, as the JAX package's full-RoMa train state
    does). With `mesh` (`parallel.mesh.make_mesh`), `batch` is this rank's
    rows: the batch statistics and the loss are the global batch's, the
    gradients are averaged over the mesh's group, and the metrics are the
    global values on every rank."""
    kwargs = {} if loss_cfg is None else {"cfg": loss_cfg}
    group = None if mesh is None else mesh.get_group()

    def step(state: TrainState, batch: Mapping[str, Any]):
        model = state.model.train()
        device = next(model.parameters()).device
        batch = _to_device(batch, device)
        with data_parallel(group):
            corresps = model(batch["im_A"], batch["im_B"], **state.forward_kw)
            loss, metrics = loss_fn(corresps, batch, **kwargs)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        if group is not None:
            all_reduce_grads([p.grad for p in params], group)
        trainable = [p.grad for p in state.trainable() if p.grad is not None]
        grad_norm = None if len(trainable) == len(params) else global_norm(
            [p.grad for p in params])
        norm = clip_by_global_norm(trainable, state.cfg.grad_clip)
        mult = state.schedule(state.cfg, state.updates)
        for g in state.optimizer.param_groups:
            g["lr"] = g["base_lr"] * mult
        state.optimizer.step()
        state.step += int(batch["im_A"].shape[0]) * (1 if mesh is None else mesh.size())
        state.updates += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        if group is not None:
            metrics = all_reduce_metrics(metrics, group)
        metrics["grad_norm"] = (norm if grad_norm is None else grad_norm).detach()
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
