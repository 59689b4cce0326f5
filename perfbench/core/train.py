"""The check of a training cell, and the reference trained in the program's
place.

Set-up builds the program (one object: the model, its optimizer state and
its train step) and drives it from the seed through its first `followed`
steps, the warm-up calls, on batches whose rows all differ; the same
object then runs the window. As it takes those steps the program records
(`Follow`): each step's metrics, the per-leaf norm of the first gradient
as its optimizer took it (read from the optimizer's state after step one:
AdamW's first moment over 1 - beta1: after the clip, which divides every
leaf by the whole gradient's norm, so that a gap common to every leaf, as
the loss's own gap makes, drops out), and its trainable parameters after
the last step, on the host. Once the program is released, the plain
reference follows the same steps on the same batches from the same
initial weights (`ReferenceTrainer`, in float32 with TF32 off).

A leaf counts where the reference's first gradient is at least ROUNDING
of the median leaf's. The biases of convolutions that a batch-statistics
BatchNorm normalises (`bn_fed_biases`, found from the reference's module
structure) have the gradient nought exactly: either side reads its own
round-off there, so they are left out of the gradient's numbers and of
the widest leaves. The numbers compared:
- loss_gap: the largest over the steps of |program's loss - reference's|
  / |reference's|;
- grad_gap.<group>, one for each group of leaves that the configuration's
  module names (`groups(cfg)`: a module of the model each, as an encoder,
  the coarse decoder, one refiner): the median over the group's counted
  leaves of |a - b| / b, a and b the norms of a leaf's first gradient in
  the program and in the reference. A module whose gradient is left out
  or wrong moves its own group's number whatever the others do, and each
  group has a limit of its own, as their rounding differs by orders of
  magnitude; a median, as a few leaves of near-cancelling sums (the
  displacement embeddings' weights) swing with rounding on either side;
- change_gap_q50: the median over the counted leaves of |a - b| / max(b,
  the median leaf's b), a and b the norms of a leaf's change over the
  followed steps (a state left unchanged reads 1).
Beside them, for the record: grad_norm_gap, the first step's gap of the
whole gradient's norm before the clip, relative; grad_gap and
change_gap, the widest leaf's
gap against max(b, the median leaf's b), exact zeros left out (printed
with the widest leaves' names); grad_gap_q50, the median leaf's; each
step's loss gap and reference loss. Names never end in `_mid`, which
`check.aggregate` adds.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch
import torch.nn as nn

RECORD = ("grad_norm_gap", "grad_gap", "change_gap", "grad_gap_q50", "leaves",
          "leaves_counted", "leaves_exact_zero")
ROUNDING = 1e-3


def compared(groups) -> list[str]:
    """The names of the numbers compared, for the groups `groups` names."""
    return ["loss_gap", "change_gap_q50"] + [f"grad_gap.{g}" for g in groups]


def record(cell) -> list[str]:
    """Every number a run of a training cell gives: those compared, those
    kept for the record, and each followed step's loss gap and reference
    loss."""
    steps = range(1, cell.traffic["followed"] + 1)
    return (compared(cell.cfgmod.groups(cell.cfg)) + list(RECORD)
            + [f"{k}_step{i}" for k in ("loss_gap", "ref_loss") for i in steps])


def bn_fed_biases(model: nn.Module) -> set[str]:
    """The biases of convolutions followed, in an `nn.Sequential`, by a
    BatchNorm: under batch statistics the mean it subtracts takes them
    whole, so their gradient is nought exactly."""
    out = set()
    for name, seq in model.named_modules():
        if not isinstance(seq, nn.Sequential):
            continue
        kids = list(seq.named_children())
        for (k, conv), (_, norm) in zip(kids, kids[1:]):
            if isinstance(conv, nn.Conv2d) and conv.bias is not None \
                    and isinstance(norm, nn.BatchNorm2d):
                out.add(f"{name}.{k}.bias" if name else f"{k}.bias")
    return out


def leaf_norms(tensors: dict) -> dict[str, float]:
    """Each tensor's Euclidean norm, read to the host at once."""
    names = sorted(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].detach().float().norm() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


class Follow:
    """What a training program's first `steps` steps leave (see the module's
    docstring); `record` is called after every step and records only the
    first ones."""

    def __init__(self, steps: int):
        self.steps = steps
        self.batches: list = []
        self.metrics: list[dict] = []
        self.grad: dict[str, float] = {}
        self.params: dict[str, torch.Tensor] = {}

    def record(self, batch, metrics: dict, trainable, first_grad) -> None:
        """`trainable()` and `first_grad()` give {leaf name: tensor}."""
        n = len(self.metrics)
        if n >= self.steps:
            return
        self.batches.append(batch)
        self.metrics.append(metrics)
        if n == 0:
            self.grad = leaf_norms(first_grad())
        if n + 1 == self.steps:
            self.params = {k: p.detach().to("cpu", copy=True) for k, p in trainable().items()}


def _gaps(prog: dict, ref: dict, names, med: float) -> dict[str, float]:
    """|prog - ref| / max(ref, med) of each named leaf."""
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in names}


def _widest(gaps: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {gaps[k]:.4g}" for k in sorted(gaps, key=gaps.get, reverse=True)[:n])


def numbers(prog: Follow, ref: Follow, p0: dict, device, groups: dict,
            exact_zero: set[str]) -> dict[str, float]:
    """The check's numbers of the program's record against the reference's;
    `p0` the initial trainable parameters, on `device`; `groups` {name:
    prefixes of its leaves' names}; `exact_zero` the leaves whose gradient
    is nought exactly."""
    steps = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
             for a, b in zip(prog.metrics, ref.metrics)]
    names = sorted(ref.grad)
    med = statistics.median(ref.grad.values())
    counted = [k for k in names if ref.grad[k] >= ROUNDING * med]
    dp = leaf_norms({k: prog.params[k].to(device) - p0[k] for k in counted}) if prog.params else {}
    dr = leaf_norms({k: ref.params[k].to(device) - p0[k] for k in counted})
    change = _gaps(dp, dr, counted, statistics.median(dr.values())) if dp else {"": math.nan}
    seen = [k for k in counted if k not in exact_zero]
    grad = _gaps(prog.grad, ref.grad, seen, med)
    out = {"loss_gap": max(steps) if len(steps) == prog.steps else math.nan,
           "change_gap_q50": statistics.median(change.values())}
    for g, prefixes in groups.items():
        out[f"grad_gap.{g}"] = statistics.median(_gaps(
            prog.grad, ref.grad, [k for k in seen if k.startswith(tuple(prefixes))], 0.0).values())
    norms = [m[0]["grad_norm"] if m else math.nan for m in (prog.metrics, ref.metrics)]
    out.update(grad_norm_gap=abs(norms[0] - norms[1]) / norms[1], grad_gap=max(grad.values()),
               change_gap=max(v for k, v in change.items() if k not in exact_zero),
               grad_gap_q50=statistics.median(grad.values()),
               leaves=float(len(names)), leaves_counted=float(len(counted)),
               leaves_exact_zero=float(len(exact_zero & set(names))))
    out.update({f"loss_gap_step{i + 1}": g for i, g in enumerate(steps)})
    out.update({f"ref_loss_step{i + 1}": m["total_loss"] for i, m in enumerate(ref.metrics)})
    print(f"widest leaves, exact zeros left out: first gradient {_widest(grad)}; change "
          f"{_widest({k: v for k, v in change.items() if k not in exact_zero})}",
          file=sys.stderr, flush=True)
    return out


class ReferenceTrainer:
    """The plain reference trained as the program trains, one step a call:
    `forward(im_A, im_B)` -> per-scale maps, `loss(maps, batch)` -> (total,
    terms), backward by autograd, then `optimizer` (`reference/optim.py`:
    clip, AdamW); `exact_zero` the leaves whose gradient is nought exactly.
    With `call(batch, seeds, syncs)` and `observed()` it also stands in the
    program's place (the control)."""

    def __init__(self, params: dict, forward, loss, optimizer, device, followed: int,
                 exact_zero: set[str]):
        self.params, self.forward, self.loss = params, forward, loss
        self.optimizer, self.device = optimizer, torch.device(device)
        self.follow, self.exact_zero = Follow(followed), exact_zero

    def trainable(self) -> dict:
        return self.params

    def first_grad(self) -> dict:
        return {k: self.optimizer.first_moment(p) for k, p in self.params.items()}

    def observed(self) -> Follow:
        return self.follow

    def call(self, batch, seeds=None, syncs=None) -> dict[str, float]:
        b = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        for p in self.params.values():
            p.grad = None
        total, terms = self.loss(self.forward(b["im_A"], b["im_B"]), b)
        total.backward()
        norm = self.optimizer.step()
        out = {k: float(v.detach()) for k, v in terms.items()}
        out.update(total_loss=float(total.detach()), grad_norm=float(norm))
        self.follow.record(batch, out, self.trainable, self.first_grad)
        return out


def half_the_batch(program):
    """A planted fault: the train step sees the first half of the batch's
    rows only, the mean taken over them."""
    step = program.step

    def faulty(state, batch):
        return step(state, {k: v[:len(v) // 2] for k, v in batch.items()})
    return faulty


def state_unchanged(program):
    """A planted fault: the train step computes as ever and puts every
    parameter back as it was."""
    step, trainable = program.step, program.trainable

    def faulty(state, batch):
        before = {k: p.detach().clone() for k, p in trainable().items()}
        state, metrics = step(state, batch)
        with torch.no_grad():
            for k, p in trainable().items():
                p.copy_(before[k])
        return state, metrics
    return faulty


def grads_left_out(program, prefix: str):
    """A planted fault: the train step leaves out the gradients of the
    leaves whose names start with `prefix` (zero where the optimizer takes
    them), as a module whose backward is skipped."""
    step = program.step
    leaves = [p for k, p in program.trainable().items() if k.startswith(prefix)]

    def faulty(state, batch):
        hooks = [p.register_hook(torch.zeros_like) for p in leaves]
        try:
            return step(state, batch)
        finally:
            for h in hooks:
                h.remove()
    return faulty


FAULTS = {"half_the_batch": half_the_batch, "state_unchanged": state_unchanged}


def judge(cell, seed: int, device, pool, observed: Follow, count_flops: bool):
    """The reference follows the recorded steps from the seed's weights, in
    float32; ([numbers], one step's FLOPs or None)."""
    from perfbench.core.harness import make_weights
    from perfbench.reference.common import Precision

    mod = cell.cfgmod
    ref = mod.reference_trainer(cell.cfg, make_weights(cell, seed, device), device, Precision(),
                                observed.steps)
    p0 = {k: p.detach().clone() for k, p in ref.params.items()}
    for batch in observed.batches:
        ref.call(batch)
    out = numbers(observed, ref.follow, p0, device, mod.groups(cell.cfg), ref.exact_zero)
    flops = None
    if count_flops and observed.batches:
        flops = mod.step_flops(cell.cfg, observed.batches[0])
    return [out], flops
