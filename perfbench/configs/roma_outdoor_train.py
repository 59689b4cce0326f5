"""roma_outdoor_train: one rank of full RoMa's published training job, the
port driven through its own composition (`make_roma_train_state` and
`make_train_step(robust_loss, ..., mesh=None)`, as its training CLI
composes them in one process) on batches of the dataset contract held on
the host, and its plain reference (`perfbench/reference/roma_train.py`,
`robust_loss.py`, `optim.py`) trained in its place. The check is
`perfbench/core/train.py`'s."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from perfbench.configs import roma_outdoor
from perfbench.core import scenes, train
from perfbench.core.program import counted
from perfbench.reference.optim import AdamW
from perfbench.reference.robust_loss import robust_loss as reference_loss
from perfbench.reference.roma import Roma
from perfbench.reference.roma_train import TrainForward, step_flops as _step_flops

make_pool = scenes.make_pool
judge = train.judge
record = train.record
shape_weights = roma_outdoor.shape_weights


def groups(cfg: dict) -> dict[str, tuple[str, ...]]:
    """The check's groups of leaves (`core/train.py`): VGG, the decoder's
    projections, the coarse decoder (GP and the transformer blocks), each
    refiner."""
    return {"vgg": ("encoder.cnn.",), "proj": ("decoder.proj.",),
            "coarse": ("decoder.gps.", "decoder.embedding_decoder."),
            **{f"refiner{s}": (f"decoder.conv_refiner.{s}.",) for s in cfg["refiners"]}}


def attention_grads_left_out(program):
    """A planted fault: the decoder blocks' attention passes no gradient to
    its q, k and v (as a backward of K8/K9 that returns zeros)."""
    from roma_torch.models import transformer

    step, attend = program.step, transformer.attention

    def cut(q, k, v):
        for t in (q, k, v):
            if t.requires_grad:
                t.register_hook(torch.zeros_like)
        return attend(q, k, v)

    def faulty(state, batch):
        transformer.attention = cut
        try:
            return step(state, batch)
        finally:
            transformer.attention = attend
    return faulty


FAULTS = {**train.FAULTS, "attention_grads_left_out": attention_grads_left_out,
          "refiner1_grads_left_out": lambda prog: train.grads_left_out(
              prog, "decoder.conv_refiner.1.")}


def reference_model(cfg: dict) -> torch.nn.Module:
    return Roma(cfg)


def loss_config(cfg: dict):
    """The port's RobustLossConfig of the file's loss."""
    from roma_torch.losses.robust_loss import RobustLossConfig

    c = cfg["loss"]
    return RobustLossConfig(ce_weight=c["ce_weight"], alpha=c["alpha"], c=c["c"],
                            local_dist={int(k): v for k, v in c["local_dist"].items()},
                            local_largest_scale=c["local_largest_scale"],
                            cls_res=cfg["decoder"]["cls_res"],
                            relative_depth_error_threshold=c["relative_depth_error_threshold"])


def train_config(cfg: dict):
    """The port's TrainConfig of the file's optimizer: the global batch's
    learning rates on this rank's rows."""
    from roma_torch.config import TrainConfig

    o = cfg["optimizer"]
    return TrainConfig(batch_size=o["global_batch"], lr_encoder=o["lr_encoder"],
                       lr_decoder=o["lr_decoder"], grad_clip=o["grad_clip"])


def traced(loss_fn):
    """`loss_fn` inside the benchmark's `bench.loss` range."""
    def loss(corresps, batch, **kw):
        with record_function("bench.loss"):
            return loss_fn(corresps, batch, **kw)
    return loss


class Program:
    """The system under test: the port's training state built on the
    benchmark's weights, and its train step. A call is one step on one
    batch as the loader hands it (the step uploads it), its metrics read
    back to the host as the metrics logger reads them."""

    def __init__(self, cfg: dict, traffic: dict, state: dict, device):
        from roma_torch.losses.robust_loss import robust_loss
        from roma_torch.models.matcher import RomaModel
        from roma_torch.train.train import make_roma_train_state, make_train_step

        with torch.device("meta"):
            model = RomaModel(roma_outdoor.port_config(cfg))
        # each leaf in storage of its own: the benchmark's leaves are views of
        # one draw and share its version counter, which the step's in-place
        # updates (running statistics, AdamW) would move under autograd
        model.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
        self.state = make_roma_train_state(train_config(cfg), model=model, device=device)
        self.step = make_train_step(loss_fn=traced(robust_loss), loss_cfg=loss_config(cfg),
                                    mesh=None)
        self.names = {p: k for k, p in model.named_parameters()}
        self.follow = train.Follow(traffic["followed"])

    def trainable(self) -> dict:
        return {self.names[p]: p for p in self.state.trainable()}

    def first_grad(self) -> dict:
        """AdamW's first moment over 1 - beta1: after one step, the gradient
        the update took (zero where the optimizer holds no state)."""
        opt = self.state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        return {self.names[p]: opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state
                else torch.zeros_like(p) for p in self.state.trainable()}

    def observed(self) -> train.Follow:
        return self.follow

    def call(self, batch, seeds=None, syncs=None) -> dict[str, float]:
        with counted(syncs):
            self.state, metrics = self.step(self.state, batch)
        with record_function("bench.readback"):
            out = {k: float(v) for k, v in metrics.items()}
        self.follow.record(batch, out, self.trainable, self.first_grad)
        return out


def reference_trainer(cfg: dict, state: dict, device, prec, followed: int):
    """The plain reference on the benchmark's weights, trained as the file's
    optimizer says, in `prec`."""
    with torch.device("meta"):
        model = Roma(cfg)
    model.load_state_dict(state, assign=True)
    model = model.to(device).float()
    o = cfg["optimizer"]
    model.get_submodule(o["frozen"]).requires_grad_(False)
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    by_rate = [([p for k, p in params.items() if k.startswith(prefix + ".")],
                o[lr] * o["global_batch"]) for lr, prefix in o["groups"].items()]
    opt = AdamW(by_rate, tuple(o["betas"]), o["eps"], o["weight_decay"], o["grad_clip"])
    return train.ReferenceTrainer(params, TrainForward(model, prec),
                                  lambda out, b: reference_loss(out, b, cfg["loss"]), opt,
                                  device, followed, train.bn_fed_biases(model))


def step_flops(cfg: dict, batch: dict) -> float:
    return _step_flops(cfg, {k: v.shape for k, v in batch.items()},
                       lambda out, b: reference_loss(out, b, cfg["loss"]))


def Control(cfg: dict, traffic: dict, state: dict, device):
    """The reference in the program's place, its operands and their
    gradients rounded to float8 e4m3."""
    from perfbench.reference.common import Precision

    return reference_trainer(cfg, state, device, Precision("float8"), traffic["followed"])
