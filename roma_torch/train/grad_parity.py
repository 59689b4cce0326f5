"""How closely two float32 training steps of the debug-size model must agree
in their gradients before the clip: the JAX package's and the port's on the
CPU (tests/test_torch_train.py), and the port's on the GPU (attention
kernels) and on the CPU (plain versions) in chip_smoke.py. One rule for
both:

- every gradient within GRAD_TOL * max|g| of its tensor;
- a conv bias whose conv feeds a training BatchNorm has an exact gradient
  of 0 (the BatchNorm removes any shift): both sides below ZERO_GRAD_TOL;
- the tensors named in KINK_SENSITIVE, within a relative L2 error of twice
  the largest of their readings.

Why the named tensors cannot meet GRAD_TOL: VGG and the projections and
refiners sit behind training-mode BatchNorm -> ReLU layers
over few pixels (14^2 at scale 8, batch 1, 112^2). Two float32
implementations differ there by up to 5.5e-5 before the ReLU of VGG's
last conv (JAX and the port at 32 x 40, batch 2, where one value of
layer 11 lies on the other side of 0), so now and then one value crosses
0 on one side only; that
pixel's gradient passes on one side and not on the other, a change of
about 1/sqrt(pixels) in the tensors it feeds. The port against itself
shows the same: with the images moved by 1e-7, 67 to 69 of its 136
gradients that are not exact zeros move by more than GRAD_TOL * max|g|
(56 in chip_smoke.py's configuration). A tensor that its own envelope
brings close to GRAD_TOL can cross it against JAX on one build of the CPU
libraries and not on another, whatever the thread count: the scale-1
refiner's first BatchNorm weight reads 9.3e-4 max|g| against itself, and
against JAX 1.09e-3 on one build and under 1e-3 on another, so it is
named. Float64 on both sides would remove the
crossings, but the JAX package computes its BatchNorms in float32 whatever
its dtype. Where no value crosses a kink, tests/test_torch_train.py holds
the same modules to GRAD_TOL: the refiners in train mode against JAX, and
VGG under checkpointing against its own forward without.
"""

from __future__ import annotations

import torch

GRAD_TOL = 1e-3       # times max|g| of each tensor
ZERO_GRAD_TOL = 1e-6  # a conv bias before a training BatchNorm

# name: relative L2 errors measured (JAX vs the port on the CPU in
# tests/test_torch_train.py; the port's GPU vs its CPU in chip_smoke.py on an
# NVIDIA H100 80GB HBM3, 700 W; the largest of the port's CPU against itself
# in both configurations, the images moved by 1e-7 with 16 seeds, or on one
# thread). Named: every tensor that any of these moved by more than
# GRAD_TOL * max|g|. The bound is twice the largest reading.
KINK_SENSITIVE: dict[str, tuple[float, float, float]] = {
    "decoder.conv_refiner.1.block1.0.weight": (0.00036, 1.7e-06, 0.0014),
    "decoder.conv_refiner.1.block1.1.bias": (0.00052, 5.4e-06, 0.0017),
    "decoder.conv_refiner.1.block1.1.weight": (0.0013, 2.7e-06, 0.001),
    "decoder.conv_refiner.1.disp_emb.weight": (0.0005, 3.7e-06, 0.0014),
    "decoder.conv_refiner.1.hidden_blocks.0.0.weight": (0.00078, 7.2e-06, 0.0015),
    "decoder.conv_refiner.2.block1.0.weight": (0.0019, 7e-06, 0.0055),
    "decoder.conv_refiner.2.block1.1.bias": (0.0015, 4.9e-06, 0.0048),
    "decoder.conv_refiner.2.block1.1.weight": (0.0013, 7.2e-06, 0.0044),
    "decoder.conv_refiner.2.block1.3.weight": (0.0013, 7.6e-06, 0.0037),
    "decoder.conv_refiner.2.disp_emb.bias": (0.00012, 5.1e-06, 0.0022),
    "decoder.conv_refiner.2.hidden_blocks.0.0.weight": (0.0017, 7e-06, 0.0042),
    "decoder.conv_refiner.4.block1.0.weight": (0.0022, 0.0033, 0.0075),
    "decoder.conv_refiner.4.block1.1.bias": (0.0018, 0.0035, 0.0059),
    "decoder.conv_refiner.4.block1.1.weight": (0.0018, 0.0032, 0.0062),
    "decoder.conv_refiner.4.block1.3.bias": (0.00024, 0.0015, 0.0015),
    "decoder.conv_refiner.4.block1.3.weight": (0.0018, 0.0031, 0.0062),
    "decoder.conv_refiner.4.disp_emb.bias": (0.00078, 0.0027, 0.0027),
    "decoder.conv_refiner.4.disp_emb.weight": (0.0022, 0.002, 0.0064),
    "decoder.conv_refiner.4.hidden_blocks.0.0.weight": (0.0025, 0.003, 0.0067),
    "decoder.conv_refiner.8.block1.0.weight": (0.00091, 1.9e-05, 0.0012),
    "decoder.conv_refiner.8.block1.1.bias": (0.00081, 5e-06, 0.0012),
    "decoder.conv_refiner.8.block1.3.weight": (2.6e-05, 2.2e-05, 0.00046),
    "decoder.conv_refiner.8.hidden_blocks.0.0.weight": (2.6e-05, 2.2e-05, 0.00061),
    "decoder.conv_refiner.8.hidden_blocks.0.1.bias": (6e-07, 7.3e-07, 0.0004),
    "decoder.conv_refiner.16.block1.0.weight": (4.6e-06, 3.5e-06, 0.00026),
    "decoder.conv_refiner.16.block1.1.bias": (1.8e-06, 1.8e-06, 0.00061),
    "decoder.proj.1.0.weight": (0.0034, 1.7e-05, 0.01),
    "decoder.proj.1.1.bias": (0.00017, 3e-06, 0.001),
    "decoder.proj.1.1.weight": (0.067, 0.0069, 0.021),
    "decoder.proj.2.0.weight": (0.0028, 6.6e-06, 0.0079),
    "decoder.proj.2.1.bias": (0.00022, 4.5e-06, 0.0017),
    "decoder.proj.2.1.weight": (0.07, 0.0051, 0.03),
    "decoder.proj.4.0.weight": (0.0022, 0.0034, 0.0072),
    "decoder.proj.4.1.bias": (0.0018, 0.0048, 0.0048),
    "decoder.proj.4.1.weight": (0.0023, 0.0034, 0.0074),
    "decoder.proj.8.0.weight": (0.00082, 1.9e-05, 0.0012),
    "decoder.proj.8.1.bias": (0.00018, 8.8e-06, 0.0012),
    "encoder.cnn.layers.0.weight": (0.018, 0.011, 0.013),
    "encoder.cnn.layers.1.bias": (0.022, 0.011, 0.016),
    "encoder.cnn.layers.1.weight": (0.02, 0.011, 0.013),
    "encoder.cnn.layers.3.weight": (0.018, 0.01, 0.012),
    "encoder.cnn.layers.4.bias": (0.024, 0.0094, 0.013),
    "encoder.cnn.layers.4.weight": (0.017, 0.012, 0.015),
    "encoder.cnn.layers.7.weight": (0.018, 0.01, 0.012),
    "encoder.cnn.layers.8.bias": (0.019, 0.01, 0.013),
    "encoder.cnn.layers.8.weight": (0.018, 0.011, 0.013),
    "encoder.cnn.layers.10.weight": (0.018, 0.01, 0.012),
    "encoder.cnn.layers.11.bias": (0.02, 0.009, 0.012),
    "encoder.cnn.layers.11.weight": (0.02, 0.0083, 0.013),
    "encoder.cnn.layers.14.weight": (0.018, 0.01, 0.012),
    "encoder.cnn.layers.15.bias": (0.021, 0.009, 0.013),
    "encoder.cnn.layers.15.weight": (0.02, 0.0092, 0.012),
    "encoder.cnn.layers.17.weight": (0.018, 0.01, 0.012),
    "encoder.cnn.layers.18.bias": (0.019, 0.011, 0.013),
    "encoder.cnn.layers.18.weight": (0.017, 0.0099, 0.012),
    "encoder.cnn.layers.20.weight": (0.018, 0.0093, 0.012),
    "encoder.cnn.layers.21.bias": (0.018, 0.01, 0.012),
    "encoder.cnn.layers.21.weight": (0.019, 0.011, 0.013),
    "encoder.cnn.layers.23.weight": (0.018, 0.0094, 0.012),
    "encoder.cnn.layers.24.bias": (0.022, 0.0016, 0.011),
    "encoder.cnn.layers.24.weight": (0.019, 0.0017, 0.011),
    "encoder.cnn.layers.27.weight": (0.019, 0.0017, 0.011),
    "encoder.cnn.layers.28.bias": (0.02, 0.0022, 0.013),
    "encoder.cnn.layers.28.weight": (0.019, 0.0014, 0.01),
    "encoder.cnn.layers.30.weight": (0.018, 0.0013, 0.0096),
    "encoder.cnn.layers.31.bias": (0.018, 0.0013, 0.0095),
    "encoder.cnn.layers.31.weight": (0.018, 0.0013, 0.0095),
    "encoder.cnn.layers.33.weight": (0.018, 0.0013, 0.0096),
    "encoder.cnn.layers.34.bias": (0.022, 0.0013, 0.01),
    "encoder.cnn.layers.34.weight": (0.018, 0.00096, 0.0069),
    "encoder.cnn.layers.36.weight": (0.019, 0.0011, 0.0072),
    "encoder.cnn.layers.37.bias": (0.032, 0.0016, 0.0091),
    "encoder.cnn.layers.37.weight": (0.00086, 2e-05, 0.0012),
}


def feeds_batch_norm(model: torch.nn.Module, name: str) -> bool:
    """Whether parameter `name` is the bias of a Conv2d whose next sibling
    in its Sequential is a BatchNorm2d (VGG, the projections, the refiners'
    depthwise convs): its exact gradient in train mode is 0."""
    if not name.endswith(".bias"):
        return False
    mod_name = name.rsplit(".", 1)[0]
    parent, _, idx = mod_name.rpartition(".")
    if not idx.isdigit() or not isinstance(model.get_submodule(mod_name), torch.nn.Conv2d):
        return False
    try:
        return isinstance(model.get_submodule(f"{parent}.{int(idx) + 1}"), torch.nn.BatchNorm2d)
    except AttributeError:
        return False


def kink_bound(name: str) -> float:
    return 2.0 * max(KINK_SENSITIVE[name])


def grad_mismatches(model: torch.nn.Module, got: dict[str, torch.Tensor],
                    ref: dict[str, torch.Tensor]) -> tuple[list[str], dict[str, float]]:
    """Hold `got` to `ref` (gradients by parameter name, every trainable
    parameter of `model`) under the rule above. Returns the failures and the
    worst readings: `grad_over_max` over the tensors held to GRAD_TOL,
    `kink_rel_l2_over_bound` over the named ones, `zero_max` over the biases
    before a BatchNorm, and the counts of each."""
    bad: list[str] = []
    worst = dict(grad_over_max=0.0, kink_rel_l2_over_bound=0.0, zero_max=0.0,
                 n_tol=0, n_kink=0, n_zero=0)
    for name, r in ref.items():
        g = got[name].double().cpu()
        r = r.double().cpu()
        if feeds_batch_norm(model, name):
            e = max(g.abs().max().item(), r.abs().max().item())
            worst["zero_max"] = max(worst["zero_max"], e)
            worst["n_zero"] += 1
            if e > ZERO_GRAD_TOL:
                bad.append(f"{name}: |g| {e:.3g} > {ZERO_GRAD_TOL} (exact 0)")
        elif name in KINK_SENSITIVE:
            e = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
            worst["kink_rel_l2_over_bound"] = max(worst["kink_rel_l2_over_bound"],
                                                  e / kink_bound(name))
            worst["n_kink"] += 1
            if e > kink_bound(name):
                bad.append(f"{name}: relative L2 {e:.3g} > {kink_bound(name):.3g}")
        else:
            e = ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
            worst["grad_over_max"] = max(worst["grad_over_max"], e)
            worst["n_tol"] += 1
            if e > GRAD_TOL:
                bad.append(f"{name}: max-abs {e:.3g} of max|g| > {GRAD_TOL}")
    return bad, worst
