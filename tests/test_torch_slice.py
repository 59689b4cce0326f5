"""The whole slice on the CPU: JAX `RomaMatcher` at `debug_roma_config()`
(full widths, 2 DINOv2 blocks, 1 decoder block, 1 hidden block per refiner,
112 -> 224) in float32, its variables carried into the port with
`state_dict_from_jax`, then the coarse pass, the upsample pass and the full
`match()` compared scale by scale. BatchNorm running statistics are
randomised on the JAX side before the carry."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from roma_tpu.models.matcher import RomaMatcher as JMatcher
from roma_tpu.models.zoo import debug_roma_config as j_debug_config
from roma_torch.models.matcher import RomaMatcher, RomaModel
from roma_torch.models.port import state_dict_from_jax
from roma_torch.models.zoo import debug_roma_config

# float32 on both sides; flows are in normalized units (1e-4 is 0.006 px at
# 112^2), certainties are logits before the final sigmoid. Measured max-abs
# errors are ~1e-6 (flows) and ~1e-5 (certainty logits).
FLOW_TOL = 1e-4
CERT_TOL = 1e-4


@pytest.fixture(scope="module")
def matchers():
    rng = np.random.default_rng(7)
    jm = JMatcher.init(jax.random.PRNGKey(0), dataclasses.replace(j_debug_config(), dtype="float32"))
    variables = jax.tree_util.tree_map(np.asarray, jm.params)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape) * 0.1
                         if jax.tree_util.keystr(path).endswith("['mean']")
                         else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    jm.params = jax.tree_util.tree_map(jax.numpy.asarray, variables)

    model = RomaModel(dataclasses.replace(debug_roma_config(), dtype="float32"))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, RomaMatcher(model, device="cpu")


def _close(got, ref, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= tol, f"{what}: max-abs {err:.3g} > {tol}"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@torch.no_grad()
def test_coarse_and_upsample_passes_per_scale(matchers):
    jm, tm = matchers
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((1, 112, 112, 3)).astype(np.float32) for _ in range(2))
    ref = jm._fwd(jm.params, a, b)
    got = tm.model(_t(a), _t(b), symmetric=True)
    assert sorted(got) == sorted(ref) == [1, 2, 4, 8, 16]
    for s in ref:
        _close(got[s]["flow"], ref[s]["flow"], FLOW_TOL, f"coarse flow s{s}")
        _close(got[s]["certainty"], ref[s]["certainty"], CERT_TOL, f"coarse cert s{s}")

    # upsample pass from the same finest flow/certainty, sf = sqrt(area ratio)
    a2, b2 = (rng.standard_normal((1, 224, 224, 3)).astype(np.float32) for _ in range(2))
    flow, cert = np.asarray(ref[1]["flow"]), np.asarray(ref[1]["certainty"])
    ref2 = jm._fwd_up(jm.params, a2, b2, flow, cert, 2.0)
    got2 = tm.model(_t(a2), _t(b2), symmetric=True, upsample=True, flow=_t(flow),
                    certainty=_t(cert), scale_factor=2.0)
    assert sorted(got2) == sorted(ref2) == [1, 2, 4, 8]
    for s in ref2:
        _close(got2[s]["flow"], ref2[s]["flow"], FLOW_TOL, f"upsample flow s{s}")
        _close(got2[s]["certainty"], ref2[s]["certainty"], CERT_TOL, f"upsample cert s{s}")


def test_match_end_to_end(matchers):
    """Bicubic preprocessing, both passes, attenuation, sigmoid, out-of-range
    mask and the symmetric side-by-side warp. Tolerance 1e-4 on the warp and
    on the certainty in [0, 1]."""
    jm, tm = matchers
    rng = np.random.default_rng(5)
    im_a, im_b = (rng.uniform(0, 1, (1, 140, 180, 3)).astype(np.float32) for _ in range(2))
    rw, rc = jm.match(im_a, im_b, batched=True)
    w, c = tm.match(im_a, im_b, batched=True)
    assert tuple(w.shape) == (1, 224, 448, 4) and tuple(c.shape) == (1, 224, 448)
    assert float(c.min()) >= 0 and float(c.max()) <= 1
    _close(w, rw, FLOW_TOL, "warp")
    _close(c, rc, CERT_TOL, "certainty")
    w1, c1 = tm.match(im_a[0], im_b[0])
    assert torch.equal(w1, w[0]) and torch.equal(c1, c[0])


def test_match_pil_inputs_and_pixel_coordinates(matchers):
    """PIL inputs take the host PIL bicubic resize + uint8 normalisation on
    both sides; then the warp in pixel coordinates of both images."""
    from PIL import Image

    jm, tm = matchers
    rng = np.random.default_rng(9)
    ims = [Image.fromarray(rng.uniform(0, 255, (150, 190, 3)).astype(np.uint8))
           for _ in range(2)]
    rw, rc = jm.match(*ims)
    w, c = tm.match(*ims)
    _close(w, rw, FLOW_TOL, "warp (PIL)")
    _close(c, rc, CERT_TOL, "certainty (PIL)")
    ka, kb = tm.to_pixel_coordinates(w, 150, 190, 160, 200)
    ra, rb = jm.to_pixel_coordinates(rw, 150, 190, 160, 200)
    _close(ka, ra, 1e-2, "pixels in A")  # 1e-4 normalized -> 1e-2 px at 200 px
    _close(kb, rb, 1e-2, "pixels in B")
