"""ResNet-50 of the port against the JAX package's (`roma_tpu/models/
resnet.py`) on the CPU in float32: the JAX initialisation with random
BatchNorm statistics and affines carried across by
`port.resnet_state_dict_from_jax`, every pyramid level within
1e-4 x max|JAX| (convolutions summed in another order); the pyramid's
shapes, `early_exit` and replace-stride-with-dilation, as
tests/test_roma_full.py holds the JAX model's; frozen BatchNorm."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roma_torch.models.port import resnet_state_dict_from_jax
from roma_torch.models.resnet import ResNet50
from roma_tpu.models.resnet import ResNet50 as JaxResNet50


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_variables(net, x, rng):
    """`net.init`, then every BatchNorm's scale, bias, mean and variance
    drawn at random (the init's are 1, 0, 0, 1)."""
    v = jax.tree_util.tree_map(np.array, dict(net.init(jax.random.PRNGKey(0), x)))

    def draw(tree):
        for k, t in tree.items():
            if isinstance(t, dict):
                draw(t)
            elif k in ("scale", "var"):
                tree[k] = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
            elif k in ("bias", "mean") and t.ndim == 1:
                tree[k] = (0.1 * rng.standard_normal(t.shape)).astype(np.float32)

    for coll in ("params", "batch_stats"):
        for name, sub in v[coll].items():
            if name.startswith("bn") or name.startswith("layer"):
                draw(sub)
    return v


@pytest.mark.parametrize("kw", [{}, {"dilation": (False, True, True)}, {"early_exit": True}],
                         ids=["default", "dilated", "early_exit"])
def test_resnet50_matches_jax(rng, kw):
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    net = JaxResNet50(dtype=jnp.float32, **kw)
    variables = _jax_variables(net, jnp.asarray(x), rng)
    ref = net.apply(variables, jnp.asarray(x))
    model = ResNet50(dtype=torch.float32, **kw)
    missing, unexpected = model.load_state_dict(resnet_state_dict_from_jax(variables),
                                                strict=False)
    assert not unexpected
    assert all(k.startswith(("layer3.", "layer4.")) for k in missing) and (
        bool(missing) == bool(kw.get("early_exit")))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x).permute(0, 3, 1, 2))  # BN stays frozen
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert set(got) == set(ref) == ({1, 2, 4, 8} if kw.get("early_exit") else {1, 2, 4, 8, 16, 32})
    for s, r in ref.items():
        r = np.asarray(r)
        g = got[s].permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape, s
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max(), rtol=0, err_msg=str(s))


def test_resnet50_pyramid_shapes_and_torchvision_names(rng):
    """The counterpart of tests/test_roma_full.py's pyramid test, and
    torchvision's resnet50 key names."""
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        feats = ResNet50(dtype=torch.float32)(x)
        assert set(feats) == {1, 2, 4, 8, 16, 32}
        for scale, ch in [(2, 64), (4, 256), (8, 512), (16, 1024), (32, 2048)]:
            assert feats[scale].shape[1:] == (ch, 64 // scale, 64 // scale), scale
        assert set(ResNet50(early_exit=True, dtype=torch.float32)(x)) == {1, 2, 4, 8}
        dil = ResNet50(dilation=(False, True, True), dtype=torch.float32)(x)
        assert dil[16].shape[2:] == dil[8].shape[2:] == dil[32].shape[2:]
        bf = ResNet50()(x)
        assert bf[2].dtype == torch.bfloat16 and bf[1].dtype == torch.float32
    keys = ResNet50().state_dict().keys()
    assert {"conv1.weight", "bn1.running_var", "layer1.0.downsample.0.weight",
            "layer1.0.downsample.1.running_mean", "layer4.2.conv3.weight",
            "layer4.2.bn3.bias"} <= set(keys)
    assert not any(k.startswith("fc.") for k in keys)
    assert sum(1 for k in keys if k.endswith("conv1.weight")) == 1 + 3 + 4 + 6 + 3
