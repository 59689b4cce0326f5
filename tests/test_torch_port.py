"""Weight carry: `state_dict_from_jax` is the exact inverse of the JAX
package's `port_roma`, and the port's module names are the reference RoMa
state_dict names that `port_roma` consumes."""

import dataclasses

import numpy as np
import torch

from roma_tpu.models.port import port_dinov2, port_roma, port_tiny_roma
from roma_torch.config import TinyRomaConfig
from roma_torch.models.port import state_dict_from_jax, tiny_state_dict_from_jax
from roma_torch.models.zoo import build_model, debug_roma_config

DINO = "encoder.dinov2."


def _debug_model(rng):
    model = build_model(dataclasses.replace(debug_roma_config(), dtype="float32"), seed=3)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.from_numpy(rng.standard_normal(m.num_features).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, m.num_features).astype(np.float32)))
    return model


def test_state_dict_round_trip_through_port_roma(rng):
    """torch state_dict -> port_roma (JAX variables) -> state_dict_from_jax
    -> identical tensors, every key, bit for bit."""
    sd = _debug_model(rng).state_dict()
    main = {k: v.numpy() for k, v in sd.items() if not k.startswith(DINO)}
    dino = {k[len(DINO):]: v.numpy() for k, v in sd.items() if k.startswith(DINO)}
    variables = port_roma(main, num_decoder_blocks=1, refiner_blocks=1)
    # port_roma's own DINOv2 call assumes 24 blocks; the debug model has 2
    variables["params"]["encoder"]["dinov2"] = port_dinov2(dino, depth=2)["params"]
    back = state_dict_from_jax(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k].to(v.dtype), v), k


def test_reference_key_names(rng):
    sd = _debug_model(rng).state_dict()
    for key in ("encoder.cnn.layers.0.weight", "encoder.cnn.layers.37.running_var",
                "encoder.dinov2.patch_embed.proj.weight", "encoder.dinov2.blocks.1.ls2.gamma",
                "encoder.dinov2.blocks.0.attn.qkv.bias", "encoder.dinov2.norm.weight",
                "decoder.embedding_decoder.blocks.0.attn.qkv.weight",
                "decoder.embedding_decoder.to_out.weight", "decoder.gps.16.pos_conv.weight",
                "decoder.proj.16.0.weight", "decoder.proj.1.1.running_mean",
                "decoder.conv_refiner.16.disp_emb.weight",
                "decoder.conv_refiner.1.block1.0.weight",
                "decoder.conv_refiner.4.hidden_blocks.0.1.running_var",
                "decoder.conv_refiner.2.hidden_blocks.0.3.bias",
                "decoder.conv_refiner.8.out_conv.weight"):
        assert key in sd, key
    # the match decoder's blocks carry no qkv bias (DINOv2's do)
    assert "decoder.embedding_decoder.blocks.0.attn.qkv.bias" not in sd


def test_tiny_state_dict_round_trip_through_port_tiny_roma(rng):
    """Tiny RoMa: torch state_dict (trainable reference layout) ->
    port_tiny_roma -> tiny_state_dict_from_jax -> identical tensors, every
    key, bit for bit; the affine-free BatchNorms carry no weight or bias."""
    model = build_model(TinyRomaConfig(dtype="float32"), seed=2)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert m.weight is None and m.bias is None
            m.running_mean.copy_(torch.from_numpy(rng.standard_normal(m.num_features).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, m.num_features).astype(np.float32)))
    sd = model.state_dict()
    back = tiny_state_dict_from_jax(port_tiny_roma({k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k
    for key in ("xfeat.0.block1.0.layer.0.weight", "xfeat.0.block5.3.layer.1.running_var",
                "xfeat.0.skip1.1.bias", "xfeat.0.block_fusion.2.weight",
                "coarse_matcher.3.layer.1.running_mean", "coarse_matcher.4.weight",
                "fine_matcher.0.layer.0.weight", "fine_matcher.4.bias"):
        assert key in sd, key
