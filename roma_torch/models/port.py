"""Weight carry from the JAX package's variables to this package's state_dict.

`state_dict_from_jax` is the exact inverse of the JAX package's
``models/port.py::port_roma`` and `tiny_state_dict_from_jax` that of its
``port_tiny_roma``: flax HWIO conv kernels -> OIHW, dense (I, O)
-> (O, I), BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
running_var``. The port's modules carry the reference RoMa key names, so the
result loads with ``RomaModel.load_state_dict`` and a reference checkpoint
would load the same way (`load_reference_tiny` warm-starts Tiny RoMa from
one, as the JAX package's Tiny training CLI does through ``port_tiny_roma``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# torchvision vgg19_bn().features conv indices for the first 4 stages
VGG_CONV_IDX = [0, 3, 7, 10, 14, 17, 20, 23, 27, 30, 33, 36]


def conv_weight(k) -> torch.Tensor:
    """flax (kh, kw, I, O) -> torch Conv2d (O, I, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


def linear_weight(k) -> torch.Tensor:
    """flax Dense (I, O) -> torch Linear (O, I)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).T))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _count(tree: Mapping[str, Any], prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit())


class _Writer:
    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def conv(self, key: str, p: Mapping[str, Any]) -> None:
        self.sd[f"{key}.weight"] = conv_weight(p["kernel"])
        if "bias" in p:
            self.sd[f"{key}.bias"] = _t(p["bias"])

    def linear(self, key: str, p: Mapping[str, Any]) -> None:
        self.sd[f"{key}.weight"] = linear_weight(p["kernel"])
        if "bias" in p:
            self.sd[f"{key}.bias"] = _t(p["bias"])

    def norm(self, key: str, p: Mapping[str, Any]) -> None:
        self.sd[f"{key}.weight"] = _t(p["scale"])
        self.sd[f"{key}.bias"] = _t(p["bias"])

    def batchnorm(self, key: str, p: Mapping[str, Any] | None, s: Mapping[str, Any]) -> None:
        """`p` is None for BatchNorm(affine=False), which has no weight or bias."""
        if p is not None:
            self.norm(key, p)
        self.sd[f"{key}.running_mean"] = _t(s["mean"])
        self.sd[f"{key}.running_var"] = _t(s["var"])
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def vit_block(self, key: str, p: Mapping[str, Any]) -> None:
        self.norm(f"{key}.norm1", p["norm1"])
        self.linear(f"{key}.attn.qkv", p["attn"]["qkv"])
        self.linear(f"{key}.attn.proj", p["attn"]["proj"])
        self.norm(f"{key}.norm2", p["norm2"])
        # both FFN layouts of the JAX Block: "mlp" (fc1, fc2) and "swiglu"
        # (w12, w3), each under the same names in the port
        for name in ("fc1", "fc2", "w12", "w3"):
            if name in p["mlp"]:
                self.linear(f"{key}.mlp.{name}", p["mlp"][name])
        for ls in ("ls1", "ls2"):
            if ls in p:
                self.sd[f"{key}.{ls}.gamma"] = _t(p[ls]["gamma"])


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX `RomaModel` variables ({"params", "batch_stats"}, numpy leaves)
    -> this package's `RomaModel` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()

    cnn_p, cnn_s = params["encoder"]["cnn"], stats["encoder"]["cnn"]
    for j, idx in enumerate(VGG_CONV_IDX):
        w.conv(f"encoder.cnn.layers.{idx}", cnn_p[f"conv_{j}"])
        w.batchnorm(f"encoder.cnn.layers.{idx + 1}", cnn_p[f"bn_{j}"], cnn_s[f"bn_{j}"])

    if "dinov2" in params["encoder"]:
        dp = params["encoder"]["dinov2"]
        w.sd["encoder.dinov2.cls_token"] = _t(dp["cls_token"])
        w.sd["encoder.dinov2.pos_embed"] = _t(dp["pos_embed"])
        w.conv("encoder.dinov2.patch_embed.proj", dp["patch_embed"])
        for i in range(_count(dp, "block_")):
            w.vit_block(f"encoder.dinov2.blocks.{i}", dp[f"block_{i}"])
        w.norm("encoder.dinov2.norm", dp["norm"])

    dec_p, dec_s = params["decoder"], stats["decoder"]
    ed = dec_p["embedding_decoder"]
    for i in range(_count(ed, "block_")):
        w.vit_block(f"decoder.embedding_decoder.blocks.{i}", ed[f"block_{i}"])
    w.linear("decoder.embedding_decoder.to_out", ed["to_out"])
    w.conv("decoder.gps.16.pos_conv", dec_p["gp16"]["pos_conv"])

    for name in sorted(k for k in dec_p if k.startswith("proj_")):
        s = name[len("proj_"):]
        w.conv(f"decoder.proj.{s}.0", dec_p[name]["layers_0"])
        w.batchnorm(f"decoder.proj.{s}.1", dec_p[name]["layers_1"],
                    dec_s[name]["layers_1"])

    for name in sorted(k for k in dec_p if k.startswith("refiner_")):
        s = name[len("refiner_"):]
        rp, rs = dec_p[name], dec_s[name]
        key = f"decoder.conv_refiner.{s}"
        w.conv(f"{key}.disp_emb", rp["disp_emb"])
        blocks = [("block1", "block_in")] + [
            (f"hidden_blocks.{i}", f"block_{i}") for i in range(_count(rp, "block_"))
        ]
        for dst, src in blocks:
            w.conv(f"{key}.{dst}.0", rp[src]["conv1"])
            w.batchnorm(f"{key}.{dst}.1", rp[src]["norm"], rs[src]["norm"])
            w.conv(f"{key}.{dst}.3", rp[src]["conv2"])
        w.conv(f"{key}.out_conv", rp["out_conv"])
    return w.sd


def dino_head_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX `DINOHead` variables ({"params"}, numpy leaves) -> this
    package's `DINOHead` state_dict: ``mlp_{i}`` -> ``mlp.{2i}`` (the
    Sequential's Linear between GELUs; ``mlp`` itself for one layer) and
    the prototypes ``last_layer_v`` (bottleneck, out) ->
    ``last_layer.weight`` (out, bottleneck), unnormalised as stored."""
    params = variables["params"]
    w = _Writer()
    n = _count(params, "mlp_")
    for i in range(n):
        w.linear("mlp" if n == 1 else f"mlp.{2 * i}", params[f"mlp_{i}"])
    w.sd["last_layer.weight"] = linear_weight(params["last_layer_v"])
    return w.sd


# reference XFeat block -> the JAX package's flax block name
XFEAT_BLOCKS = [(f"block{i}.{j}", f"block{i}_{j}")
                for i, n in ((1, 4), (2, 2), (3, 3), (4, 3), (5, 4)) for j in range(n)]
XFEAT_BLOCKS += [("block_fusion.0", "fusion_0"), ("block_fusion.1", "fusion_1")]


def tiny_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX `TinyRoma` variables ({"params", "batch_stats"}, numpy leaves)
    -> this package's `TinyRoma` state_dict (trainable reference layout,
    ``xfeat.0.*``). Every ConvBlock's BatchNorm is affine=False."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()

    def block(key: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
        w.conv(f"{key}.layer.0", p["Conv_0"])
        w.batchnorm(f"{key}.layer.1", p.get("BatchNorm_0"), s["BatchNorm_0"])

    bp, bs = params["backbone"], stats["backbone"]
    for dst, src in XFEAT_BLOCKS:
        block(f"xfeat.0.{dst}", bp[src], bs[src])
    w.conv("xfeat.0.skip1.1", bp["skip1_conv"])
    w.conv("xfeat.0.block_fusion.2", bp["fusion_conv"])
    for name in ("coarse_matcher", "fine_matcher"):
        mp, ms = params[name], stats[name]
        n = _count(mp, "block_")
        for i in range(n):
            block(f"{name}.{i}", mp[f"block_{i}"], ms[f"block_{i}"])
        w.conv(f"{name}.{n}", mp["head"])
    return w.sd


XFEAT_TRUNK = ("block1.", "block2.", "block3.", "block4.", "block5.", "skip1.", "block_fusion.")


def load_reference_tiny(model: torch.nn.Module, state: Mapping[str, Any]) -> list[str]:
    """Load a reference Tiny RoMa checkpoint's state_dict into `model` (a
    TinyRoma), in the layouts the JAX package's ``port_tiny_roma`` reads:
    the trunk's keys under ``xfeat.0.``, ``net.`` or bare (the raw XFeat
    checkpoint), absent in the frozen layout; the matchers' ConvBlocks
    (``{coarse,fine}_matcher.{i}.layer.*``) and heads as they are. Other
    keys (XFeat's detection heads) are not read. Returns the model's keys
    the checkpoint did not set; raises if a key it sets has another shape."""
    blocks = len(model.coarse_matcher) - 1
    own = model.state_dict()
    picked: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        for prefix in ("xfeat.0.", "net.", ""):
            rest = key[len(prefix):]
            if key.startswith(prefix) and rest.startswith(XFEAT_TRUNK):
                picked[f"xfeat.0.{rest}"] = value
                break
        else:
            root, _, rest = key.partition(".")
            idx = rest.split(".")[0]
            if root in ("coarse_matcher", "fine_matcher") and idx.isdigit() and (
                    int(idx) == blocks or rest.split(".")[1:2] == ["layer"]):
                picked[key] = value
    picked = {k: torch.as_tensor(np.asarray(v)) for k, v in picked.items() if k in own}
    missing, _ = model.load_state_dict(picked, strict=False)
    return missing


def resnet_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX `ResNet50` variables ({"params", "batch_stats"}, numpy leaves)
    -> this package's `ResNet50` state_dict (torchvision's key names):
    ``conv1``/``bn1``, and ``layer{i}_{j}``'s ``conv1..3``, ``bn1..3``,
    ``proj`` and ``bn_proj`` as ``layer{i}.{j}.conv1..3``, ``bn1..3``,
    ``downsample.0`` and ``downsample.1``."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()
    w.conv("conv1", params["conv1"])
    w.batchnorm("bn1", params["bn1"], stats["bn1"])
    for name, p in params.items():
        if not name.startswith("layer"):
            continue
        key = name.replace("_", ".")
        for i in (1, 2, 3):
            w.conv(f"{key}.conv{i}", p[f"conv{i}"])
            w.batchnorm(f"{key}.bn{i}", p[f"bn{i}"], stats[name][f"bn{i}"])
        if "proj" in p:
            w.conv(f"{key}.downsample.0", p["proj"])
            w.batchnorm(f"{key}.downsample.1", p["bn_proj"], stats[name]["bn_proj"])
    return w.sd
