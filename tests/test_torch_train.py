"""One full-RoMa training step, JAX vs the port, on the CPU: the JAX
package's `make_roma_train_state` + `make_train_step(robust_loss)` at
`debug_roma_config()` in float32 (full widths, 2 DINOv2 blocks, 1 decoder
block, 1 hidden block per refiner) at 112^2, batch 1; its initial
variables carried into the port with `state_dict_from_jax`, then the port's
`make_roma_train_state` + `make_train_step` on the same batch. The JAX
step's gradients before the clip are read out by a transform chained in
front of its optimizer that keeps them as its state (one compile of the
JAX step); the gradient tree is mapped to torch names by the same
`state_dict_from_jax`, a pure layout transform.

Tolerances (float32 on both sides, sums in another order):
- the loss and every metric: rel 1e-4;
- the gradients before the clip under `roma_torch.train.grad_parity`
  (chip_smoke.py holds the port's GPU step to its CPU step by the same
  rule): every tensor within 1e-3 * max|g| of its tensor, but a conv bias
  feeding a training BatchNorm (an exact 0: both sides below 1e-6) and the
  tensors named in `KINK_SENSITIVE`, each with its measured readings, held
  to a relative L2 error of twice the largest (float32 crossings of ReLU
  kinks behind small-batch training BatchNorms, explained there);
- the parameters after the step: 2.5 * lr abs (Adam's first step moves a
  parameter by about lr * sign(g), and a tiny gradient's sign is noise);
- the updated BatchNorm statistics: 1e-5 abs.
Where no kink is crossed the same modules are held to 1e-3 * max|g|: the
refiners in train mode (checkpointed blocks, local correlation with its
f1 and flow detached) against the JAX package's, every parameter's and
input's gradient; and VGG in train mode under activation checkpointing
against itself without (the recompute must see the same batch statistics).
Beside it: DINOv2 bit-unchanged, each running statistic moved once under
activation checkpointing, the clip and the LR schedule against optax,
`ema_update`, a checkpoint round trip through the latest pointer, and the
metrics logger.

`PYTHONPATH=. python tests/test_torch_train.py` prints the readings behind
`KINK_SENSITIVE` that the CPU gives: JAX vs the port, and the port against
itself with the images moved by 1e-7 (16 seeds) or on one thread, in this
test's configuration and in chip_smoke.py's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from roma_tpu.config import TrainConfig as JTrainConfig
from roma_tpu.losses.robust_loss import robust_loss as j_robust_loss
from roma_tpu.models.zoo import debug_roma_config as j_debug_config
from roma_tpu.train import train as jtrain
from roma_torch.config import TrainConfig
from roma_torch.losses.robust_loss import robust_loss
from roma_torch.models.layers import batch_norm_train, checkpoint
from roma_torch.models.matcher import RomaModel
from roma_torch.models.port import state_dict_from_jax
from roma_torch.models.vgg import VGG19
from roma_torch.models.zoo import debug_roma_config
from roma_torch.train import train as ttrain
from roma_torch.train.checkpoint import CheckPoint
from roma_torch.train.grad_parity import GRAD_TOL, KINK_SENSITIVE, grad_mismatches
from roma_torch.train.logging import MetricsLogger

HW = (112, 112)
LOSS_RTOL = 1e-4
PARAM_TOL = 2.5      # times the group's learning rate
STAT_TOL = 1e-5


def make_batch(rng, b=1, h=112, w=112):
    """`tests/test_train.py::make_batch` with varied depth and a small
    rotation, so that the GT warp has invalid pixels and every loss term
    has support."""
    K = np.array([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    a = 0.05
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[0, 3] = 0.05
    depth = lambda: (2.0 + 0.3 * rng.standard_normal((b, h, w))).astype(np.float32)
    return {
        "im_A": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "im_B": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "im_A_depth": depth(),
        "im_B_depth": depth(),
        "T_1to2": np.tile(T, (b, 1, 1)),
        "K1": np.tile(K, (b, 1, 1)),
        "K2": np.tile(K, (b, 1, 1)),
    }


def _capture_grads():
    """A transform that passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_steps():
    """One step on each side from the same weights and batch."""
    cfg = TrainConfig(batch_size=1)
    jcfg = JTrainConfig(batch_size=1)
    roma_cfg = dataclasses.replace(j_debug_config(), dtype="float32")
    jstate = jtrain.make_roma_train_state(jax.random.PRNGKey(0), jcfg, roma_cfg=roma_cfg, hw=HW)
    tx = optax.chain(_capture_grads(), jstate.tx)
    jstate = jstate.replace(tx=tx, opt_state=tx.init(jstate.params))
    variables = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}

    model = RomaModel(dataclasses.replace(debug_roma_config(), dtype="float32"))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    tstate = ttrain.make_roma_train_state(cfg, model=model, device="cpu")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    batch = make_batch(np.random.default_rng(5))
    jnew, jmetrics = jtrain.make_train_step(loss_fn=j_robust_loss)(jstate, batch)
    tnew, tmetrics = ttrain.make_train_step(robust_loss)(tstate, batch)
    grads = {"params": _np(jnew.opt_state[0]), "batch_stats": variables["batch_stats"]}
    return dict(
        before=before,
        jmetrics={k: float(v) for k, v in jmetrics.items()}, tmetrics=tmetrics, tstate=tnew,
        jgrads=state_dict_from_jax(grads),
        jafter=state_dict_from_jax({"params": _np(jnew.params),
                                    "batch_stats": _np(jnew.batch_stats)}),
        model=model, cfg=cfg)


@pytest.fixture(scope="module")
def steps():
    return run_steps()


def test_loss_and_metrics_match_jax(steps):
    jm, tm = steps["jmetrics"], steps["tmetrics"]
    assert set(jm) == set(tm) and "gm_cls_loss_16" in tm
    for k, v in jm.items():
        got = float(tm[k])
        assert np.isfinite(got)
        assert abs(got - v) <= LOSS_RTOL * abs(v) + 1e-12, f"{k}: {got} vs JAX {v}"


def _jax_and_port_grads(steps):
    """The port's gradients before the clip (the clip scaled them in place:
    undone with the norm) and the JAX package's, by torch name."""
    model = steps["model"]
    norm = float(steps["tmetrics"]["grad_norm"])
    scale = max(norm, steps["cfg"].grad_clip) / steps["cfg"].grad_clip
    got, ref = {}, {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert name.startswith("encoder.dinov2.") and p.grad is None
            assert np.abs(steps["jgrads"][name].numpy()).max() == 0.0, f"JAX gradient into {name}"
            continue
        got[name] = p.grad * scale
        ref[name] = steps["jgrads"][name]
    return got, ref


def test_gradients_before_the_clip_match_jax(steps):
    got, ref = _jax_and_port_grads(steps)
    bad, worst = grad_mismatches(steps["model"], got, ref)
    assert not bad, f"{len(bad)} gradients off: {bad[:10]}"
    assert worst["n_tol"] > 60 and worst["n_kink"] == len(KINK_SENSITIVE) and worst["n_zero"] > 20


def test_parameters_and_bn_statistics_after_the_step(steps):
    model, cfg = steps["model"], steps["cfg"]
    lrs = {"encoder.cnn.": cfg.lr_encoder * cfg.batch_size,
           "decoder.": cfg.lr_decoder * cfg.batch_size}
    sd = model.state_dict()
    moved = 0
    for name, t in sd.items():
        ref = steps["jafter"][name].numpy()
        got = t.numpy()
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            assert np.abs(got - ref).max() <= STAT_TOL, name
            moved += int(not np.array_equal(got, steps["before"][name].numpy()))
            continue
        if name.startswith("encoder.dinov2."):
            assert torch.equal(t, steps["before"][name]), f"DINOv2 {name} changed"
            continue
        lr = next(v for k, v in lrs.items() if name.startswith(k))
        assert np.abs(got - ref).max() <= PARAM_TOL * lr, name
    assert moved > 20
    assert steps["tstate"].step == 1 and steps["tstate"].updates == 1


def test_checkpointed_statistics_move_once():
    """VGG under activation checkpointing (its forward runs again in
    backward): after one forward + backward each running statistic equals
    one momentum update from the batch."""
    torch.manual_seed(0)
    vgg = VGG19(dtype=torch.float32).train()
    x = torch.randn(2, 3, 16, 16)
    bn = vgg.layers[1]
    mean0 = bn.running_mean.clone()
    feats = checkpoint(vgg, x)
    sum(f.sum() for f in feats.values()).backward()
    y = torch.nn.functional.conv2d(x, vgg.layers[0].weight, vgg.layers[0].bias, padding=1)
    assert torch.allclose(bn.running_mean, 0.9 * mean0 + 0.1 * y.mean((0, 2, 3)), atol=1e-6)
    assert vgg.layers[0].weight.grad is not None


def _state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _grads_state(module):
    """The state dict with each parameter replaced by its gradient, for the
    JAX package's layout transforms."""
    sd = _state(module)
    sd.update({n: p.grad.numpy().copy() for n, p in module.named_parameters()})
    return sd


def _hold_tree(got, ref, what):
    """Every leaf of `got` within GRAD_TOL * max|ref| of its own; the conv
    biases before a training BatchNorm (exact zeros) below 1e-6 of the
    largest gradient on both sides."""
    ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    top = max(np.abs(np.asarray(r)).max() for r in ref.values())
    n = 0
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        key = jax.tree_util.keystr(path)
        g, r = np.asarray(g), np.asarray(ref[path])
        if "conv1" in key and "bias" in key:
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-6 * top, f"{what} {key}"
        else:
            err = np.abs(g - r).max()
            assert err <= GRAD_TOL * np.abs(r).max(), f"{what} {key}: {err:.3g}"
        n += 1
    return n


@pytest.mark.parametrize("C,emb,radius,blocks", [
    (128, 16, 2, 1),   # with local correlation
    (64, 16, None, 2),
    (9, 6, None, 2),   # the scale-1 width, whose inference path is the chain
])
def test_refiner_train_gradients_match_jax(C, emb, radius, blocks):
    """One refiner in train mode, both sides from the same weights and
    statistics: batch-statistic BatchNorm, each block checkpointed, local
    correlation with f1 and flow detached. The gradients of a random
    functional of (delta_flow, delta_certainty) with respect to every
    parameter and to x, y and flow within 1e-3 max|g|, and the moved
    statistics within 1e-5."""
    from roma_tpu.models import port as jport
    from roma_tpu.models.refiner import ConvRefiner as JConvRefiner
    from roma_torch.models.refiner import ConvRefiner

    rng = np.random.default_rng(C)
    hidden = 2 * C + emb + (0 if radius is None else (2 * radius + 1) ** 2)
    torch.manual_seed(0)
    ref_mod = ConvRefiner(hidden, hidden, emb, radius, hidden_blocks=blocks, dtype=torch.float32)
    for m in ref_mod.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(m.num_features)))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.num_features)))
    params, stats = jport.port_conv_refiner(_state(ref_mod), hidden_blocks=blocks)
    B, H, W = 2, 11, 13
    x, y = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(2))
    gy, gx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    flow = (np.stack([gx, gy], -1)[None] + 0.4 * rng.standard_normal((B, H, W, 2))).astype(np.float32)
    cf, cc = (rng.standard_normal((B, H, W, k)).astype(np.float32) for k in (2, 1))

    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, y, flow)]
    dflow, dcert = ref_mod.train()(ins[0].permute(0, 3, 1, 2), ins[1].permute(0, 3, 1, 2),
                                   ins[2], scale_factor=1.5)
    ((dflow * torch.from_numpy(cf)).sum() + (dcert * torch.from_numpy(cc)).sum()).backward()

    jmod = JConvRefiner(hidden_dim=hidden, displacement_emb_dim=emb, local_corr_radius=radius,
                        hidden_blocks=blocks, dtype=jnp.float32)

    def loss(params, x, y, flow):
        (a, b), upd = jmod.apply({"params": params, "batch_stats": stats}, x, y, flow,
                                 scale_factor=1.5, train=True, mutable=["batch_stats"])
        return jnp.sum(a * cf) + jnp.sum(b * cc), upd

    grads, upd = jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(params, x, y, flow)
    got_params, got_stats = jport.port_conv_refiner(_grads_state(ref_mod), hidden_blocks=blocks)
    assert _hold_tree(got_params, grads[0], "param") > 10
    for name, t, r in zip(("x", "y", "flow"), ins, grads[1:]):
        r = np.asarray(r)
        err = np.abs(t.grad.numpy() - r).max()
        assert err <= GRAD_TOL * np.abs(r).max(), f"d{name}: {err:.3g}"
    for path, v in jax.tree_util.tree_leaves_with_path(got_stats):
        r = dict(jax.tree_util.tree_leaves_with_path(upd["batch_stats"]))[path]
        assert np.abs(np.asarray(v) - np.asarray(r)).max() <= STAT_TOL, jax.tree_util.keystr(path)


def test_vgg_checkpointed_gradients_equal_plain():
    """VGG in train mode under activation checkpointing (its forward runs
    again in backward, inside `frozen_stats`) against the same forward
    without: the same gradients of every parameter and of the input (the
    recompute sees the same batch statistics), and the same statistics."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 32, 40)).astype(np.float32)
    out = []
    for ck in (False, True):
        torch.manual_seed(0)
        vgg = VGG19(dtype=torch.float32).train()
        xt = torch.from_numpy(x).requires_grad_(True)
        feats = checkpoint(vgg, xt) if ck else vgg(xt)
        cot = np.random.default_rng(7)
        sum((f * torch.from_numpy(cot.standard_normal(f.shape).astype(np.float32))).sum()
            for f in feats.values()).backward()
        out.append(({n: p.grad for n, p in vgg.named_parameters()}, xt.grad,
                    {k: v for k, v in vgg.state_dict().items() if "running" in k}))
    (g0, x0, s0), (g1, x1, s1) = out
    assert torch.equal(x0, x1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0) and len(g0) == 48
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.parametrize("unbiased", [False, True])
def test_batch_norm_train_conventions(unbiased):
    bn = torch.nn.BatchNorm2d(3)
    bn.running_var.fill_(2.0)
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(1))
    out = batch_norm_train(bn, x, 0.99 if unbiased else 0.9, unbiased)
    var = x.var((0, 2, 3), unbiased=False)
    ref = (x - x.mean((0, 2, 3))[:, None, None]) / torch.sqrt(var + bn.eps)[:, None, None]
    assert torch.allclose(out, ref, atol=1e-5)
    m = 0.99 if unbiased else 0.9
    tracked = x.var((0, 2, 3), unbiased=unbiased)
    assert torch.allclose(bn.running_var, m * 2.0 + (1 - m) * tracked, atol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(2)
    gs = [rng.standard_normal(s).astype(np.float32) * scale * 1e-3 for s in ((3, 4), (5,))]
    ref, _ = optax.clip_by_global_norm(0.01).update([jnp.asarray(g) for g in gs], None)
    got = [torch.from_numpy(g.copy()) for g in gs]
    norm = ttrain.clip_by_global_norm(got, 0.01)
    assert abs(float(norm) - float(optax.global_norm(gs))) < 1e-7
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_lr_schedule_and_adamw_match_optax():
    """Six updates of one tensor through the JAX package's scheduled AdamW
    and the port's (AdamW + lr_multiplier), the milestone at 3 updates."""
    cfg = TrainConfig(batch_size=2, steps=10, milestone_frac=0.5)
    jcfg = JTrainConfig(batch_size=2, steps=10, milestone_frac=0.5)
    assert [ttrain.lr_multiplier(cfg, u) for u in range(5)] == [1, 1, 1, 0.2, 0.2]
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(7).astype(np.float32)
    tx = jtrain._adamw_with_schedule(jcfg, 1e-2)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.AdamW([{"params": [tp], "lr": 1e-2, "base_lr": 1e-2}], eps=1e-8,
                            weight_decay=0.01)
    for u in range(6):
        g = rng.standard_normal(7).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = 1e-2 * ttrain.lr_multiplier(cfg, u)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(4)
    p = {"a": rng.standard_normal((2, 3)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    e = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    ref = jtrain.ema_update(e, p, decay=0.9)
    ema = ttrain.init_ema({k: torch.from_numpy(v) for k, v in e.items()})
    got = ttrain.ema_update(ema, {k: torch.from_numpy(v) for k, v in p.items()}, decay=0.9)
    assert got is ema and all(
        np.allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-7) for k in p)
    assert ema["a"].data_ptr() != torch.from_numpy(e["a"]).data_ptr()


def _tiny_state():
    model = RomaModel(debug_roma_config())
    return ttrain.make_roma_train_state(TrainConfig(batch_size=1), model=model, device="cpu")


def test_checkpoint_round_trip_through_latest(tmp_path):
    state = _tiny_state()
    ck = CheckPoint(str(tmp_path), keep=3)
    assert ck.latest_step() is None and ck.load(state) is state
    ema = ttrain.init_ema(dict(state.model.named_parameters()))
    for step in (1, 2, 3, 4):
        state.step, state.updates = step, step
        ck.save(state, ema=ema)
    assert ck.steps() == [2, 3, 4] and ck.latest_step() == 4
    w = state.model.decoder.conv_refiner["1"].out_conv.weight
    saved = w.detach().clone()
    fresh = _tiny_state()
    fresh_ema = {k: torch.zeros_like(v) for k, v in ema.items()}
    fresh = ck.load(fresh, ema=fresh_ema)
    assert fresh.step == 4 and fresh.updates == 4
    assert torch.equal(fresh.model.decoder.conv_refiner["1"].out_conv.weight, saved)
    assert all(torch.equal(fresh_ema[k], ema[k]) for k in ema)
    # the pointer decides: moved back to step 3, load reads step 3
    (tmp_path / "model" / "latest").write_text("step_000000000003.pth")
    assert ck.load(_tiny_state()).step == 3


def test_metrics_logger_every_n(tmp_path):
    log = MetricsLogger(str(tmp_path), every=2)
    for step in range(1, 6):
        log.log(step, {"loss": torch.tensor(float(step)), "note": "x"})
    log.log(5, {"loss": 5.0}, force=True)
    log.close()
    rows = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    assert [r["step"] for r in rows] == [2, 4, 5]
    assert rows[0]["loss"] == 2.0 and rows[0]["note"] == "x"


def test_train_k_steps_with_ema_and_logger(tmp_path):
    """k steps off an iterator: every batch through `device_put` and the
    step, the EMA moved after each step, the logger fed the sample count."""
    model = torch.nn.Linear(2, 1)
    opt = torch.optim.AdamW(model.parameters())
    state = ttrain.TrainState(model=model, optimizer=opt, cfg=TrainConfig(batch_size=2))
    seen = []

    def step(st, batch):
        seen.append(batch)
        with torch.no_grad():
            for p in st.model.parameters():
                p.add_(1.0)
        st.step += 2
        return st, {"loss": torch.tensor(float(st.step))}

    ema = ttrain.init_ema(dict(model.named_parameters()))
    w0 = model.weight.detach().clone()
    log = MetricsLogger(str(tmp_path), every=4)
    loader = iter(range(10))
    state, ema = ttrain.train_k_steps(state, loader, step, 3, logger=log,
                                      device_put=lambda b: b * 10, ema_params=ema,
                                      ema_decay=0.5)
    log.close()
    assert seen == [0, 10, 20] and state.step == 6
    expected = w0.clone()
    for k in (1, 2, 3):
        expected = 0.5 * expected + 0.5 * (w0 + k)
    assert torch.allclose(ema["weight"], expected)
    rows = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    assert [r["step"] for r in rows] == [4] and rows[0]["loss"] == 4.0
    assert ttrain.train_k_steps(state, iter(range(2)), step, 1) is state


def _port_grads(state_dict, batch, threads=None):
    """The port's debug float32 step from `state_dict` on `batch`: its
    gradients before the clip."""
    old = torch.get_num_threads()
    torch.set_num_threads(threads or old)
    try:
        model = RomaModel(dataclasses.replace(debug_roma_config(), dtype="float32"))
        model.load_state_dict(state_dict)
        state = ttrain.make_roma_train_state(TrainConfig(batch_size=1), model=model, device="cpu")
        _, metrics = ttrain.make_train_step(robust_loss)(state, batch)
    finally:
        torch.set_num_threads(old)
    scale = max(float(metrics["grad_norm"]), state.cfg.grad_clip) / state.cfg.grad_clip
    return {n: p.grad * scale for n, p in model.named_parameters() if p.requires_grad}


def _readings(got, ref):
    """name -> (max-abs error over max|ref|, relative L2 error)."""
    return {n: (float((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)),
                float((got[n] - r).norm() / r.norm().clamp_min(1e-30))) for n, r in ref.items()}


def _envelope(state_dict, batch, seeds=16):
    """The largest readings of the port against itself: the images moved by
    1e-7 (one run a seed), and the same batch on one thread."""
    base = _port_grads(state_dict, batch)
    env: dict = {}
    runs = []
    for seed in range(seeds):
        moved, r = dict(batch), np.random.default_rng(100 + seed)
        for k in ("im_A", "im_B"):
            moved[k] = (np.asarray(batch[k]) + 1e-7 * r.standard_normal(np.shape(batch[k]))
                        ).astype(np.float32)
        runs.append(_port_grads(state_dict, moved))
    runs.append(_port_grads(state_dict, batch, threads=1))
    for got in runs:
        for n, v in _readings(got, base).items():
            env[n] = tuple(max(a, b) for a, b in zip(env.get(n, (0.0, 0.0)), v))
    return env


def _vgg_pre_relu_crossings():
    """VGG in train mode at 32 x 40, batch 2, JAX and the port from the same
    weights: per layer, the largest difference before the ReLU and the
    count of values on opposite sides of 0."""
    import roma_torch.models.vgg as tvgg
    from roma_tpu.models import port as jport
    from roma_tpu.models.vgg import VGG19 as JVGG19

    torch.manual_seed(0)
    vgg = VGG19(dtype=torch.float32).train()
    x = np.random.default_rng(0).standard_normal((2, 32, 40, 3)).astype(np.float32)
    pre, bn_train = [], tvgg.batch_norm_train
    tvgg.batch_norm_train = lambda *a: pre.append(bn_train(*a).detach()) or pre[-1]
    try:
        with torch.no_grad():
            vgg(torch.from_numpy(x).permute(0, 3, 1, 2))
    finally:
        tvgg.batch_norm_train = bn_train
    _, st = JVGG19(dtype=jnp.float32).apply(
        jport.port_vgg19(_state(vgg), "layers."), x, True, mutable=["batch_stats"],
        capture_intermediates=True)
    out = []
    for j, t in enumerate(pre):
        r = np.asarray(st["intermediates"][f"bn_{j}"]["__call__"][0])
        t = t.permute(0, 2, 3, 1).numpy()
        out.append({"max_diff": float(np.abs(r - t).max()),
                    "crossings": int(((r > 0) != (t > 0)).sum()), "values": int(t.size)})
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from roma_torch.models.zoo import build_model

    steps = run_steps()
    jax_vs_port = _readings(*_jax_and_port_grads(steps))
    test_cfg = _envelope(steps["before"], make_batch(np.random.default_rng(5)))
    cfg = dataclasses.replace(debug_roma_config(), dtype="float32")
    chip_batch = chip_smoke.synthetic_depth_batch(
        torch.Generator().manual_seed(chip_smoke.SEED), "cpu", 1, cfg.coarse_resolution)
    chip_cfg = _envelope(build_model(cfg, chip_smoke.SEED).state_dict(),
                         {k: v.numpy() for k, v in chip_batch.items()})
    print(json.dumps({"vgg_pre_relu": _vgg_pre_relu_crossings(), "grads": {
        n: {"jax_vs_port": jax_vs_port[n], "envelope_test": test_cfg[n],
            "envelope_chip_smoke": chip_cfg[n]} for n in jax_vs_port}}, indent=1))
