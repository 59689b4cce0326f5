"""Tiny RoMa training in the port against the JAX package on the CPU, float32.

One training step on each side: the JAX package's `make_tiny_train_state`
+ `make_train_step()` (its default loss, `tiny_robust_loss`) on a narrow
`TinyRomaConfig` (matchers 32/16) at 64x64, batch 2, its initial variables
carried into the port with `tiny_state_dict_from_jax`, then the port's
`make_tiny_train_state` + `make_train_step()` on the same batch. The JAX
step's gradients before the clip are kept by a transform chained in front
of its optimizer (as in tests/test_torch_train.py).

Tolerances (float32 on both sides, sums in another order):
- the loss, `grad_norm` and every loss term, `corr_volume_loss_8` among
  them: rel 1e-4;
- the gradients before the clip under `roma_torch.train.grad_parity`;
- the running statistics after the step: the variances 1e-5 relative,
  the means 1e-5 of their channels' standard deviation (`stat_error`);
- the parameters after the step: 2.5 * lr (Adam's first step moves a
  parameter by about lr * sign(g), and a tiny gradient's sign is noise).

Beside it: the train-mode forward's C5 repairs (the fine stage stops the
coarse gradient; train mode always takes the volume and the exact
expectation, whatever a gradient needs), the train-mode ConvBlock and XFeat
trunk against the JAX modules with `train=True`, and the training tests of
tests/test_train.py for each `trainable`: the loss, a step, EMA and the
warm-up schedule against the JAX package's `make_optimizer`, and staged
freezing.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from roma_tpu.config import TinyRomaConfig as JConfig
from roma_tpu.config import TrainConfig as JTrainConfig
from roma_tpu.losses.robust_loss import tiny_robust_loss as j_tiny_robust_loss
from roma_tpu.models import port as jport
from roma_tpu.models.layers import ConvBlock as JConvBlock
from roma_tpu.models.tiny_roma import TinyRoma as JTinyRoma
from roma_tpu.models.xfeat import XFeatBackbone as JXFeat
from roma_tpu.train import train as jtrain
from roma_torch.config import TinyRomaConfig, TrainConfig
from roma_torch.losses.robust_loss import tiny_robust_loss
from roma_torch.models.layers import ConvBlock
from roma_torch.models.port import tiny_state_dict_from_jax
from roma_torch.models.tiny_roma import TinyRoma
from roma_torch.models.xfeat import XFeatBackbone
from roma_torch.ops.corr import pos_embed_expectation
from roma_torch.train import train as ttrain
from roma_torch.train.grad_parity import TINY_KINK_SENSITIVE, grad_mismatches
from test_torch_parallel import depth_batch, stat_error

NARROW = dict(match_dim=32, fine_match_dim=16, dtype="float32")
HW = (64, 64)
LOSS_RTOL = 1e-4
PARAM_TOL = 2.5      # times the learning rate
TRAINABLE = ["all", "fine_only", "matchers_only"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _capture_grads():
    """A transform that passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _batch(b=2):
    return depth_batch(np.random.default_rng(3), b, *HW, 8)


def _jax_state(trainable="all", capture=False, cfg=JTrainConfig(batch_size=2)):
    st = jtrain.make_tiny_train_state(jax.random.PRNGKey(0), cfg, hw=HW,
                                      model=JTinyRoma(JConfig(**NARROW)), trainable=trainable)
    if capture:
        tx = optax.chain(_capture_grads(), st.tx)
        st = st.replace(tx=tx, opt_state=tx.init(st.params))
    return st


def _port_model(variables) -> TinyRoma:
    model = TinyRoma(TinyRomaConfig(**NARROW))
    model.load_state_dict(tiny_state_dict_from_jax(variables), strict=True)
    return model


def _sd(variables):
    return tiny_state_dict_from_jax(_np(variables))


def run_steps():
    """One step on each side from the same weights and batch."""
    jstate = _jax_state(capture=True)
    variables = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}
    model = _port_model(variables)
    cfg = TrainConfig(batch_size=2)
    tstate = ttrain.make_tiny_train_state(cfg, model=model, device="cpu")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = _batch()
    jnew, jmetrics = jtrain.make_train_step()(jstate, batch)
    tnew, tmetrics = ttrain.make_train_step()(tstate, batch)
    return dict(
        before=before, model=model, cfg=cfg, tstate=tnew,
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        tmetrics={k: float(v) for k, v in tmetrics.items()},
        jgrads=_sd({"params": jnew.opt_state[0], "batch_stats": variables["batch_stats"]}),
        jafter=_sd({"params": jnew.params, "batch_stats": jnew.batch_stats}))


@pytest.fixture(scope="module")
def steps():
    return run_steps()


def _port_grads(steps):
    """The port's gradients before the clip (the clip's scale undone)."""
    model, cfg = steps["model"], steps["cfg"]
    scale = max(steps["tmetrics"]["grad_norm"], cfg.grad_clip) / cfg.grad_clip
    return {n: p.grad * scale for n, p in model.named_parameters()}


def test_loss_and_metrics_match_jax(steps):
    jm, tm = steps["jmetrics"], steps["tmetrics"]
    assert set(jm) == set(tm) and "corr_volume_loss_8" in tm and "regression_loss_4" in tm
    assert tm["corr_volume_loss_8"] > 0
    for k, v in jm.items():
        assert np.isfinite(tm[k])
        assert abs(tm[k] - v) <= LOSS_RTOL * abs(v) + 1e-12, f"{k}: {tm[k]} vs JAX {v}"


def test_gradients_before_the_clip_match_jax(steps):
    got = _port_grads(steps)
    ref = {n: steps["jgrads"][n] for n in got}
    bad, worst = grad_mismatches(steps["model"], got, ref, TINY_KINK_SENSITIVE)
    assert not bad, f"{len(bad)} gradients off: {bad[:10]}"
    assert len(got) == 34 and worst["n_kink"] == len(TINY_KINK_SENSITIVE) == 4
    assert worst["n_tol"] == 30


def test_statistics_and_parameters_after_the_step(steps):
    cfg = steps["cfg"]
    lr = cfg.lr_decoder * cfg.batch_size
    moved = 0
    for name, t in steps["model"].state_dict().items():
        ref = steps["jafter"][name]
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            var = steps["jafter"][name.rsplit(".", 1)[0] + ".running_var"]
            err, allowed = stat_error(name, t, ref, var)
            assert err <= allowed, (name, err, allowed)
            moved += int(not torch.equal(t, steps["before"][name]))
        else:
            assert (t - ref).abs().max().item() <= PARAM_TOL * lr, name
    assert moved == 2 * 26  # every ConvBlock's mean and variance
    assert steps["tstate"].step == 2 and steps["tstate"].updates == 1


def test_default_loss_is_tiny_robust_loss():
    """C6: `make_train_step()` with no loss runs `tiny_robust_loss`, as the
    JAX package's does."""
    def default(fn):
        return inspect.signature(fn).parameters["loss_fn"].default

    assert default(ttrain.make_train_step) is tiny_robust_loss
    assert default(jtrain.make_train_step) is j_tiny_robust_loss


def _loss_at(corresps, scale):
    return corresps[scale]["flow"].sum() + corresps[scale]["certainty"].sum()


def test_fine_stage_stops_the_coarse_gradient():
    """C5 (a): a loss on scale 4 alone reaches neither the coarse matcher
    nor the trunk's coarse blocks (block3-5, fusion), in the port as in the
    JAX package; block1 and block2 (the fine features) still get one."""
    jstate = _jax_state()
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    batch = _batch()

    def jloss4(params):
        out, _ = jstate.apply_fn({"params": params, "batch_stats": variables["batch_stats"]},
                                 batch["im_A"], batch["im_B"], train=True,
                                 mutable=["batch_stats"])
        return _loss_at(out, 4)

    jgrads = _sd({"params": jax.grad(jloss4)(jstate.params),
                  "batch_stats": variables["batch_stats"]})
    model = _port_model(_np(variables)).train()
    _loss_at(model(torch.from_numpy(batch["im_A"]), torch.from_numpy(batch["im_B"])),
             4).backward()
    cut = ("coarse_matcher.", "xfeat.0.block3.", "xfeat.0.block4.", "xfeat.0.block5.",
           "xfeat.0.block_fusion.")
    n_cut = 0
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if name.startswith(cut):
            assert not g.any() and not jgrads[name].any(), name
            n_cut += 1
        else:
            assert g.abs().max() > 0 and jgrads[name].abs().max() > 0, name
    assert n_cut == 20


@pytest.mark.parametrize("how", ["fine_only", "no_grad"])
def test_train_mode_takes_the_volume_and_exact_expectation(monkeypatch, how):
    """C5 (c, d): in train mode scale 8 returns the correlation volume and
    the coarse warp is its exact expectation (never the streaming kernel or
    the strided shortcut, both configured here), whether or not autograd
    records (a frozen trunk, or no grad at all); the same forward as the
    JAX package's `train=True`. Eval mode returns no volume."""
    import roma_torch.models.tiny_roma as ttiny

    calls = []

    def refuse(name):
        def fn(*args, **kw):
            raise AssertionError(f"{name} in train mode")
        return fn

    monkeypatch.setattr(ttiny, "fused_pos_embed", refuse("the streaming kernel"))
    monkeypatch.setattr(ttiny, "pos_embed_fast", refuse("the strided shortcut"))
    monkeypatch.setattr(ttiny, "pos_embed_expectation",
                        lambda cv, hw: calls.append(cv) or pos_embed_expectation(cv, hw))
    kw = dict(NARROW, fused_kernel=True, exact_softmax=False)
    jstate = _jax_state()
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    batch = _batch()
    ref, _ = JTinyRoma(JConfig(**kw)).apply(variables, batch["im_A"], batch["im_B"], train=True,
                                           mutable=["batch_stats"])
    model = TinyRoma(TinyRomaConfig(**kw))
    model.load_state_dict(_sd(variables))
    a, b = torch.from_numpy(batch["im_A"]), torch.from_numpy(batch["im_B"])
    if how == "fine_only":
        model = ttrain.make_tiny_train_state(TrainConfig(batch_size=2), model=model,
                                             trainable="fine_only", device="cpu").model
        out = model(a, b)
    else:
        with torch.no_grad():
            out = model.train()(a, b)
    cv = out[8]["corr_volume"]
    assert tuple(cv.shape) == (2, 64, 64) and len(calls) == 1 and calls[0] is cv
    # train-mode BatchNorm over 4 images: block5's statistics come from 16
    # values a channel, which magnify float32 differences
    tol = dict(atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(cv.detach().numpy(), np.asarray(ref[8]["corr_volume"]), **tol)
    for s in (8, 4):
        for k in ("flow", "certainty"):
            np.testing.assert_allclose(out[s][k].detach().numpy(), np.asarray(ref[s][k]), **tol)
    monkeypatch.undo()
    with torch.no_grad():
        assert "corr_volume" not in model.eval()(a, b)[8]


@pytest.mark.parametrize("mode", ["band", "row"])
def test_restricted_search_returns_no_volume(mode):
    """The band and row search modes build no volume: None, as in JAX."""
    model = TinyRoma(TinyRomaConfig(**NARROW, search_mode=mode, band_radius=1)).train()
    batch = _batch()
    with torch.no_grad():
        out = model(torch.from_numpy(batch["im_A"]), torch.from_numpy(batch["im_B"]))
    assert out[8]["corr_volume"] is None


@pytest.mark.parametrize("cin,cout,k,s", [(5, 7, 3, 2), (6, 4, 1, 1)])
def test_conv_block_train_mode_matches_jax(rng, cin, cout, k, s):
    """Train-mode ConvBlock: batch statistics (biased variance tracked,
    momentum 0.9) against the JAX `ConvBlock(train=True)`: output 1e-5,
    input gradient 1e-5 of its largest value, statistics 1e-6."""
    torch.manual_seed(0)
    blk = ConvBlock(cin, cout, k, s, dtype=torch.float32).train()
    sd = {k_: v.numpy().copy() for k_, v in blk.state_dict().items()}
    params, stats = {}, {}
    jport.port_conv_block(sd, "layer.0", "layer.1", params, stats, ("b",))
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    cot = rng.standard_normal((2, (9 - 1) // s + 1, (11 - 1) // s + 1, cout)).astype(np.float32)
    jmod = JConvBlock(cout, kernel_size=k, stride=s, dtype=jnp.float32)

    def f(x):
        y, upd = jmod.apply({"params": params["b"], "batch_stats": stats["b"]}, x, True,
                            mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd)

    jgx, (jy, upd) = jax.grad(f, has_aux=True)(x)
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).requires_grad_(True)
    y = blk(xt)
    (y * torch.from_numpy(np.moveaxis(cot, -1, 1).copy())).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), jy, atol=1e-5)
    gx = np.moveaxis(xt.grad.numpy(), 1, -1)
    assert np.abs(gx - np.asarray(jgx)).max() <= 1e-5 * np.abs(jgx).max()
    js = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(blk.layer[1].running_mean.numpy(), js["mean"], atol=1e-6)
    np.testing.assert_allclose(blk.layer[1].running_var.numpy(), js["var"], atol=1e-6)


def test_xfeat_train_mode_matches_jax(rng):
    """The trunk in train mode (both images of a pair in one batch): fine
    and coarse features 1e-4, every moved statistic by `stat_error`."""
    torch.manual_seed(0)
    net = XFeatBackbone(dtype=torch.float32).train()
    v = jport.port_tiny_roma({k: t.numpy().copy() for k, t in net.state_dict().items()})
    x = rng.uniform(0, 1, (4, 32, 64, 3)).astype(np.float32)
    (rfine, rcoarse), upd = JXFeat(dtype=jnp.float32).apply(
        {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]}, x,
        True, mutable=["batch_stats"])
    fine, coarse = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(fine.permute(0, 2, 3, 1).detach().numpy(), rfine, atol=1e-4)
    np.testing.assert_allclose(coarse.permute(0, 2, 3, 1).detach().numpy(), rcoarse, atol=1e-4)
    got = jport.port_tiny_roma({k: t.numpy() for k, t in net.state_dict().items()})
    got = got["batch_stats"]["backbone"]
    n = 0
    for block, stats in upd["batch_stats"].items():
        for key in ("mean", "var"):
            r, var = stats["BatchNorm_0"][key], stats["BatchNorm_0"]["var"]
            err, allowed = stat_error(key, got[block]["BatchNorm_0"][key], r, var)
            assert err <= allowed, (block, key, err, allowed)
            n += 1
    assert n == 2 * 18


# --------------------------------------------- tests/test_train.py, ported

def _port_state(trainable, cfg=TrainConfig(batch_size=2, steps=1000)):
    return ttrain.make_tiny_train_state(cfg, model=TinyRoma(TinyRomaConfig(**NARROW)),
                                        trainable=trainable, device="cpu")


@pytest.mark.parametrize("trainable", TRAINABLE)
def test_tiny_loss_finite_and_metrics(trainable):
    state = _port_state(trainable)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, metrics = tiny_robust_loss(state.model(batch["im_A"], batch["im_B"]), batch)
    assert torch.isfinite(loss)
    assert {"regression_loss_8", "corr_volume_loss_8", "certainty_loss_4"} <= set(metrics)


@pytest.mark.parametrize("trainable", TRAINABLE)
def test_train_step_updates_params(trainable):
    state = _port_state(trainable)
    w = state.model.fine_matcher[0].layer[0].weight
    w0 = w.detach().clone()
    state, metrics = ttrain.make_train_step()(state, _batch())
    assert state.step == 2 and state.updates == 1
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not torch.allclose(w0, w)


@pytest.mark.parametrize("trainable", TRAINABLE)
def test_ema_and_warmup_schedule_match_jax(trainable):
    """The warm-up schedule: twelve updates of one tensor through the JAX
    package's `make_optimizer` (clip, AdamW, warm-up over 40 samples at
    batch 4) and the port's (`clip_by_global_norm`, `make_optimizer`, the
    state's schedule); the per-update factors ramp over the first ten.
    The state's optimizer holds exactly the trainable parameters. Then one
    EMA step against the JAX package's."""
    cfg = TrainConfig(batch_size=4, steps=1000, warmup_samples=40, milestone_frac=0.9)
    jcfg = JTrainConfig(batch_size=4, steps=1000, warmup_samples=40, milestone_frac=0.9)
    state = _port_state(trainable, cfg)
    frozen = ttrain.FROZEN_ROOTS[trainable]
    expect = [p for n, p in state.model.named_parameters() if n.split(".")[0] not in frozen]
    assert [id(p) for p in state.trainable()] == [id(p) for p in expect]
    assert state.schedule is ttrain.warmup_lr_multiplier
    factors = [state.schedule(cfg, u) for u in range(12)]
    np.testing.assert_allclose(factors, [0.1 * min(u + 1, 10) for u in range(12)], rtol=1e-12)

    tx = jtrain.make_optimizer(jcfg, lr=1e-2)
    p = jnp.ones(3)
    st = tx.init(p)
    tp = torch.nn.Parameter(torch.ones(3))
    opt = ttrain.make_optimizer(cfg, 1e-2, [tp])
    g = np.full(3, 1e-3, np.float32)
    for u in range(12):
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        tp.grad = torch.from_numpy(g.copy())
        ttrain.clip_by_global_norm([tp.grad], cfg.grad_clip)
        opt.param_groups[0]["lr"] = opt.param_groups[0]["base_lr"] * state.schedule(cfg, u)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), rtol=0, atol=1e-6)

    params = {n: p.detach() for n, p in state.model.named_parameters()}
    ema = ttrain.init_ema(params)
    moved = {n: t + 1.0 for n, t in params.items()}
    ref = jtrain.ema_update({n: t.numpy() for n, t in ema.items()},
                            {n: t.numpy() for n, t in moved.items()}, decay=0.9)
    ttrain.ema_update(ema, moved, decay=0.9)
    assert all(np.allclose(ema[n].numpy(), np.asarray(ref[n]), atol=1e-6) for n in ema)


@pytest.mark.parametrize("trainable", TRAINABLE)
def test_staged_training_freezes_roots(monkeypatch, trainable):
    """Frozen roots bit-unchanged (no update, no weight decay) with their
    BatchNorm statistics still moving; the fine matcher moves; the clip's
    norm covers the trainable gradients only and the `grad_norm` metric
    every parameter's (the JAX package's `optax.global_norm(grads)`)."""
    clipped = []

    def spy(grads, max_norm):
        clipped.append((len(grads), ttrain.global_norm(grads)))
        return clip(grads, max_norm)

    clip = ttrain.clip_by_global_norm
    monkeypatch.setattr(ttrain, "clip_by_global_norm", spy)
    state = _port_state(trainable)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = ttrain.make_train_step()(state, _batch())
    after = state.model.state_dict()
    frozen = ttrain.FROZEN_ROOTS[trainable]

    def delta(root, stats=False):
        keys = [k for k in before if k.split(".")[0] == root
                and k.endswith(("running_mean", "running_var")) == stats
                and not k.endswith("num_batches_tracked")]
        return max((after[k] - before[k]).abs().max().item() for k in keys)

    for root in ("xfeat", "coarse_matcher", "fine_matcher"):
        assert (delta(root) == 0.0) == (root in frozen), root
        assert delta(root, stats=True) > 0.0, root
    frozen_grads = [p.grad for n, p in state.model.named_parameters()
                    if n.split(".")[0] in frozen]
    (n_clipped, clip_norm), = clipped
    assert n_clipped == len(state.trainable()) == 34 - len(frozen_grads)
    frozen_norm = float(ttrain.global_norm(frozen_grads)) if frozen_grads else 0.0
    assert (frozen_norm > 0) == bool(frozen)
    assert float(metrics["grad_norm"]) == pytest.approx(
        (float(clip_norm) ** 2 + frozen_norm ** 2) ** 0.5, rel=1e-6)


def test_unknown_trainable_raises():
    with pytest.raises(ValueError, match="trainable"):
        ttrain.make_tiny_train_state(TrainConfig(), model=TinyRoma(TinyRomaConfig(**NARROW)),
                                     trainable="decoder_only", device="cpu")


def _readings(got, ref):
    """name -> (max-abs error over max|ref|, relative L2 error)."""
    return {n: (float((g - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)),
                float((g - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)))
            for n, g in got.items()}


def _envelope(variables, batch, seeds=16):
    """The largest readings of the port against itself: the images moved by
    1e-7 (one run a seed), and the same batch on one thread."""
    def grads(batch, threads=None):
        old = torch.get_num_threads()
        torch.set_num_threads(threads or old)
        try:
            state = ttrain.make_tiny_train_state(TrainConfig(batch_size=2),
                                                 model=_port_model(variables), device="cpu")
            state, m = ttrain.make_train_step()(state, batch)
        finally:
            torch.set_num_threads(old)
        return _port_grads(dict(model=state.model, cfg=state.cfg,
                                tmetrics={"grad_norm": float(m["grad_norm"])}))

    base = grads(batch)
    runs = []
    for seed in range(seeds):
        moved, r = dict(batch), np.random.default_rng(100 + seed)
        for k in ("im_A", "im_B"):
            moved[k] = (batch[k] + 1e-7 * r.standard_normal(batch[k].shape)).astype(np.float32)
        runs.append(grads(moved))
    runs.append(grads(batch, threads=1))
    env: dict = {}
    for got in runs:
        for n, v in _readings(got, base).items():
            env[n] = tuple(max(a, b) for a, b in zip(env.get(n, (0.0, 0.0)), v))
    return env


if __name__ == "__main__":
    import json

    jax.config.update("jax_platforms", "cpu")
    steps = run_steps()
    jax_vs_port = _readings(_port_grads(steps), steps["jgrads"])
    jstate = _jax_state()
    env = _envelope({"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)},
                    _batch())
    print(json.dumps({n: {"jax_vs_port": jax_vs_port[n], "envelope": env[n]}
                      for n in jax_vs_port}, indent=1))
