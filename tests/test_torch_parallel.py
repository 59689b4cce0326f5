"""Data parallelism of the port on torch.distributed: two CPU processes on
gloo, each fed its own half of a batch of 4 (`shard_batch`), against one
process on the whole batch, for Tiny RoMa (64x64, narrow matchers) and the
debug-size full RoMa (112^2), both float32:

- the loss and every metric within 1e-5 relative (the JAX package's
  sharded step keeps the semantics of one global batch: global BatchNorm
  statistics and global means);
- the averaged gradients before the clip under
  `roma_torch.train.grad_parity`'s rule (full RoMa's kink-sensitive
  tensors are KINK_SENSITIVE and DATA_PARALLEL_KINK_SENSITIVE; Tiny RoMa's
  here none);
- the running statistics: the variances within 1e-5 relative, the means
  within 1e-5 of their channels' standard deviation (`stat_error`);
- both ranks bit-equal to each other (parameters, statistics, metrics);
- for Tiny RoMa, every ConvBlock's ReLU input on the same side of 0 in both
  runs (`relu_sign_flips`).

"tiny_tied" is the same Tiny RoMa with flax's initialisation drawn straight
after PyTorch's default draw (`build_model` re-seeds in between). There one
ReLU input of XFeat's block5.0, a BatchNorm over 32 values a channel, lies
within float32 rounding of 0 and falls on the other side on two ranks
(ROADMAP C9), as does one of the fine matcher's first block: the loss
terms agree within LOSS_RTOL, but that pixel's
gradient passes on one side only and moves XFeat's gradients and
`grad_norm`. The test holds that the flip is within the layer's rounding
and holds everything the tie does not reach as for "tiny";
TINY_TIED_KINK_SENSITIVE names the gradients it reaches.

And a resume: each rank's own state after a step, saved and reloaded
(`CheckPoint`: AdamW's step counts on the host), then `replicate`d: every
rank holds rank 0's state, each tensor where it was, and the next step
through `mesh=` leaves the ranks bit-equal.

The workers are this file run as a script (`python
tests/test_torch_parallel.py RANK WORLD PORT MODEL OUT`), each with a time
limit; the single-process reference runs meanwhile in the test's process.
`PYTHONPATH=. python tests/test_torch_parallel.py readings` prints the
readings behind DATA_PARALLEL_KINK_SENSITIVE: two ranks against one
process, and one process against itself with the images moved by 1e-7 (16
seeds) or on one thread.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from roma_torch.config import TinyRomaConfig, TrainConfig  # noqa: E402
from roma_torch.losses.robust_loss import robust_loss, tiny_robust_loss  # noqa: E402
from roma_torch.models import layers  # noqa: E402
from roma_torch.models.layers import ConvBlock, flax_init_  # noqa: E402
from roma_torch.models.tiny_roma import TinyRoma  # noqa: E402
from roma_torch.models.zoo import build_model, debug_roma_config  # noqa: E402
from roma_torch.parallel import mesh as pmesh  # noqa: E402
from roma_torch.train import train as ttrain  # noqa: E402
from roma_torch.train.grad_parity import (  # noqa: E402
    DATA_PARALLEL_KINK_SENSITIVE, GRAD_TOL, KINK_SENSITIVE, TINY_TIED_KINK_SENSITIVE,
    grad_mismatches)

GLOBAL_BATCH = 4
LOSS_RTOL = 1e-5
STAT_RTOL = 1e-5
WORKER_TIMEOUT_S = 120
THREADS = 2


def stat_error(name: str, got, ref, ref_var) -> tuple[float, float]:
    """(error, allowed) for a running statistic: a mean within STAT_RTOL of
    its channels' largest standard deviation (a batch mean of centred data
    is a difference of large sums, so its own size is no scale), a
    variance within STAT_RTOL of its largest value."""
    got, ref, ref_var = (np.asarray(t, np.float64) for t in (got, ref, ref_var))
    scale = np.sqrt(ref_var).max() if name.endswith("mean") else np.abs(ref).max()
    return float(np.abs(got - ref).max()), STAT_RTOL * float(scale)


def depth_batch(rng, b: int, h: int, w: int, shift_px: int) -> dict:
    """The dataset contract: random images, depth 4 with a zeroed corner,
    odd samples shifted by `shift_px` (a whole coarse cell: mutual GT pairs
    for the correlation-volume loss), even ones with a small yaw."""
    f = float(w)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    Ts = []
    for i in range(b):
        T = np.eye(4, dtype=np.float32)
        if i % 2:
            T[0, 3] = -shift_px * 4.0 / f
        else:
            a = 0.03
            T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        Ts.append(T)
    depth = np.full((b, h, w), 4.0, np.float32)
    depth[:, : h // 8, : w // 4] = 0.0
    return {
        "im_A": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "im_B": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "im_A_depth": depth, "im_B_depth": depth.copy(),
        "T_1to2": np.stack(Ts), "K1": np.tile(K, (b, 1, 1)), "K2": np.tile(K, (b, 1, 1)),
    }


def build(model_name: str):
    """(state, loss_fn, global batch): the same on every process."""
    cfg = TrainConfig(batch_size=GLOBAL_BATCH)
    if model_name.startswith("tiny"):
        tiny_cfg = TinyRomaConfig(match_dim=32, fine_match_dim=16, dtype="float32")
        if model_name == "tiny":
            model = build_model(tiny_cfg, 0)
        else:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = flax_init_(TinyRoma(tiny_cfg))
        state = ttrain.make_tiny_train_state(cfg, model=model, device="cpu")
        batch = depth_batch(np.random.default_rng(1), GLOBAL_BATCH, 64, 64, 8)
        return state, tiny_robust_loss, batch
    import dataclasses

    model = build_model(dataclasses.replace(debug_roma_config(), dtype="float32"), 0)
    state = ttrain.make_roma_train_state(cfg, model=model, device="cpu")
    batch = depth_batch(np.random.default_rng(2), GLOBAL_BATCH, 112, 112, 16)
    return state, robust_loss, batch


class ReluInputs:
    """Within, every Tiny RoMa ConvBlock's training BatchNorm output (its
    ReLU input) is kept in `self.values`, in call order, with the block's
    name."""

    def __init__(self, model):
        self.model, self.values, self.name = model, [], None

    def __enter__(self):
        self.hooks = [m.register_forward_pre_hook(lambda m, _, n=n: setattr(self, "name", n))
                      for n, m in self.model.named_modules() if isinstance(m, ConvBlock)]
        self.orig = layers.batch_norm_train

        def keep(*args):
            y = self.orig(*args)
            self.values.append((self.name, y.detach().clone()))
            return y

        layers.batch_norm_train = keep
        return self

    def __exit__(self, *exc):
        layers.batch_norm_train = self.orig
        for h in self.hooks:
            h.remove()


def relu_sign_flips(ranks: list[dict], ref: dict) -> dict[str, tuple[int, float, float]]:
    """ConvBlock name -> (ReLU inputs on the other side of 0 in the ranks'
    run than in the one-process run, the largest |value| among them, the
    largest difference of the block's values between the runs), for every
    block with a flip. XFeat runs on [A; B]: a rank's rows are its own A
    rows then its B rows."""
    out = {}
    for i, (name, y) in enumerate(ref["relu_inputs"]):
        parts = [r["relu_inputs"][i][1] for r in ranks]
        if name.startswith("xfeat"):
            h = [len(p) // 2 for p in parts]
            got = torch.cat([p[:k] for p, k in zip(parts, h)] + [p[k:] for p, k in zip(parts, h)])
        else:
            got = torch.cat(parts)
        flips = (got > 0) != (y > 0)
        if flips.any():
            out[name] = (int(flips.sum()), float(torch.minimum(got.abs(), y.abs())[flips].max()),
                         float((got - y).abs().max()))
    return out


def run(model_name: str, mesh=None, images_moved_seed=None) -> dict:
    """One step; the gradients before the clip (the clip's scale undone),
    the statistics, parameters after the step and the metrics (Tiny RoMa:
    and its ConvBlocks' ReLU inputs)."""
    state, loss_fn, batch = build(model_name)
    if images_moved_seed is not None:
        r = np.random.default_rng(100 + images_moved_seed)
        for k in ("im_A", "im_B"):
            batch[k] = (batch[k] + 1e-7 * r.standard_normal(batch[k].shape)).astype(np.float32)
    state = pmesh.replicate(state, mesh)
    local = batch if mesh is None else pmesh.shard_batch(batch, mesh)
    with ReluInputs(state.model) as relu_inputs:
        state, metrics = ttrain.make_train_step(loss_fn, mesh=mesh)(state, local)
    clip = state.cfg.grad_clip
    scale = max(float(metrics["grad_norm"]), clip) / clip
    model = state.model
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad * scale for n, p in model.named_parameters() if p.grad is not None},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "step": state.step, "relu_inputs": relu_inputs.values}


NAMED = {"tiny": {}, "tiny_tied": TINY_TIED_KINK_SENSITIVE,
         "roma": {**KINK_SENSITIVE, **DATA_PARALLEL_KINK_SENSITIVE}}
# "tiny_tied": the blocks with a tied ReLU input, and the metrics they reach
TIED_BLOCKS = {"xfeat.0.block5.0", "fine_matcher.0"}
TIED_METRICS = {"grad_norm"}


def _optimizer_tensors(state) -> dict:
    return {f"{i}.{k}": t.clone() for i, s in state.optimizer.state_dict()["state"].items()
            for k, t in s.items()}


def resume(mesh, ckpt_dir) -> dict:
    """Each rank: a narrow Tiny RoMa state of its own seed takes one step on
    its own rows (no mesh), is saved and reloaded into a fresh state, and
    is `replicate`d over `mesh`; then one step through `mesh=`. The model's
    and the optimizer's tensors before and after the replicate, and after
    the step."""
    from roma_torch.train.checkpoint import CheckPoint

    rank = mesh.get_local_rank()
    cfg = TrainConfig(batch_size=GLOBAL_BATCH)

    def fresh(seed):
        model = build_model(TinyRomaConfig(match_dim=32, fine_match_dim=16, dtype="float32"), seed)
        return ttrain.make_tiny_train_state(cfg, model=model, device="cpu")

    batch = depth_batch(np.random.default_rng(1), GLOBAL_BATCH, 64, 64, 8)
    state, _ = ttrain.make_train_step()(fresh(rank), pmesh.shard_batch(batch, mesh))
    ckpt = CheckPoint(ckpt_dir, f"rank{rank}")
    ckpt.save(state)
    state = ckpt.load(fresh(10 + rank))
    out = {"before": {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
                      "optimizer": _optimizer_tensors(state), "step": state.step}}
    state = pmesh.replicate(state, mesh)
    out["after"] = {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
                    "optimizer": _optimizer_tensors(state), "step": state.step}
    state, metrics = ttrain.make_train_step(mesh=mesh)(state, pmesh.shard_batch(batch, mesh))
    out["stepped"] = {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
                      "metrics": {k: float(v) for k, v in metrics.items()}, "step": state.step}
    return out


def two_ranks(model_name: str, tmp_path) -> list[dict]:
    """`run` (`resume` for "resume") on two gloo ranks, each a process of
    its own, each its half of the batch; their results."""
    port = str(_free_port())
    outs = [tmp_path / f"{model_name}_rank{r}.pt" for r in range(2)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", port, model_name,
                               str(outs[r])], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, out.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(o, weights_only=True) for o in outs]


def one_process(model_name: str, images_moved_seed=None, threads=THREADS) -> dict:
    """`run` in this process on `threads` threads, the images moved by 1e-7
    with a seed when one is given."""
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return run(model_name, images_moved_seed=images_moved_seed)
    finally:
        torch.set_num_threads(old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("model_name", ["tiny", "tiny_tied", "roma"])
def test_two_gloo_ranks_match_one_process(tmp_path, model_name):
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(two_ranks, model_name, tmp_path)
        ref = one_process(model_name)
        ranks = workers.result()

    # both ranks bit-equal
    r0, r1 = ranks
    assert r0["metrics"] == r1["metrics"] and r0["step"] == r1["step"] == GLOBAL_BATCH
    assert all(torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    assert all(torch.equal(r0["grads"][k], r1["grads"][k]) for k in r0["grads"])

    # against one process on the whole batch
    assert set(r0["metrics"]) == set(ref["metrics"])
    tied = set()
    if model_name.startswith("tiny"):
        assert ref["metrics"]["corr_volume_loss_8"] > 0
        flips = relu_sign_flips(ranks, ref)
        if model_name == "tiny_tied":
            # one ReLU input a tied block within its rounding of 0, nowhere else
            assert set(flips) == TIED_BLOCKS, flips
            assert all(n == 1 and margin <= rounding for n, margin, rounding in flips.values())
            tied = TIED_METRICS
        else:
            assert not flips, flips
    for k, v in ref["metrics"].items():
        if k in tied:
            continue
        assert abs(r0["metrics"][k] - v) <= LOSS_RTOL * abs(v), (k, r0["metrics"][k], v)
    state, _, _ = build(model_name)
    bad, worst = grad_mismatches(state.model, r0["grads"], ref["grads"], NAMED[model_name])
    assert not bad, bad[:10]
    # the tied draw names 19 of its tensors; the rest stay held to GRAD_TOL
    assert worst["n_tol"] > (10 if model_name == "tiny_tied" else 20)
    stats = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        var = ref["state"][k.rsplit(".", 1)[0] + ".running_var"]
        err, allowed = stat_error(k, r0["state"][k], ref["state"][k], var)
        assert err <= allowed, (k, err, allowed)


def test_replicate_after_a_step_and_a_reload(tmp_path):
    r0, r1 = two_ranks("resume", tmp_path)
    before = r0["before"]
    assert before["step"] == GLOBAL_BATCH // 2
    steps = [k for k in before["optimizer"] if k.endswith(".step")]
    assert steps and all(before["optimizer"][k].device.type == "cpu" for k in steps)
    # the ranks started apart, and the replicate gives each rank 0's state
    assert not all(torch.equal(before["model"][k], r1["before"]["model"][k])
                   for k in before["model"])
    for r in (r0, r1):
        after = r["after"]
        assert after["step"] == before["step"]
        for part in ("model", "optimizer"):
            assert after[part].keys() == before[part].keys()
            for k, t in before[part].items():
                assert after[part][k].device == t.device and after[part][k].dtype == t.dtype, k
                assert torch.equal(after[part][k], t), k
    # and the next step through mesh= keeps the ranks bit-equal
    a, b = r0["stepped"], r1["stepped"]
    assert a["step"] == b["step"] == before["step"] + GLOBAL_BATCH
    assert a["metrics"] == b["metrics"] and all(np.isfinite(list(a["metrics"].values())))
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])


def test_single_process_helpers(monkeypatch):
    """With no RANK / WORLD_SIZE / MASTER_ADDR, initialize_distributed is a
    no-op returning (0, 1), there is no mesh, and a host-local batch is the
    batch (the step moves it to the model's device)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.initialize_distributed() == (0, 1)
    assert pmesh.make_mesh() is None
    batch = depth_batch(np.random.default_rng(0), 2, 8, 8, 0)
    got = pmesh.global_batch_from_host_local(batch, None)
    assert all(torch.equal(got[k], torch.from_numpy(v)) for k, v in batch.items())
    assert pmesh.replicate("state", None) == "state"
    with pmesh.data_parallel("g"):
        assert pmesh.active_group() == "g"
    assert pmesh.active_group() is None


def _readings(got, ref):
    """name -> (max-abs error over max|ref|, relative L2 error)."""
    return {n: (float((g - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)),
                float((g - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)))
            for n, g in got.items()}


def print_readings():
    """Per configuration, every gradient outside KINK_SENSITIVE and the
    exact zeros (biases before a training BatchNorm) that two ranks against
    one process or one process against itself (the images moved by 1e-7,
    16 seeds, or on one thread) moves by more than GRAD_TOL * max|g|."""
    from roma_torch.train.grad_parity import feeds_batch_norm

    import json
    import tempfile

    out = {}
    for model_name in ("tiny", "tiny_tied", "roma"):
        base = one_process(model_name)["grads"]
        with tempfile.TemporaryDirectory() as d:
            dp = _readings(two_ranks(model_name, __import__("pathlib").Path(d))[0]["grads"], base)
        env: dict = {}
        runs = [one_process(model_name, seed) for seed in range(16)]
        runs.append(one_process(model_name, threads=1))
        for r in runs:
            for n, v in _readings(r["grads"], base).items():
                env[n] = tuple(max(a, b) for a, b in zip(env.get(n, (0.0, 0.0)), v))
        model = build(model_name)[0].model
        out[model_name] = {n: {"two_ranks": dp[n], "envelope": env[n]} for n in base
                           if max(dp[n][0], env[n][0]) > GRAD_TOL
                           and (model_name != "roma" or n not in KINK_SENSITIVE)
                           and not feeds_batch_norm(model, n)}
    print(json.dumps(out, indent=1))


if __name__ == "__main__" and sys.argv[1:] == ["readings"]:
    print_readings()
elif __name__ == "__main__":
    rank, world, port, model_name, out = sys.argv[1:]
    torch.set_num_threads(THREADS)
    os.environ.update(RANK=rank, WORLD_SIZE=world, MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    assert pmesh.initialize_distributed("cpu") == (int(rank), int(world))
    try:
        mesh = pmesh.make_mesh("cpu")
        result = (resume(mesh, os.path.dirname(out)) if model_name == "resume"
                  else run(model_name, mesh))
        torch.save(result, out)
    finally:
        torch.distributed.destroy_process_group()
