"""Export and profiling of the port on the CPU, the counterparts of
tests/test_export_profiling.py: a `torch.export` round trip of a small
function, Tiny RoMa at 64x64 exported with the weights as its first input
(equal to eager after a load, on the exported weights and on weights scaled
by 1.01, bit for bit: the same operators on the same inputs), the fused
Tiny RoMa's exported graph holding the correlation-softmax kernel's
operator, and `timed` / `roofline`. Beside them, the exported Tiny RoMa's
flow against the JAX package's exported Tiny RoMa on carried weights
(float32, atol 1e-4: convolutions summed in another order)."""

import io

import numpy as np
import pytest
import torch

from roma_torch.config import TinyRomaConfig
from roma_torch.export import ExportResult, export_function, export_tiny_roma, load_exported
from roma_torch.models.zoo import build_model
from roma_torch.utils import profiling


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_export_roundtrip_simple_fn():
    fn = lambda w, x: torch.tanh(x @ w)  # noqa: E731
    w, x = torch.ones((8, 4)), torch.ones((2, 8))
    res = export_function(fn, (w, x))
    assert isinstance(res, ExportResult) and len(res.serialized) > 0
    assert res.flops == 2 * 2 * 8 * 4 and res.bytes_accessed > 0 and res.peak_memory is None
    out = load_exported(res.serialized)(w, x)
    torch.testing.assert_close(out, fn(w, x), atol=1e-6, rtol=0)
    w2 = torch.randn((8, 4), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(load_exported(res.serialized)(w2, x), fn(w2, x), atol=1e-6, rtol=0)


def _images():
    g = torch.Generator().manual_seed(0)
    return torch.rand((1, 64, 64, 3), generator=g), torch.rand((1, 64, 64, 3), generator=g)


def _eager(model, params, a, b):
    with torch.no_grad():
        c = torch.func.functional_call(model, params, (a, b))
    return c[8]["flow"], c[8]["certainty"], c[4]["flow"], c[4]["certainty"]


def test_export_tiny_roma_takes_the_weights(tmp_path):
    cfg = TinyRomaConfig()
    model = build_model(cfg, 0).eval()
    params = dict(model.state_dict())
    path = tmp_path / "tiny.pt2"
    res = export_tiny_roma(params, hw=(64, 64), cfg=cfg, path=str(path))
    assert path.read_bytes() == res.serialized and res.flops > 0
    run = load_exported(res.serialized)
    a, b = _images()
    out = run(params, a, b)
    assert out[0].shape == (1, 8, 8, 2) and out[3].shape == (1, 16, 16, 1)
    for got, ref in zip(out, _eager(model, params, a, b)):
        assert torch.equal(got, ref)
    scaled = {k: v * 1.01 if v.is_floating_point() else v for k, v in params.items()}
    for got, ref in zip(run(scaled, a, b), _eager(model, scaled, a, b)):
        assert torch.equal(got, ref)


def test_fused_kernel_exports_its_operator():
    cfg = TinyRomaConfig(fused_kernel=True)
    model = build_model(cfg, 0).eval()
    params = dict(model.state_dict())
    res = export_tiny_roma(params, hw=(64, 64), cfg=cfg)
    program = torch.export.load(io.BytesIO(res.serialized))
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.roma.corr_softmax.default) == 1
    a, b = _images()
    fused = load_exported(res.serialized)(params, a, b)
    plain = build_model(TinyRomaConfig(), 0).eval()
    for got, ref in zip(fused, _eager(plain, params, a, b)):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    assert res.flops == export_tiny_roma(params, hw=(64, 64), cfg=TinyRomaConfig()).flops


def test_exported_tiny_matches_the_jax_export():
    import jax
    import jax.numpy as jnp

    from roma_torch.models.port import tiny_state_dict_from_jax
    from roma_tpu.config import TinyRomaConfig as JaxTinyRomaConfig
    from roma_tpu.export import export_tiny_roma as j_export
    from roma_tpu.export import load_exported as j_load
    from roma_tpu.models.tiny_roma import TinyRoma as JaxTinyRoma

    kw = dict(match_dim=64, fine_match_dim=32, dtype="float32")
    x = jnp.zeros((1, 64, 64, 3))
    variables = JaxTinyRoma(JaxTinyRomaConfig(**kw)).init(jax.random.PRNGKey(0), x, x, train=False)
    a, b = _images()
    ref = j_load(j_export(variables, hw=(64, 64), cfg=JaxTinyRomaConfig(**kw)).serialized)(
        variables, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    params = tiny_state_dict_from_jax(jax.tree_util.tree_map(np.array, dict(variables)))
    cfg = TinyRomaConfig(**kw)
    got = load_exported(export_tiny_roma(params, hw=(64, 64), cfg=cfg).serialized)(params, a, b)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)


def test_timed_and_roofline(tmp_path):
    f = lambda x: x @ x  # noqa: E731
    x = torch.ones((64, 64))
    assert profiling.timed(f, x, iters=2) > 0
    r = profiling.roofline(f, x, iters=2)
    assert isinstance(r, profiling.Roofline) and r.seconds > 0
    assert r.flops == 2 * 64 ** 3 and r.bytes_accessed == 3 * 64 * 64 * 4
    assert isinstance(r.report(), str) and "TFLOP/s" in r.report()
    with profiling.trace(str(tmp_path / "trace")):
        f(x)
    assert (tmp_path / "trace" / "trace.json").exists()
