"""Model export, the counterpart of the JAX package's ``export.py``: a
forward serialised at fixed shapes by `torch.export` (the role of its
StableHLO artifact, and of the reference fork's ONNX export), with the work
of one run counted by the dispatcher (the role of XLA's cost analysis, and
of the fork's thop audit). The hand-written kernels are ``roma::``
operators (`roma_torch.kernels`), so an exported program holds a kernel as
one node and launches it when run on the card. As in the JAX package, the
exported call takes the weights as its first argument, so that one artifact
serves any checkpoint.
"""

from __future__ import annotations

import dataclasses
import io

import torch
from torch.utils._pytree import tree_leaves

from roma_torch.utils import profiling


@dataclasses.dataclass
class ExportResult:
    serialized: bytes            # torch.export.save of the exported program
    flops: float | None          # FlopCounterMode over one run of it
    bytes_accessed: float | None  # profiling.BytesCounter over the same run
    peak_memory: float | None    # bytes of CUDA memory above the run's start; None on the CPU


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_function(fn, example_args, path: str | None = None) -> ExportResult:
    """Export ``fn(*example_args)`` (`torch.export.export` of a module
    around it, under no_grad), serialise it (`torch.export.save`), run the
    exported program once on the example arguments under the FLOP and byte
    counters, with its peak device memory where they are on the card, and
    write the bytes to `path` if one is given."""
    args = tuple(example_args)
    with torch.no_grad():
        exported = torch.export.export(_Call(fn), args)
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        blob = buf.getvalue()
        run = exported.module()
        peak = None
        cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(args))
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        flops, nbytes = profiling.count(run, *args)
        if cuda:
            torch.cuda.synchronize()
            peak = float(torch.cuda.max_memory_allocated() - base)
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return ExportResult(blob, flops, nbytes, peak)


def export_tiny_roma(params, hw: tuple[int, int] = (320, 640), cfg=None,
                     path: str | None = None) -> ExportResult:
    """Export the Tiny RoMa forward at (1, H, W, 3): ``(state_dict, im_a,
    im_b) -> (flow8, cert8, flow4, cert4)`` through
    `torch.func.functional_call`, on the device of `params` (a TinyRoma
    state_dict: parameters and buffers). The program takes the weights as a
    plain dict of the same names (``dict(model.state_dict())``)."""
    from roma_torch.config import TinyRomaConfig
    from roma_torch.models.tiny_roma import TinyRoma

    cfg = cfg or TinyRomaConfig()
    dev = next(iter(params.values())).device
    model = TinyRoma(cfg).to(dev).eval()

    def fwd(p, a, b):
        c = torch.func.functional_call(model, p, (a, b))
        return c[8]["flow"], c[8]["certainty"], c[4]["flow"], c[4]["certainty"]

    # two tensors: torch.export would tie the images of one tensor passed twice
    a, b = (torch.zeros((1, *hw, 3), device=dev) for _ in range(2))
    return export_function(fwd, (dict(params), a, b), path=path)


def load_exported(blob: bytes):
    """The exported program from `blob` (`torch.export.load`) as a callable
    module. The ``roma::`` operators it may hold are registered first."""
    import roma_torch.kernels  # noqa: F401  (registers the roma:: operators)

    return torch.export.load(io.BytesIO(blob)).module()
