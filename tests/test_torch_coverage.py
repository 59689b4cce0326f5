"""Every public name of the JAX package has a counterpart in the port.

`roma_tpu/` is parsed with `ast` (nothing is imported), with the scripts
beside it that the port also carries (`demo/` -> `roma_torch/demo/`,
`experiments/` -> `roma_torch/experiments/`). For each module, every
public top-level def, class and variable (in an `__init__.py`, also what
it re-exports), every field of a class (flax `Module` fields, dataclass
fields, `__init__` parameters and attributes), every public method and
every parameter of a public function or method must have a counterpart
at the same relative path of `roma_torch/`, or an entry in NOT_PORTED: a
one-line reason and the counterpart where there is one. One case per
module.

Counterparts: a class field may be a field, an `__init__` parameter or an
attribute that `__init__` sets in the port's class; a flax `__call__` is
the port's `forward` (or `__call__`). NOT_PORTED must stay exact: every entry names an item that
still exists in the JAX package and that the port does not have, and every
counterpart it names exists in the port.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOTS = {"roma_tpu": "", "demo": "demo/", "experiments": "experiments/"}


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _self_attributes(fn: ast.FunctionDef) -> list[str]:
    """The ``self.x = ...`` attributes that `fn` sets."""
    return [t.attr for node in ast.walk(fn) if isinstance(node, (ast.Assign, ast.AnnAssign))
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
            and t.value.id == "self"]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _method_key(name: str) -> str:
    return "forward" if name == "__call__" else name


class ModuleIndex:
    """What one module binds: top-level names, functions' parameters, and
    per class its fields (class-body annotations, and `__init__`'s
    parameters and the attributes it sets) and methods' parameters."""

    def __init__(self, path: pathlib.Path):
        tree = ast.parse(path.read_text())
        self.path = path
        self.names: dict[str, str] = {}  # name -> "def" | "class" | "var" | "import"
        self.funcs: dict[str, list[str]] = {}
        self.fields: dict[str, list[str]] = {}
        self.methods: dict[str, dict[str, list[str]]] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.names[node.name] = "def"
                self.funcs[node.name] = _params(node)
            elif isinstance(node, ast.ClassDef):
                self.names[node.name] = "class"
                fields, methods = [], {}
                for s in node.body:
                    if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
                        fields.append(s.target.id)
                    elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        if s.name == "__init__":
                            fields += _params(s) + _self_attributes(s)
                        else:
                            methods[s.name] = _params(s)
                self.fields[node.name] = fields
                self.methods[node.name] = methods
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.names[t.id] = "var"
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                if isinstance(node, ast.ImportFrom) and node.module == "__future__":
                    continue
                for al in node.names:
                    self.names[(al.asname or al.name).split(".")[0]] = "import"

    def items(self) -> list[str]:
        """The public items of a JAX module, as NOT_PORTED keys spell them:
        ``name``, ``func(param)``, ``Class.field``, ``Class.method``,
        ``Class.method(param)``."""
        reexports = self.path.name == "__init__.py"
        out = []
        for name, kind in self.names.items():
            if not _public(name) or (kind == "import" and not reexports):
                continue
            out.append(name)
            if kind == "def":
                out += [f"{name}({p})" for p in self.funcs[name]]
            elif kind == "class":
                out += [f"{name}.{f}" for f in self.fields[name] if _public(f)]
                for m, ps in self.methods[name].items():
                    if _public(m) or m == "__call__":
                        out.append(f"{name}.{m}")
                        out += [f"{name}.{m}({p})" for p in ps]
        return out

    def has(self, item: str) -> bool:
        """Whether this (port) module has the counterpart of `item`."""
        head, _, param = item.partition("(")
        param = param.rstrip(")")
        cls, _, member = head.partition(".")
        if not member:
            if cls not in self.names:
                return False
            return not param or param in self.funcs.get(cls, [])
        if cls not in self.methods:
            return False
        methods = self.methods[cls]
        if not param and member in self.fields[cls]:
            return True
        for name in (member, _method_key(member)):
            if name in methods:
                return not param or param in methods[name]
        return False


def jax_modules() -> list[str]:
    out = []
    for root in JAX_ROOTS:
        base = REPO / root
        pattern = "**/*.py" if root == "roma_tpu" else "*.py"
        out += sorted(str(p.relative_to(REPO)) for p in base.glob(pattern))
    return out


def port_path(rel: str) -> pathlib.Path:
    root, _, rest = rel.partition("/")
    return REPO / "roma_torch" / (JAX_ROOTS[root] + rest)


# Shared reasons.
TRAIN = "flax's train/deterministic flag; the port's modules follow module.train() / .eval()"
SETUP = "flax's setup(); the port builds its submodules in __init__"
KEY = "a JAX PRNG key; the port takes a torch.Generator"
FLAX_INIT = ("flax's init from a PRNG key (and an example input size); the port builds "
             "its modules with build_model(cfg, seed)")
PARAMS = ("flax's variables passed in; the port's weights are the module's own "
          "(load_state_dict; port.state_dict_from_jax carries the JAX package's)")
DTYPE_FROM_INPUT = "the compute dtype; the port's module computes in its input's dtype"
UNSET = "an option no configuration sets; the port builds the one form every caller uses"
CONVERTER = ("a reference -> flax weight converter; the port's modules carry the "
             "reference's keys and load a reference state_dict as it is")
PROBE = ("a TPU measurement script (XLA traces, Pallas or XLA probes), not package "
         "code; the card's measurement is")
PALLAS = "the Pallas TPU kernel; the port's hand-written CUDA kernel and its wrapper"
SHARDING = "a JAX sharding object; the port's data parallelism is torch.distributed"
TORCHRUN = ("jax.distributed's explicit bootstrap; the port's process group comes from "
            "torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR)")

TPU = "roma_tpu/"
NOT_PORTED: dict[str, tuple[str, str | None]] = {
    # the TPU kernels
    TPU + "ops/pallas/__init__.py": (PALLAS, "roma_torch/kernels/__init__.py"),
    TPU + "ops/pallas/block_gather.py": (PALLAS + " (K1)", "roma_torch/kernels/local_corr.py"),
    TPU + "ops/pallas/corr_softmax.py": (PALLAS + " (K7)", "roma_torch/kernels/corr_softmax.py"),
    TPU + "ops/pallas/depthwise.py": (PALLAS + "s (K2; K4 and K5 in dw_affine_relu.py, "
                                      "dw_block_mm.py)", "roma_torch/kernels/dw_chain.py"),
    TPU + "ops/pallas/windowed_sample.py": (PALLAS + " (K6)",
                                            "roma_torch/kernels/windowed_sample.py"),
    TPU + "models/refiner.py::use_dma_local_corr": (
        "the gate of K1 in the refiner", "roma_torch/kernels/local_corr.py::use_kernel"),
    TPU + "ops/local_corr.py::local_correlation(padding_mode)": (
        "accepted and ignored by the JAX function (always zeros)", None),
    TPU + "ops/local_corr.py::local_correlation(pack)": (
        "TPU corner packing of the XLA gather", "roma_torch/kernels/local_corr.py"),
    TPU + "utils/profiling.py::PEAK_FLOPS_BF16": (
        "the TPU v5e's peak", "roma_torch/utils/profiling.py::PEAK_BF16_FLOPS"),
    TPU + "utils/profiling.py::PEAK_HBM_BYTES_PER_S": (
        "the TPU v5e's peak", "roma_torch/utils/profiling.py::PEAK_BYTES"),
    TPU + "utils/profiling.py::Roofline.mxu_utilization": (
        "the TPU's matrix unit; on the H100 its tensor cores",
        "roma_torch/utils/profiling.py::Roofline.tensor_core_utilization"),
    # weights
    TPU + "models/port.py::conv_kernel": (CONVERTER, "roma_torch/models/port.py::conv_weight"),
    TPU + "models/port.py::linear_kernel": (CONVERTER, "roma_torch/models/port.py::linear_weight"),
    TPU + "models/port.py::set_in": (CONVERTER, None),
    TPU + "models/port.py::port_conv": (CONVERTER, None),
    TPU + "models/port.py::port_batchnorm": (CONVERTER, None),
    TPU + "models/port.py::port_conv_block": (CONVERTER, None),
    TPU + "models/port.py::port_tiny_roma": (
        CONVERTER, "roma_torch/models/port.py::load_reference_tiny"),
    TPU + "models/port.py::port_dinov2": (CONVERTER, None),
    TPU + "models/port.py::port_vit_block": (CONVERTER, None),
    TPU + "models/port.py::port_transformer_decoder": (CONVERTER, None),
    TPU + "models/port.py::port_gp": (CONVERTER, None),
    TPU + "models/port.py::port_conv_refiner": (CONVERTER, None),
    TPU + "models/port.py::port_vgg19": (CONVERTER, None),
    TPU + "models/port.py::port_roma": (CONVERTER, "roma_torch/models/port.py::state_dict_from_jax"),
    TPU + "models/zoo.py::roma_outdoor(params)": (PARAMS, None),
    TPU + "models/zoo.py::tiny_roma_v1_outdoor(params)": (PARAMS, None),
    TPU + "models/matcher.py::RomaMatcher.params": (
        PARAMS, "roma_torch/models/matcher.py::RomaMatcher.model"),
    TPU + "models/matcher.py::RomaMatcher.init": (FLAX_INIT, "roma_torch/models/zoo.py::build_model"),
    TPU + "models/tiny_roma.py::TinyRomaMatcher.params": (
        PARAMS, "roma_torch/models/tiny_roma.py::TinyRomaMatcher.model"),
    TPU + "models/tiny_roma.py::TinyRomaMatcher.init": (
        FLAX_INIT, "roma_torch/models/zoo.py::build_model"),
    TPU + "train/train.py::make_tiny_train_state(rng)": (
        KEY, "roma_torch/train/train.py::make_tiny_train_state(seed)"),
    TPU + "train/train.py::make_tiny_train_state(hw)": (FLAX_INIT, None),
    TPU + "train/train.py::make_roma_train_state(rng)": (
        KEY, "roma_torch/train/train.py::make_roma_train_state(seed)"),
    TPU + "train/train.py::make_roma_train_state(hw)": (FLAX_INIT, None),
    TPU + "train/train.py::TrainState.params": (
        "optax/flax state as a pytree; the port's TrainState holds the module",
        "roma_torch/train/train.py::TrainState.model"),
    TPU + "train/train.py::TrainState.batch_stats": (
        "flax's BatchNorm collection; the port's are the module's buffers",
        "roma_torch/train/train.py::TrainState.model"),
    TPU + "train/train.py::TrainState.opt_state": (
        "optax's state; the port's is its torch optimizer's",
        "roma_torch/train/train.py::TrainState.optimizer"),
    TPU + "train/train.py::TrainState.tx": (
        "optax's transformation; the port's torch optimizer",
        "roma_torch/train/train.py::TrainState.optimizer"),
    TPU + "train/train.py::TrainState.apply_fn": (
        "flax's apply; the port calls the module", "roma_torch/train/train.py::TrainState.model"),
    # flax idiom in the modules
    TPU + "models/dinov2.py::DinoViT.__call__(train)": (TRAIN, None),
    TPU + "models/layers.py::ConvBlock.__call__(train)": (TRAIN, None),
    TPU + "models/matcher.py::CNNandDinov2.__call__(train)": (TRAIN, None),
    TPU + "models/matcher.py::Decoder.__call__(train)": (TRAIN, None),
    TPU + "models/matcher.py::RomaModel.encode(train)": (TRAIN, None),
    TPU + "models/matcher.py::RomaModel.__call__(train)": (TRAIN, None),
    TPU + "models/refiner.py::DWBlock.__call__(train)": (TRAIN, None),
    TPU + "models/refiner.py::ConvRefiner.__call__(train)": (TRAIN, None),
    TPU + "models/resnet.py::ResNet50.__call__(train)": (TRAIN, None),
    TPU + "models/tiny_roma.py::MatchRefiner.__call__(train)": (TRAIN, None),
    TPU + "models/tiny_roma.py::TinyRoma.__call__(train)": (TRAIN, None),
    TPU + "models/transformer.py::Attention.__call__(train)": (TRAIN, None),
    TPU + "models/transformer.py::Block.__call__(deterministic)": (
        TRAIN + "; its drop-path generator is the call's keyword",
        "roma_torch/models/transformer.py::Block.forward(generator)"),
    TPU + "models/transformer.py::TransformerDecoder.__call__(train)": (TRAIN, None),
    TPU + "models/vgg.py::VGG19.__call__(train)": (TRAIN, None),
    TPU + "models/xfeat.py::XFeatBackbone.__call__(train)": (TRAIN, None),
    TPU + "models/transformer.py::drop_path(deterministic)": (
        "flax's deterministic flag, inverted", "roma_torch/models/transformer.py::drop_path(training)"),
    TPU + "models/transformer.py::drop_path(rng)": (
        KEY, "roma_torch/models/transformer.py::drop_path(generator)"),
    TPU + "models/matcher.py::CNNandDinov2.setup": (SETUP, None),
    TPU + "models/matcher.py::Decoder.setup": (SETUP, None),
    TPU + "models/matcher.py::RomaModel.setup": (SETUP, None),
    TPU + "models/tiny_roma.py::TinyRoma.setup": (SETUP, None),
    TPU + "models/matcher.py::CNNandDinov2.dtype": (
        "always jnp.dtype(cfg.dtype) from RomaModel; the port reads cfg.dtype",
        "roma_torch/models/matcher.py::CNNandDinov2.cfg"),
    TPU + "models/refiner.py::DWBlock.dtype": (DTYPE_FROM_INPUT, None),
    TPU + "models/resnet.py::Bottleneck.dtype": (DTYPE_FROM_INPUT, None),
    TPU + "models/refiner.py::DWBlock.__call__(collect)": (
        "returns the inference-fused tensors for the chained kernel",
        "roma_torch/models/refiner.py::DWBlock.fused"),
    TPU + "models/refiner.py::DWBlock.depthwise": (UNSET + " (depthwise)", None),
    TPU + "models/refiner.py::DWBlock.bn_momentum": (UNSET + " (0.99)", None),
    TPU + "models/refiner.py::DWBlock.bn_eps": (UNSET + " (1e-5)", None),
    TPU + "models/layers.py::ConvBlock.features": (
        "flax's output width; PyTorch's Conv2d naming", "roma_torch/models/layers.py::ConvBlock.out_channels"),
    TPU + "models/layers.py::ConvBlock.groups": (UNSET + " (1)", None),
    TPU + "models/layers.py::ConvBlock.relu": (UNSET + " (ReLU on)", None),
    TPU + "models/layers.py::ConvBlock.affine_norm": (UNSET + " (BatchNorm without affine)", None),
    TPU + "models/layers.py::ConvBlock.use_bias": (UNSET + " (no conv bias)", None),
    TPU + "models/layers.py::torch_padding": (
        "a flax padding spec; PyTorch's Conv2d takes padding=k // 2", None),
    TPU + "models/transformer.py::TransformerDecoder.scales": (
        "the flax decoder's API (the constant [16]); nothing in the port asks it", None),
    TPU + "train/checkpoint.py::CheckPoint.manager": (
        "orbax's CheckpointManager; the port writes with torch.save",
        "roma_torch/train/checkpoint.py::CheckPoint.save"),
    TPU + "train/checkpoint.py::CheckPoint.wait": (
        "orbax's async save; torch.save is synchronous",
        "roma_torch/train/checkpoint.py::CheckPoint.save"),
    TPU + "losses/__init__.py::robust_loss": (
        "a re-export that would shadow the submodule of the same name",
        "roma_torch/losses/robust_loss.py::robust_loss"),
    # random keys
    TPU + "models/matcher.py::RomaMatcher.sample(key)": (
        KEY, "roma_torch/models/matcher.py::RomaMatcher.sample(generator)"),
    TPU + "models/matcher.py::RomaMatcher.sample_batched(keys)": (
        KEY + " a pair", "roma_torch/models/matcher.py::RomaMatcher.sample_batched(generators)"),
    TPU + "models/tiny_roma.py::TinyRomaMatcher.sample(key)": (
        KEY, "roma_torch/models/tiny_roma.py::TinyRomaMatcher.sample(generator)"),
    TPU + "utils/sampling.py::gumbel_topk(key)": (
        KEY, "roma_torch/utils/sampling.py::gumbel_topk(generator)"),
    TPU + "utils/sampling.py::sample_matches(key)": (
        KEY, "roma_torch/utils/sampling.py::sample_matches(generator)"),
    TPU + "benchmarks/harness_core.py::run_batched_eval(sample_key)": (
        KEY + "; a pair's generator comes from the seed and its index",
        "roma_torch/benchmarks/harness_core.py::run_batched_eval(seed)"),
    # sharding
    TPU + "parallel/mesh.py::make_mesh(n_data)": (
        SHARDING + " (the data axis spans the process group's ranks)",
        "roma_torch/parallel/mesh.py::make_mesh"),
    TPU + "parallel/mesh.py::initialize_distributed(coordinator_address)": (
        TORCHRUN, "roma_torch/parallel/mesh.py::initialize_distributed"),
    TPU + "parallel/mesh.py::initialize_distributed(num_processes)": (
        TORCHRUN, "roma_torch/parallel/mesh.py::initialize_distributed"),
    TPU + "parallel/mesh.py::initialize_distributed(process_id)": (
        TORCHRUN, "roma_torch/parallel/mesh.py::initialize_distributed"),
    TPU + "parallel/mesh.py::make_mesh(n_model)": (
        SHARDING + " (one data axis, no model axis)", "roma_torch/parallel/mesh.py::make_mesh"),
    TPU + "parallel/mesh.py::make_mesh(devices)": (
        SHARDING + " (the mesh spans the process group's ranks)", None),
    TPU + "parallel/mesh.py::batch_sharding": (SHARDING, "roma_torch/parallel/mesh.py::shard_batch"),
    TPU + "parallel/mesh.py::replicated_sharding": (SHARDING, "roma_torch/parallel/mesh.py::replicate"),
    TPU + "parallel/mesh.py::replicate(tree)": (
        "a pytree; the port broadcasts its train state object",
        "roma_torch/parallel/mesh.py::replicate(state)"),
    # scripts beside the package
    "demo/demo_match_opencv_sift.py": (
        "OpenCV SIFT for comparison; imports neither package", None),
    "experiments/analyze_xplane_gaps.py": (PROBE + " torch.profiler's", "chip_smoke.py::profile_match"),
    "experiments/baseline_estimate.py": (
        PROBE + " the roofline's", "roma_torch/utils/profiling.py::roofline"),
    "experiments/bench_estimator.py": (PROBE + " the eval phase's", "chip_smoke.py::run_eval"),
    "experiments/bench_harness.py": (PROBE + " the eval phase's", "chip_smoke.py::run_eval"),
    "experiments/probe_dma_gather.py": (PROBE + " K1's", "kernel_variants.py"),
    "experiments/probe_harness_stages.py": (PROBE + " the eval profile's", "chip_smoke.py::profile_eval"),
    "experiments/probe_refiner_blocks.py": (PROBE + " K2's phases", "k2_phases.py"),
    "experiments/profile_gather_variants.py": (PROBE + " K6's", "kernel_variants.py"),
    "experiments/profile_local_corr.py": (PROBE + " K1's", "kernel_variants.py"),
    "experiments/profile_roma_kernels.py": (PROBE + " match()'s by call", "match_profile.py"),
    "experiments/profile_roma_stages.py": (PROBE + " match()'s by stage", "chip_smoke.py::profile_match"),
    "experiments/profile_train_step.py": (PROBE + " the training phase's", "chip_smoke.py::run_training"),
    "experiments/profile_windowed_sample.py": (PROBE + " K6's", "kernel_variants.py"),
    "experiments/trace_fwd_up.py": (PROBE + " torch.profiler's", "chip_smoke.py::profile_match"),
}


def _split(key: str) -> tuple[str, str]:
    rel, _, item = key.partition("::")
    return rel, item


def covered(rel: str, item: str) -> bool:
    """Whether a NOT_PORTED entry covers `item` of module `rel`: the whole
    module, the item, or what it belongs to (a function or class covers its
    parameters and members, a method its parameters)."""
    if rel in NOT_PORTED:
        return True
    head = item.partition("(")[0]
    owners = {item, head, head.partition(".")[0]}
    return any(f"{rel}::{o}" in NOT_PORTED for o in owners)


def resolves(counterpart: str) -> bool:
    rel, item = _split(counterpart)
    path = REPO / rel
    return path.exists() and (not item or ModuleIndex(path).has(item))


def missing(rel: str) -> list[str]:
    """The JAX module's items that the port lacks (NOT_PORTED not applied)."""
    items = ModuleIndex(REPO / rel).items()
    dst = port_path(rel)
    if not dst.exists():
        return [""] + items  # "" = the whole module
    port = ModuleIndex(dst)
    return [i for i in items if not port.has(i)]


MODULES = jax_modules()


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_counterparts(rel):
    """Each public item of the JAX module is in the port or in NOT_PORTED,
    and this module's NOT_PORTED entries are exact: each names an item that
    the JAX module has and the port lacks, gives a reason, and names a
    counterpart that exists."""
    lacking = missing(rel)
    uncovered = [i for i in lacking if not covered(rel, i)]
    assert not uncovered, f"{rel}: no counterpart in the port and no NOT_PORTED entry: {uncovered}"
    for key, (reason, counterpart) in NOT_PORTED.items():
        k_rel, item = _split(key)
        if k_rel != rel:
            continue
        assert reason.strip(), key
        assert item in lacking, f"stale NOT_PORTED entry {key}: " + (
            "the port has it" if item in ModuleIndex(REPO / rel).items() or not item
            else "the JAX module has no such item")
        assert counterpart is None or resolves(counterpart), f"{key}: no {counterpart}"


def test_not_ported_names_jax_modules():
    """Every NOT_PORTED entry's module is one of the JAX package's."""
    assert {_split(k)[0] for k in NOT_PORTED} <= set(MODULES)


if __name__ == "__main__":
    for rel in jax_modules():
        for item in missing(rel):
            if not covered(rel, item):
                print(f"{rel}::{item}")
