"""diart_tpu's public surface against the port's.

Every ``diart_tpu/**/*.py`` is read with ``ast`` (no jax import): each
name of its ``__all__`` (or, without one, each public top-level def and
class), and each public method, property, field and class constant of its
public classes. Each must resolve in the port's counterpart module
(``diart_tpu/x/y.py`` -> ``diart_tpu_torch.x.y``), or stand in
:data:`EXEMPT` with its reason and, where there is one, the port name that
stands for it. A field of a flax or frozen dataclass resolves to a class
attribute or a constructor argument of the same name. A name the JAX
module imports from a submodule (a function or a class) must not resolve
to a plain module in the port.

The table cannot go stale: an exempt name that gains a counterpart, or
that diart_tpu no longer has, fails, and so does a stand-in that does not
resolve.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import types
from pathlib import Path

import pytest

JAX_ROOT = Path(__file__).resolve().parents[1] / "diart_tpu"

_SWITCH = ("a kernel is not a switch: a CUDA tensor always runs its kernel, a CPU tensor its plain "
           "version (diart_tpu_torch/precision.py)")
_PHASED = "a TPU layout of the audio ring for the SincNet convolution (ROADMAP.md Queue 1 item 4)"
_SETUP = "flax builds submodules in setup(); a torch module builds them in __init__"

# diart_tpu name -> (why the port has no counterpart, the port name that
# stands for it or None). "path(arg)" names a constructor argument.
EXEMPT = {
    "diart_tpu.features.DeviceArrayFormatterState": (
        "restores jax arrays; the port's device arrays are torch tensors",
        "diart_tpu_torch.features.TorchTensorFormatterState"),
    "diart_tpu.models.base.SegmentationModel.apply_fn": (
        "a pure (params, waveform) function for jax.jit; a torch model is called",
        "diart_tpu_torch.models.base.SegmentationModel.__call__"),
    "diart_tpu.models.base.EmbeddingModel.trunk_fn": (
        "a pure (params, waveform) function for jax.jit; a torch model is called",
        "diart_tpu_torch.models.base.EmbeddingModel.trunk"),
    "diart_tpu.models.base.EmbeddingModel.head_fn": (
        "a pure (params, frames, weights) function for jax.jit; a torch model is called",
        "diart_tpu_torch.models.base.EmbeddingModel.head"),
    "diart_tpu.models.common.pallas_enabled": (_SWITCH, None),
    "diart_tpu.models.common.QuantizableConv.strides": (
        "a flax field named after lax.conv's argument", "diart_tpu_torch.models.common.QuantizableConv(stride)"),
    "diart_tpu.models.common.QuantizableConv.kernel_dilation": (
        "a flax field named after lax.conv's argument", "diart_tpu_torch.models.common.QuantizableConv(dilation)"),
    "diart_tpu.models.common.QuantizableConv.use_bias": (
        "a flax field named after nn.Conv's argument", "diart_tpu_torch.models.common.QuantizableConv(bias)"),
    "diart_tpu.models.ecapa.EcapaTDNN.setup": (_SETUP, "diart_tpu_torch.models.ecapa.EcapaTDNN.__init__"),
    "diart_tpu.models.embedding.XVectorSincNet.setup": (
        _SETUP, "diart_tpu_torch.models.embedding.XVectorSincNet.__init__"),
    "diart_tpu.models.resnet.ResNet34.setup": (_SETUP, "diart_tpu_torch.models.resnet.ResNet34.__init__"),
    "diart_tpu.models.titanet.TitaNet.setup": (_SETUP, "diart_tpu_torch.models.titanet.TitaNet.__init__"),
    "diart_tpu.models.xvect.XVectorFbank.setup": (_SETUP, "diart_tpu_torch.models.xvect.XVectorFbank.__init__"),
    "diart_tpu.models.lstm.BiLSTM.use_pallas": (_SWITCH, None),
    "diart_tpu.models.embedding.XVectorSincNet.supports_phased_wave": (_PHASED, None),
    "diart_tpu.models.segmentation.PyanNet.supports_phased_wave": (_PHASED, None),
    "diart_tpu.models.lstm.BiLSTM.keep_time_major": (
        "the port's BiLSTM is time-major in and out (the sweep kernel's layout)",
        "diart_tpu_torch.ops.lstm_sweep.lstm_sweep_tm"),
    "diart_tpu.ops.pallas_attn_stats": ("a Pallas kernel's module", "diart_tpu_torch.ops.attn_stats"),
    "diart_tpu.ops.pallas_lstm": ("a Pallas kernel's module", "diart_tpu_torch.ops.lstm_sweep"),
    "diart_tpu.ops.pallas_res2": ("a Pallas kernel's module", "diart_tpu_torch.ops.se_res2"),
    "diart_tpu.ops.pallas_stats": ("a Pallas kernel's module", "diart_tpu_torch.ops.linear_stats"),
    "diart_tpu.parallel.engine.MultiStreamEngine.step_cost_analysis": (
        "XLA's cost model of the jitted step program (its _probe); the port has no compiled step "
        "program, and chip_smoke.py computes its kernels' bounds", None),
    "diart_tpu.precision.Precision.pallas_lstm": (_SWITCH, None),
    "diart_tpu.precision.Precision.pallas_head": (_SWITCH, None),
    "diart_tpu.precision.Precision.pallas_attn": (_SWITCH, None),
    "diart_tpu.precision.Precision.pallas_res2": (_SWITCH, None),
    "diart_tpu.precision.Precision.fast_fbank": (
        "the port's fbank products always run in true f32", "diart_tpu_torch.ops._numerics.true_f32"),
    "diart_tpu.precision.Precision.phased_ring": (_PHASED, None),
    "diart_tpu.precision.Precision.lstm_block": (
        "the Pallas sweep's DMA blocking; the CUDA sweep has its own launch plan (ROADMAP.md Queue 1 "
        "item 4)", "diart_tpu_torch.ops.lstm_sweep.SweepWeights"),
    "diart_tpu.train.segmentation.TrainState.params": (
        "flax keeps the parameters apart from the module; a torch module holds its own",
        "diart_tpu_torch.train.segmentation.TrainState.module"),
    "diart_tpu.train.segmentation.TrainState.opt_state": (
        "optax's state; torch's optimizer holds its own",
        "diart_tpu_torch.train.segmentation.TrainState.optimizer"),
}


def _module_names(path: Path):
    parts = list(path.relative_to(JAX_ROOT.parent).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts), ".".join(["diart_tpu_torch"] + parts[1:])


def _dunder_all(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                                for t in node.targets):
            return [elt.value for elt in node.value.elts]
    return None


def _class_members(node: ast.ClassDef):
    """(name, kind) of a class body's public defs ("attr"), annotated
    fields ("field") and constants ("attr")."""
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield item.name, "attr"
        elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            yield item.target.id, "field"
        elif isinstance(item, ast.Assign):
            for target in item.targets:
                if isinstance(target, ast.Name):
                    yield target.id, "attr"


def _surface():
    """Every diart_tpu public name -> (its module, port module, attribute
    path, kind)."""
    names = {}
    for path in sorted(JAX_ROOT.rglob("*.py")):
        jmod, pmod = _module_names(path)
        tree = ast.parse(path.read_text())
        names.setdefault(jmod, (jmod, pmod, (), "module"))  # a package's export of the same name wins
        objects = {alias.asname or alias.name for node in tree.body if isinstance(node, ast.ImportFrom)
                   and node.module is not None for alias in node.names}
        public = _dunder_all(tree)
        if public is None:
            public = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                      and not n.name.startswith("_")]
        for name in public:
            names[f"{jmod}.{name}"] = (jmod, pmod, (name,), "object" if name in objects else "name")
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                names.setdefault(f"{jmod}.{node.name}", (jmod, pmod, (node.name,), "name"))
                for member, kind in _class_members(node):
                    if not member.startswith("_"):
                        names[f"{jmod}.{node.name}.{member}"] = (jmod, pmod, (node.name, member), kind)
    return names


SURFACE = _surface()


def _resolve(pmod: str, attrs, kind: str) -> bool:
    try:
        obj = importlib.import_module(pmod)
    except ImportError:
        return False
    for i, attr in enumerate(attrs):
        if hasattr(obj, attr):
            obj = getattr(obj, attr)
            continue
        if kind != "field" or i != len(attrs) - 1 or not inspect.isclass(obj):
            return False
        # a dataclass field without a default, or a constructor argument
        fields = getattr(obj, "__dataclass_fields__", {})
        return attr in fields or attr in inspect.signature(obj.__init__).parameters
    if kind == "object" and isinstance(obj, types.ModuleType) and not callable(obj):
        return False
    return True


def _resolves(key: str) -> bool:
    _, pmod, attrs, kind = SURFACE[key]
    return _resolve(pmod, attrs, kind)


def _exempt(key: str) -> bool:
    """Whether ``key`` or what holds it (its class, its module) is exempt."""
    return any(".".join(key.split(".")[:n]) in EXEMPT for n in range(2, key.count(".") + 2))


def _stand_in_resolves(dotted: str) -> bool:
    dotted, _, arg = dotted.partition("(")
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        try:
            for attr in parts[cut:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return False
        return not arg or arg.rstrip(")") in inspect.signature(obj).parameters
    return False


def test_surface_is_read():
    """The walk sees the JAX package: its modules, the names of each
    ``__all__`` and the classes' members."""
    assert "diart_tpu.models.base.LazyModel.with_dtype" in SURFACE
    assert "diart_tpu.ops.cluster_step" in SURFACE and SURFACE["diart_tpu.ops.binarize"][3] == "object"
    assert "diart_tpu.precision.Precision.int8_trunk" in SURFACE
    assert "diart_tpu.console.stream.run" in SURFACE
    assert len(SURFACE) > 700, len(SURFACE)


def _package(jmod: str) -> str:
    return jmod.split(".")[1] if "." in jmod else "diart_tpu"


@pytest.mark.parametrize("package", sorted({_package(jmod) for jmod, *_ in SURFACE.values()}))
def test_every_public_name_resolves(package):
    """Each public name of diart_tpu's modules in ``package`` resolves in
    the port or stands in EXEMPT."""
    missing = [key for key, (jmod, *_) in SURFACE.items()
               if _package(jmod) == package and not _exempt(key) and not _resolves(key)]
    assert not missing, f"no counterpart in the port: {missing}"


def test_exempt_table_is_current():
    """Every exempt name is diart_tpu's and still has no counterpart, and
    every stand-in resolves in the port."""
    unknown = [k for k in EXEMPT if k not in SURFACE]
    resolved = [k for k in EXEMPT if k in SURFACE and _resolves(k)]
    broken = [s for _, s in EXEMPT.values() if s is not None and not _stand_in_resolves(s)]
    assert not unknown, f"exempt names diart_tpu does not have: {unknown}"
    assert not resolved, f"exempt names that now have a counterpart in the port: {resolved}"
    assert not broken, f"stand-ins that do not resolve: {broken}"
    assert all(reason for reason, _ in EXEMPT.values())
