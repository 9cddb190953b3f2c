"""Model wrappers, the registry and the model files (port of
``diart_tpu/models/base.py``).

``from_pretrained`` resolves, in order: ``.onnx`` files (host-only models,
through ``onnxruntime``), model files with a ``<path>.json`` config beside
them (any ``.msgpack``/``.npz`` file, and a torch suffix with the config),
torch checkpoints (``.bin``/``.pt``/``.ckpt``/``.safetensors`` without a
config: converted by :mod:`diart_tpu_torch.models.convert`), the
``tpu/...`` registry under the JAX package's names and size arguments, and
else pyannote model names (which need ``pyannote.audio``).

A model file is one of two formats, told apart by its bytes, not its
suffix: the port's native file (``torch.save`` of the module's state
dict, a zip: ``PK\x03\x04``, read back with ``weights_only=True``) or
the file ``diart_tpu``'s ``save`` writes (flax msgpack bytes whatever the
suffix, ``.npz`` included, read by :mod:`diart_tpu_torch.flaxio` and
mapped by :func:`diart_tpu_torch.weights.load_flax_params`, which is
strict). Both carry the JAX package's ``.json`` config schema:
``module_class`` (the role's default class when it is missing, as in the
JAX package), ``module`` (the constructor's arguments, dtypes as
``"bf16"``/``"f32"``, tuples as lists), ``powerset`` and, from
``diart_tpu``, ``init_samples`` (not needed here). A file that is neither
format raises and names both.

Registry weights come from a seeded ``torch.Generator`` (the seed defaults
to a CRC of the registry name) or, with ``flax_params=``, from the JAX
package's parameter tree through
:func:`diart_tpu_torch.weights.load_flax_params`.

The wrappers are lazy (:class:`LazyModel`, as the JAX package's): the
``from_*`` constructors store a loader, and the module is built and placed
on its device at first use (``load()``, ``to(device)``, ``eval()``, a
call, or a property that needs it); ``with_dtype`` sets the compute dtype
before or after the load; a pickled model carries its loader. They
default to ``device="cuda"`` and raise without a GPU. A
host-only model (its module has ``host_only = True``: the ONNX wrapper's
contract) takes and returns numpy arrays and runs only through the
pipelines, as in the JAX package.
"""

from __future__ import annotations

import inspect
import json
import zlib
from copy import deepcopy
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .. import flaxio
from ..ops._build import require_cuda
from .common import QuantizableConv
from .ecapa import EcapaTDNN
from .embedding import XVectorSincNet
from .lstm import BiLSTM
from .powerset import num_powerset_classes, powerset_mapping, to_multilabel
from .resnet import ResNet34
from .segmentation import PyanNet
from .titanet import TitaNet
from .xvect import XVectorFbank

__all__ = ["EmbeddingModel", "LazyModel", "SegmentationModel", "init_weights", "same_device"]

TORCH_SUFFIXES = (".bin", ".pt", ".ckpt", ".safetensors")
FLAX_SUFFIXES = (".msgpack", ".npz")
ZIP_MAGIC = b"PK\x03\x04"  # the first bytes of a torch.save file
MODULE_CLASSES: Dict[str, type] = {
    cls.__name__: cls for cls in (PyanNet, XVectorSincNet, EcapaTDNN, ResNet34, TitaNet, XVectorFbank)
}


def _dtype_kwarg(kwargs) -> torch.dtype:
    return torch.bfloat16 if kwargs.get("dtype", "f32") in ("bf16", "bfloat16", torch.bfloat16) else torch.float32


def _seed_from_name(name: str) -> int:
    return zlib.crc32(name.encode("utf-8")) % (2**31)


def _check_kwargs(name: str, kwargs: dict, known: tuple) -> None:
    unknown = set(kwargs) - set(known)
    if unknown:
        raise TypeError(f"{name}: unknown arguments {sorted(unknown)}; known: {list(known)}")


def _orthogonal(rows: int, cols: int, gen: torch.Generator) -> torch.Tensor:
    a = torch.randn(rows, cols, generator=gen)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random init from ``gen``: LeCun-normal matrices and convolutions, zero
    biases, orthogonal recurrent weights (as the flax initializers). SincNet
    cutoffs keep their mel init; norms their identity init (scale 1, bias 0,
    mean 0, var 1)."""
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Conv1d, QuantizableConv)):
            fan_in = sub.weight[0].numel()
            sub.weight.copy_(torch.randn(sub.weight.shape, generator=gen) / fan_in**0.5)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, BiLSTM):
            for layer in range(sub.num_layers):
                w_ih = getattr(sub, f"l{layer}_w_ih")
                w_ih.copy_(torch.randn(w_ih.shape, generator=gen) / w_ih.shape[-1] ** 0.5)
                w_hh = getattr(sub, f"l{layer}_w_hh")
                for d in range(2):
                    w_hh[d].copy_(_orthogonal(*w_hh.shape[1:], gen))
                getattr(sub, f"l{layer}_b").zero_()
    return module


def _is_model_file(name: str) -> bool:
    """A model file of either format: a flax suffix, or a torch suffix with
    its ``<path>.json`` config beside it (a torch checkpoint has none)."""
    return name.endswith(FLAX_SUFFIXES) or (name.endswith(TORCH_SUFFIXES) and Path(f"{name}.json").exists())


def module_config(module: nn.Module) -> dict:
    """The module's constructor arguments as JSON values (dtypes as
    ``"bf16"``/``"f32"``, tuples as lists), read from the attributes of the
    same names: the ``module`` field of the JAX package's config schema."""
    if type(module).__name__ not in MODULE_CLASSES:
        raise TypeError(
            f"save() supports the port's own modules only; {type(module).__name__} "
            "(from_apply / host-only) cannot be serialized"
        )

    def plain(value):
        if isinstance(value, torch.dtype):
            return "bf16" if value == torch.bfloat16 else "f32"
        if isinstance(value, (tuple, list)):
            return [plain(v) for v in value]
        return value

    names = list(inspect.signature(type(module).__init__).parameters)[1:]
    return {name: plain(getattr(module, name)) for name in names}


def restore_module_config(config: dict) -> dict:
    """Constructor arguments from :func:`module_config`'s JSON values."""
    out = {}
    for key, value in config.items():
        if value == "bf16":
            value = torch.bfloat16
        elif value == "f32":
            value = torch.float32
        elif isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        out[key] = value
    return out


def _save_native(path, module: nn.Module, powerset=None) -> None:
    """``torch.save`` of the state dict at ``path``, its config at
    ``<path>.json``."""
    path = Path(path)
    config = {"module": module_config(module), "module_class": type(module).__name__}
    if powerset is not None:
        config["powerset"] = list(powerset)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)
    Path(f"{path}.json").write_text(json.dumps(config))


def _load_file(path, default_cls: type) -> Tuple[nn.Module, dict]:
    """A model file of either format (see the module docstring) -> (module
    on the CPU, config). ``default_cls``: the class when the config names
    none."""
    path = Path(path)
    config_path = Path(f"{path}.json")
    if not config_path.exists():
        raise FileNotFoundError(f"{path}: a model file needs its config at {config_path}")
    config = json.loads(config_path.read_text())
    cls_name = config.get("module_class", default_cls.__name__)
    if cls_name not in MODULE_CLASSES:
        raise ValueError(f"unknown serialized module class {cls_name!r}; known: {sorted(MODULE_CLASSES)}")
    module = MODULE_CLASSES[cls_name](**restore_module_config(config.get("module", {})))
    data = path.read_bytes()
    if data[:4] == ZIP_MAGIC:
        module.load_state_dict(torch.load(str(path), map_location="cpu", weights_only=True), strict=True)
        return module, config
    try:
        tree = flaxio.loads(data)
    except ValueError as exc:
        raise ValueError(
            f"{path}: neither the port's native file (a torch.save zip) nor a diart_tpu file "
            f"(flax msgpack): {exc}"
        ) from exc
    from ..weights import load_flax_params

    load_flax_params(module, tree)
    return module, config


def _with_dtype(module: nn.Module, dtype) -> nn.Module:
    """The module rebuilt to compute in ``dtype`` ("bf16"/"f32"), with the
    same (f32) parameters."""
    config = module_config(module)
    config["compute_dtype"] = "bf16" if _dtype_kwarg({"dtype": dtype}) == torch.bfloat16 else "f32"
    out = type(module)(**restore_module_config(config))
    out.load_state_dict(module.state_dict())
    return out


def _ready(module: nn.Module, device) -> nn.Module:
    return module.to(device).eval().requires_grad_(False)


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is the current
    CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = lambda d: d.index if d.index is not None else torch.cuda.current_device()
    return current(a) == current(b)


def _replica(module, device, copy: bool = True) -> nn.Module:
    """A copy of ``module`` on ``device`` (its weights copied once), or with
    ``copy=False`` the module itself moved there."""
    if not isinstance(module, nn.Module):
        raise TypeError(
            f"{type(module).__name__} holds its own weights and cannot be moved to another "
            f"device; build it there"
        )
    return (deepcopy(module) if copy else module).to(device)


class _SegFn:
    """The module of ``SegmentationModel.from_apply``: a torch callable
    ``waveform (B, C, S) -> (B, frames, K)``."""

    def __init__(self, fn: Callable, num_speakers: int, sample_rate: int, device: torch.device):
        self._fn = fn
        self.num_speakers = num_speakers
        self.sample_rate = sample_rate
        self.device = device
        self._frames: dict = {}

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        return self._fn(waveform)

    @torch.no_grad()
    def num_frames(self, num_samples: int) -> int:
        """The frames the callable gives for ``num_samples`` samples, probed
        once per length on a zero waveform (the JAX engine probes its model
        the same way)."""
        if num_samples not in self._frames:
            probe = torch.zeros(1, 1, num_samples, device=self.device)
            self._frames[num_samples] = int(self._fn(probe).shape[1])
        return self._frames[num_samples]


class _EmbFn:
    """The module of ``EmbeddingModel.from_apply``: torch callables
    ``trunk(waveform (B, C, S)) -> frames`` and ``head(frames, weights
    (B, K, T)) -> (B, K, E)``; a head without weights pools with ones, as
    the JAX package's shim does."""

    fbank_ring_kind = None

    def __init__(self, trunk: Callable, head: Callable, embedding_dim: int, sample_rate: int):
        self._trunk = trunk
        self._head = head
        self.embedding_dim = embedding_dim
        self.sample_rate = sample_rate

    def trunk(self, waveform: torch.Tensor) -> torch.Tensor:
        return self._trunk(waveform)

    def head(self, frames: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        if weights is None:
            ones = torch.ones(frames.shape[0], 1, frames.shape[1], dtype=frames.dtype,
                              device=frames.device)
            return self._head(frames, ones)[:, 0]
        return self._head(frames, weights)


SEG_REGISTRY = ("tpu/pyannet", "tpu/pyannet-powerset")
SEG_SIZES = ("num_speakers", "lstm_hidden", "lstm_layers", "linear_dims", "dtype")
EMB_REGISTRY = {
    "tpu/xvector": (XVectorSincNet, dict(embedding_dim=512)),
    "tpu/ecapa": (EcapaTDNN, dict(embedding_dim=192, channels=512)),
    "tpu/resnet34": (ResNet34, dict(embedding_dim=256, base_channels=32)),
    "tpu/titanet": (TitaNet, dict(embedding_dim=192, channels=1024)),
    "tpu/xvect-sb": (XVectorFbank, dict(
        embedding_dim=512, num_mels=24,
        tdnn_specs=((5, 1, 512), (3, 2, 512), (3, 3, 512), (1, 1, 512), (1, 1, 1500)))),
}


def _check_registry(role: str, name: str, kwargs: dict) -> None:
    """Raise for a registry name or a size argument the role does not know."""
    if role == "segmentation":
        if name not in SEG_REGISTRY:
            raise ValueError(f"unknown segmentation registry name {name!r}; known: {list(SEG_REGISTRY)}")
        _check_kwargs(name, kwargs, SEG_SIZES + (("max_simultaneous",) if name.endswith("powerset") else ()))
        return
    if name not in EMB_REGISTRY:
        raise ValueError(f"unknown embedding registry name {name!r}; known: {list(EMB_REGISTRY)}")
    _check_kwargs(name, kwargs, tuple(EMB_REGISTRY[name][1]) + ("dtype",))


def _seg_declared(name: str, kwargs: dict) -> Optional[Tuple[int, int]]:
    """(num_speakers, max_simultaneous) of a powerset registry model, else
    None."""
    if name != "tpu/pyannet-powerset":
        return None
    return kwargs.get("num_speakers", 3), kwargs.get("max_simultaneous", 2)


def _registry_module(role: str, name: str, kwargs: dict) -> nn.Module:
    """The registry architecture ``name`` with its size arguments, on the
    host, its weights not yet set."""
    if role == "segmentation":
        declared = _seg_declared(name, kwargs)
        return PyanNet(
            num_speakers=kwargs.get("num_speakers", 4) if declared is None else declared[0],
            lstm_hidden=kwargs.get("lstm_hidden", 128),
            lstm_layers=kwargs.get("lstm_layers", 4),
            linear_dims=tuple(kwargs.get("linear_dims", (128, 128))),
            compute_dtype=_dtype_kwarg(kwargs),
            powerset_classes=0 if declared is None else num_powerset_classes(*declared),
        )
    cls, defaults = EMB_REGISTRY[name]
    args = {k: kwargs.get(k, v) for k, v in defaults.items()}
    if "tdnn_specs" in args:
        args["tdnn_specs"] = tuple(tuple(spec) for spec in args["tdnn_specs"])
    return cls(**args, compute_dtype=_dtype_kwarg(kwargs))


class _Loader:
    """What builds a model's module on the host: ``kind`` and its arguments.
    Calling it gives (module, meta). It is what a model pickles (spawn
    workers rebuild the module from it), so it holds names, paths, seeds and
    a ``from_apply`` callable or a module passed in, never a built registry
    or file module."""

    def __init__(self, kind: str, *args):
        self.kind = kind
        self.args = args

    def __call__(self) -> Tuple[object, dict]:
        return getattr(self, f"_{self.kind}")(*self.args)

    @staticmethod
    def _held(module):
        return module, {}

    @staticmethod
    def _registry(role: str, name: str, seed: Optional[int], flax_params, kwargs: dict):
        module = _registry_module(role, name, kwargs)
        if flax_params is not None:
            from ..weights import load_flax_params

            load_flax_params(module, flax_params)
        else:
            gen = torch.Generator().manual_seed(_seed_from_name(name) if seed is None else int(seed))
            init_weights(module, gen)
        return module, {}

    @staticmethod
    def _file(path: str, default_cls: str):
        module, config = _load_file(path, MODULE_CLASSES[default_cls])
        return module, {"powerset": config.get("powerset")}

    @staticmethod
    def _torch_seg(path: str, powerset):
        from .convert import load_pyannet_checkpoint

        return load_pyannet_checkpoint(path, powerset)

    @staticmethod
    def _torch_emb(path: str):
        from .convert import load_embedding_checkpoint

        return load_embedding_checkpoint(path)

    @staticmethod
    def _pyannote_seg(model, use_hf_token):
        from .convert import load_pyannote_segmentation

        return load_pyannote_segmentation(model, use_hf_token)

    @staticmethod
    def _pyannote_emb(model, use_hf_token):
        from .convert import load_pyannote_embedding

        return load_pyannote_embedding(model, use_hf_token)

    @staticmethod
    def _onnx(path: str, input_names, output_name: str):
        from .onnx import ONNXModel

        return ONNXModel(path, input_names, output_name), {}


def _as_dtype(module, dtype: Optional[str]):
    """``module`` computing in ``dtype`` ("bf16"/"f32"; None: as it is).
    Modules without a ``compute_dtype`` (callables, ONNX) are left as they
    are, as in the JAX package."""
    if dtype is None or type(module).__name__ not in MODULE_CLASSES:
        return module
    if module.compute_dtype == _dtype_kwarg({"dtype": dtype}):
        return module
    return _with_dtype(module, dtype)


def _place(module, device):
    """An ``nn.Module`` on ``device``, for inference; anything else (a
    callable holding its own weights, a host-only model) as it is."""
    return _ready(module, device) if isinstance(module, nn.Module) else module


class LazyModel:
    """A model whose module is built at first use (port of the JAX
    package's ``LazyModel``).

    ``loader()`` gives (module on the host, meta); :meth:`load` calls it
    and places the module on :attr:`device`. Every property and call that
    needs the module loads it. A route that reads a source (a model file, a
    torch checkpoint, a pyannote model, an ONNX file) reads and checks it on
    the host when the model is made, so a bad source fails where it is
    named, and keeps what it read for the first load; the registry and
    ``from_apply`` routes build nothing until then. ``device`` is set at
    construction (``require_cuda``: no GPU and no ``device="cpu"`` raises
    there) and :meth:`to` moves it.

    A pickled model carries its loader and not its module: spawn workers
    (``Parallelize``) build it again on the same device, from the same
    name and seed, file or callable. Changes made in place to a loaded
    module (training) do not cross; a module passed to the constructor or
    through ``from_apply`` crosses as it is."""

    def __init__(self, loader: Callable[[], Tuple[object, dict]], name: str, device, staged=None):
        self._loader = loader
        self._staged = staged  # (module, meta) read at construction, until the first load
        self._module = None
        self.meta: Dict[str, object] = {}
        self.name = name
        self.device = torch.device(device)
        self._pending_dtype: Optional[str] = None

    def is_in_memory(self) -> bool:
        """Whether the module is built and on its device."""
        return self._module is not None

    def load(self) -> "LazyModel":
        """Build the module (once) and place it on :attr:`device`."""
        if self._module is None:
            self._load_on(self.device)
        return self

    def _load_on(self, device) -> None:
        module, meta = self._staged if self._staged is not None else self._loader()
        self._staged = None
        self.meta = dict(meta)
        if not (getattr(module, "host_only", False) or same_device(device, self.device)):
            module = _replica(module, device, copy=False)
            self.device = torch.device(device)
        self._install(_place(_as_dtype(module, self._pending_dtype), self.device))

    def _install(self, module) -> None:
        self._module = module

    @property
    def module(self):
        """The built module (loads the model)."""
        return self.load()._module

    def with_dtype(self, dtype) -> "LazyModel":
        """Compute in ``dtype`` ("bf16"/"f32") whatever the model was made
        with; the parameters stay f32. Before the load it applies at the
        load, after it the module is rebuilt now. Modules without a compute
        dtype (callables, ONNX) are unaffected."""
        self._pending_dtype = "bf16" if _dtype_kwarg({"dtype": dtype}) == torch.bfloat16 else "f32"
        if self._module is not None:
            self._install(_place(_as_dtype(self._module, self._pending_dtype), self.device))
        return self

    def to(self, device=None) -> "LazyModel":
        """Load the model and place it on ``device`` (diart's idiom; the
        torch reading of the JAX package's ``to``). A host-only model stays
        on the host; a callable holding its own weights cannot move."""
        if device is None:
            return self.load()
        device = require_cuda(device)
        if self._module is None:
            self._load_on(device)
        elif not (self.host_only or same_device(device, self.device)):
            module = _replica(self._module, device, copy=False)
            self.device = device
            self._install(module)
        return self

    def eval(self) -> "LazyModel":
        """Load the model (its module is always in inference mode)."""
        return self.load()

    def __getstate__(self):
        """Pickle the loader, not the module (see the class docstring)."""
        state = self.__dict__.copy()
        state.update(_module=None, _staged=None, meta={})
        return state

    @property
    def host_only(self) -> bool:
        """Whether the model runs on the host (numpy in and out) and only
        through the pipelines."""
        return getattr(self.module, "host_only", False)

    @property
    def sample_rate(self) -> int:
        return getattr(self.module, "sample_rate", 16000)

    def save(self, path) -> None:
        """The port's native file at ``path`` (see the module docstring)."""
        _save_native(path, self.module, getattr(self, "_powerset", None))

    def replicate(self, device) -> "LazyModel":
        """This model on ``device``: itself where it lies there, else a
        copy in memory."""
        if same_device(device, self.device):
            return self
        return self._held(_replica(self.module, device), device)

    def _held(self, module, device) -> "LazyModel":
        raise NotImplementedError


def _staged(loader: _Loader):
    """Read a model's source now (see :class:`LazyModel`): (loader, what it
    gave)."""
    return loader, loader()


class SegmentationModel(LazyModel):
    """waveform (B, 1, samples) -> activations (B, frames, speakers). A
    powerset model's class scores are decoded to speakers inside the call
    (one-hot of the argmax times the class -> speakers mapping), so every
    caller, the engine included, sees speakers.

    ``SegmentationModel(module, name, device, powerset)`` wraps a module
    already built; the ``from_*`` constructors make lazy models (see
    :class:`LazyModel`)."""

    KNOWN = SEG_REGISTRY

    def __init__(self, module, name: str, device, powerset: Optional[Tuple[int, int]] = None,
                 loader=None, staged=None):
        super().__init__(_Loader("held", module) if loader is None else loader, name, device, staged)
        self._powerset = None if powerset is None else tuple(powerset)
        self._mapping = None
        if loader is None:
            self._install(module)

    def _install(self, module) -> None:
        self._module = module
        if self._powerset is None and self.meta.get("powerset"):
            self._powerset = tuple(self.meta["powerset"])
        if self._powerset is not None:
            self._mapping = torch.from_numpy(powerset_mapping(*self._powerset)).to(self.device)

    def __getstate__(self):
        return dict(super().__getstate__(), _mapping=None)

    def _held(self, module, device) -> "SegmentationModel":
        return SegmentationModel(module, self.name, device, self._powerset)

    @staticmethod
    def from_pretrained(model, use_hf_token=True, device="cuda", **kwargs) -> "SegmentationModel":
        """A file, a registry name (``tpu/...``, with :meth:`from_registry`'s
        arguments) or a pyannote name (see the module docstring).
        ``powerset=(speakers, max_simultaneous)`` declares a raw torch
        checkpoint as powerset-encoded; elsewhere it is ignored (the
        registry and native files know their own)."""
        name = str(model)
        powerset = kwargs.pop("powerset", None)
        if name.endswith(".onnx"):
            return SegmentationModel.from_onnx(model)
        if _is_model_file(name):
            device = require_cuda(device)
            loader, staged = _staged(_Loader("file", name, "PyanNet"))
            return SegmentationModel(None, name, device, loader=loader, staged=staged)
        if name.endswith(TORCH_SUFFIXES):
            return SegmentationModel.from_torch(model, powerset=powerset, device=device)
        if name.startswith("tpu/"):
            return SegmentationModel.from_registry(name, device=device, **kwargs)
        return SegmentationModel.from_pyannote(model, use_hf_token, device=device)

    @staticmethod
    def from_apply(
        apply_fn: Callable, sample_rate: int = 16000, num_speakers: int = 4, device="cuda"
    ) -> "SegmentationModel":
        """Wrap a torch callable ``waveform (B, C, S) -> (B, frames, K)`` that
        runs on ``device`` (it holds its own weights, so it takes no
        ``params``)."""
        device = require_cuda(device)
        loader = _Loader("held", _SegFn(apply_fn, num_speakers, sample_rate, device))
        return SegmentationModel(None, "apply", device, loader=loader)

    @staticmethod
    def from_registry(
        name: str, device="cuda", seed: Optional[int] = None, flax_params=None, **kwargs
    ) -> "SegmentationModel":
        """``tpu/pyannet`` or ``tpu/pyannet-powerset`` with the JAX registry's
        size arguments (num_speakers, lstm_hidden, lstm_layers, linear_dims,
        dtype; the powerset model also max_simultaneous, and defaults to 3
        speakers, at most 2 at once). The weights come from ``seed`` (a CRC
        of the name by default) or ``flax_params`` at the first load."""
        _check_registry("segmentation", name, kwargs)
        device = require_cuda(device)
        loader = _Loader("registry", "segmentation", name, seed, flax_params, kwargs)
        return SegmentationModel(None, name, device, _seg_declared(name, kwargs), loader=loader)

    @staticmethod
    def from_torch(path, powerset: Optional[Tuple[int, int]] = None, device="cuda") -> "SegmentationModel":
        """A torch PyanNet checkpoint, converted. ``powerset``:
        (num_speakers, max_simultaneous) for a checkpoint whose classifier
        emits powerset classes (pyannote/segmentation-3.0 style) — a raw
        state dict cannot tell, so it must be declared."""
        device = require_cuda(device)
        loader, staged = _staged(_Loader("torch_seg", str(path), powerset))
        return SegmentationModel(None, str(path), device, loader=loader, staged=staged)

    @staticmethod
    def from_pyannote(model, use_hf_token=True, device="cuda") -> "SegmentationModel":
        """A pyannote model name, through ``pyannote.audio`` (raises
        ImportError without it)."""
        device = require_cuda(device)
        loader, staged = _staged(_Loader("pyannote_seg", model, use_hf_token))
        return SegmentationModel(None, str(model), device, loader=loader, staged=staged)

    @staticmethod
    def from_onnx(model_path, input_name: str = "waveform", output_name: str = "segmentation"
                  ) -> "SegmentationModel":
        """An ONNX model on the host (needs ``onnxruntime``)."""
        loader, staged = _staged(_Loader("onnx", str(model_path), [input_name], output_name))
        return SegmentationModel(None, str(model_path), "cpu", loader=loader, staged=staged)

    @property
    def powerset(self) -> Optional[Tuple[int, int]]:
        """(num_speakers, max_simultaneous) when the model emits powerset
        classes, else None (declared, or known once the model is loaded)."""
        if self._powerset is None:
            self.load()
        return self._powerset

    @property
    def num_speakers(self) -> int:
        if self.powerset is not None:
            return self._powerset[0]
        return getattr(self.module, "num_speakers", 4)

    def num_frames(self, num_samples: int) -> int:
        return self.module.num_frames(num_samples)

    @torch.no_grad()
    def __call__(self, waveform, **kwargs):
        """waveform (B, 1, samples) -> (B, frames, speakers); ``kwargs`` go
        to the module (the engine's ``sinc_pooled``)."""
        out = self.module(waveform, **kwargs)
        if self._powerset is not None:
            out = to_multilabel(out, self._mapping)
        return out


class EmbeddingModel(LazyModel):
    """Waveform + per-speaker weights -> embeddings, with a trunk/head split.
    Mel models (``fbank_ring_kind`` not None) also take the engine's raw
    log-mel frames through :meth:`trunk_from_raw_fbank`.

    ``EmbeddingModel(module, name, device)`` wraps a module already built;
    the ``from_*`` constructors make lazy models (see :class:`LazyModel`)."""

    KNOWN = tuple(sorted(EMB_REGISTRY))

    def __init__(self, module, name: str, device, loader=None, staged=None):
        super().__init__(_Loader("held", module) if loader is None else loader, name, device, staged)
        if loader is None:
            self._install(module)

    def _held(self, module, device) -> "EmbeddingModel":
        return EmbeddingModel(module, self.name, device)

    @staticmethod
    def from_pretrained(model, use_hf_token=True, device="cuda", **kwargs) -> "EmbeddingModel":
        """A file, a registry name (``tpu/...``, with :meth:`from_registry`'s
        arguments) or a pyannote name (see the module docstring); ``dtype``
        also sets the compute dtype of a converted checkpoint or a model
        file (the parameters stay f32)."""
        name = str(model)
        if name.endswith(".onnx"):
            return EmbeddingModel.from_onnx(model)
        if _is_model_file(name):
            device = require_cuda(device)
            loader, staged = _staged(_Loader("file", name, "XVectorSincNet"))
            model = EmbeddingModel(None, name, device, loader=loader, staged=staged)
            return model if kwargs.get("dtype") is None else model.with_dtype(kwargs["dtype"])
        if name.endswith(TORCH_SUFFIXES):
            return EmbeddingModel.from_torch(model, dtype=kwargs.get("dtype"), device=device)
        if name.startswith("tpu/"):
            return EmbeddingModel.from_registry(name, device=device, **kwargs)
        return EmbeddingModel.from_pyannote(model, use_hf_token, device=device)

    @staticmethod
    def from_apply(
        trunk_fn: Callable, head_fn: Callable, sample_rate: int = 16000,
        embedding_dim: int = 512, device="cuda",
    ) -> "EmbeddingModel":
        """Wrap torch callables ``trunk(waveform (B, C, S)) -> frames`` and
        ``head(frames, weights (B, K, T)) -> (B, K, E)`` that run on
        ``device`` (they hold their own weights, so they take no
        ``params``)."""
        loader = _Loader("held", _EmbFn(trunk_fn, head_fn, embedding_dim, sample_rate))
        return EmbeddingModel(None, "apply", require_cuda(device), loader=loader)

    @staticmethod
    def from_registry(
        name: str, device="cuda", seed: Optional[int] = None, flax_params=None, **kwargs
    ) -> "EmbeddingModel":
        """The JAX registry's names, size arguments and defaults:
        ``tpu/xvector`` (embedding_dim 512), ``tpu/ecapa`` (embedding_dim 192,
        channels 512), ``tpu/resnet34`` (embedding_dim 256, base_channels
        32), ``tpu/titanet`` (embedding_dim 192, channels 1024) and
        ``tpu/xvect-sb`` (embedding_dim 512, num_mels 24, tdnn_specs); each
        also takes ``dtype``. The weights come from ``seed`` (a CRC of the
        name by default) or ``flax_params`` at the first load."""
        _check_registry("embedding", name, kwargs)
        device = require_cuda(device)
        loader = _Loader("registry", "embedding", name, seed, flax_params, kwargs)
        return EmbeddingModel(None, name, device, loader=loader)

    @staticmethod
    def from_torch(path, dtype=None, device="cuda") -> "EmbeddingModel":
        """A torch embedding checkpoint, converted (the layout is sniffed
        from its keys); ``dtype`` ("bf16"/"f32") sets the trunk's compute
        dtype, the parameters stay f32."""
        device = require_cuda(device)
        loader, staged = _staged(_Loader("torch_emb", str(path)))
        model = EmbeddingModel(None, str(path), device, loader=loader, staged=staged)
        return model if dtype is None else model.with_dtype(dtype)

    @staticmethod
    def from_pyannote(model, use_hf_token=True, device="cuda") -> "EmbeddingModel":
        """A pyannote model name, through ``pyannote.audio`` (raises
        ImportError without it)."""
        device = require_cuda(device)
        loader, staged = _staged(_Loader("pyannote_emb", model, use_hf_token))
        return EmbeddingModel(None, str(model), device, loader=loader, staged=staged)

    @staticmethod
    def from_onnx(model_path, input_names=None, output_name: str = "embedding") -> "EmbeddingModel":
        """An ONNX model on the host (needs ``onnxruntime``)."""
        loader, staged = _staged(_Loader("onnx", str(model_path), input_names or ["waveform", "weights"],
                                         output_name))
        return EmbeddingModel(None, str(model_path), "cpu", loader=loader, staged=staged)

    @property
    def embedding_dim(self) -> int:
        return getattr(self.module, "embedding_dim", 512)

    @property
    def fbank_ring_kind(self) -> Optional[str]:
        """The mel frontend kind the engine's frame ring computes, or None."""
        return getattr(self.module, "fbank_ring_kind", None)

    @property
    def num_mels(self) -> int:
        return self.module.num_mels

    @torch.no_grad()
    def __call__(self, waveform, weights=None):
        """diart's call: waveform (B, C, S), weights (B, frames) or None ->
        (B, dim)."""
        if self.host_only:
            return self.module(waveform, weights)
        frames = self.trunk(waveform)
        if weights is None:
            return self.head(frames)
        return self.head(frames, weights[:, None, :])[:, 0]

    @torch.no_grad()
    def trunk(self, waveform: torch.Tensor, **kwargs) -> torch.Tensor:
        """``kwargs`` go to the module's trunk (the engine's ``sinc_pooled``)."""
        return self.module.trunk(waveform, **kwargs)

    @torch.no_grad()
    def trunk_from_raw_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        return self.module.trunk_from_raw_fbank(raw)

    @torch.no_grad()
    def head(self, frames: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.module.head(frames, weights)
