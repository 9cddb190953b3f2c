"""Model wrappers and the registry (reduced port of
``diart_tpu/models/base.py``: the ``tpu/pyannet``, ``tpu/xvector`` and
``tpu/ecapa`` registry entries, under the JAX package's names, and
``from_apply`` for plain torch callables).

Weights come from a seeded ``torch.Generator`` (the seed defaults to a
CRC of the registry name) or, with ``flax_params=``, from the JAX
package's parameter tree through :func:`diart_tpu_torch.weights.load_flax_params`.
The wrappers default to ``device="cuda"`` and raise without a GPU.
"""

from __future__ import annotations

import zlib
from typing import Callable, Optional

import torch
from torch import nn

from ..ops._build import require_cuda
from .common import QuantizableConv
from .ecapa import EcapaTDNN
from .embedding import XVectorSincNet
from .lstm import BiLSTM
from .segmentation import PyanNet

__all__ = ["EmbeddingModel", "SegmentationModel", "init_weights"]


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


def _not_ported(kind: str, name: str):
    raise NotImplementedError(
        f"{kind} {name!r}: only the registry names (tpu/...) and from_apply are ported; "
        "loading files and pyannote models is ROADMAP.md Queue 1 item 4"
    )


class _SegFn:
    """The module of ``SegmentationModel.from_apply``: a torch callable
    ``waveform (B, C, S) -> (B, frames, K)``."""

    def __init__(self, fn: Callable, num_speakers: int, sample_rate: int):
        self._fn = fn
        self.num_speakers = num_speakers
        self.sample_rate = sample_rate

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        return self._fn(waveform)


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


def _build(module: nn.Module, name: str, device, seed: Optional[int], flax_params) -> nn.Module:
    if flax_params is not None:
        from ..weights import load_flax_params

        load_flax_params(module, flax_params)
    else:
        gen = torch.Generator().manual_seed(_seed_from_name(name) if seed is None else int(seed))
        init_weights(module, gen)
    return module.to(device).eval().requires_grad_(False)


class SegmentationModel:
    """waveform (B, 1, samples) -> activations (B, frames, speakers)."""

    KNOWN = ("tpu/pyannet",)

    def __init__(self, module, name: str, device):
        self.module = module
        self.name = name
        self.device = torch.device(device)

    @staticmethod
    def from_pretrained(
        model, use_hf_token=True, device="cuda", **kwargs
    ) -> "SegmentationModel":
        """A registry name (``tpu/...``, with :meth:`from_registry`'s
        arguments). Files and pyannote models are not ported yet."""
        name = str(model)
        if not name.startswith("tpu/"):
            _not_ported("segmentation model", name)
        return SegmentationModel.from_registry(name, device=device, **kwargs)

    @staticmethod
    def from_apply(
        apply_fn: Callable, sample_rate: int = 16000, num_speakers: int = 4, device="cuda"
    ) -> "SegmentationModel":
        """Wrap a torch callable ``waveform (B, C, S) -> (B, frames, K)`` that
        runs on ``device`` (it holds its own weights, so it takes no
        ``params``)."""
        return SegmentationModel(_SegFn(apply_fn, num_speakers, sample_rate), "apply",
                                 require_cuda(device))

    @staticmethod
    def from_registry(
        name: str, device="cuda", seed: Optional[int] = None, flax_params=None, **kwargs
    ) -> "SegmentationModel":
        """``tpu/pyannet`` with the JAX registry's size arguments
        (num_speakers, lstm_hidden, lstm_layers, linear_dims, dtype)."""
        if name not in SegmentationModel.KNOWN:
            raise ValueError(
                f"unknown segmentation registry name {name!r}; known: {list(SegmentationModel.KNOWN)}"
            )
        _check_kwargs(name, kwargs, ("num_speakers", "lstm_hidden", "lstm_layers", "linear_dims", "dtype"))
        device = require_cuda(device)
        module = PyanNet(
            num_speakers=kwargs.get("num_speakers", 4),
            lstm_hidden=kwargs.get("lstm_hidden", 128),
            lstm_layers=kwargs.get("lstm_layers", 4),
            linear_dims=tuple(kwargs.get("linear_dims", (128, 128))),
            compute_dtype=_dtype_kwarg(kwargs),
        )
        return SegmentationModel(_build(module, name, device, seed, flax_params), name, device)

    @property
    def num_speakers(self) -> int:
        return self.module.num_speakers

    @property
    def sample_rate(self) -> int:
        return self.module.sample_rate

    def num_frames(self, num_samples: int) -> int:
        return self.module.num_frames(num_samples)

    @torch.no_grad()
    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        return self.module(waveform)


class EmbeddingModel:
    """Waveform + per-speaker weights -> embeddings, with a trunk/head split.
    Mel models (``fbank_ring_kind`` not None) also take the engine's raw
    log-mel frames through :meth:`trunk_from_raw_fbank`."""

    KNOWN = ("tpu/ecapa", "tpu/xvector")

    def __init__(self, module, name: str, device):
        self.module = module
        self.name = name
        self.device = torch.device(device)

    @staticmethod
    def from_pretrained(model, use_hf_token=True, device="cuda", **kwargs) -> "EmbeddingModel":
        """A registry name (``tpu/...``, with :meth:`from_registry`'s
        arguments). Files and pyannote models are not ported yet."""
        name = str(model)
        if not name.startswith("tpu/"):
            _not_ported("embedding model", name)
        return EmbeddingModel.from_registry(name, device=device, **kwargs)

    @staticmethod
    def from_apply(
        trunk_fn: Callable, head_fn: Callable, sample_rate: int = 16000,
        embedding_dim: int = 512, device="cuda",
    ) -> "EmbeddingModel":
        """Wrap torch callables ``trunk(waveform (B, C, S)) -> frames`` and
        ``head(frames, weights (B, K, T)) -> (B, K, E)`` that run on
        ``device`` (they hold their own weights, so they take no
        ``params``)."""
        return EmbeddingModel(_EmbFn(trunk_fn, head_fn, embedding_dim, sample_rate), "apply",
                              require_cuda(device))

    @staticmethod
    def from_registry(
        name: str, device="cuda", seed: Optional[int] = None, flax_params=None, **kwargs
    ) -> "EmbeddingModel":
        """``tpu/xvector`` (embedding_dim, dtype) or ``tpu/ecapa``
        (embedding_dim, channels, dtype), with the JAX registry's size
        arguments and defaults."""
        if name not in EmbeddingModel.KNOWN:
            raise ValueError(
                f"unknown embedding registry name {name!r}; known: {list(EmbeddingModel.KNOWN)}"
            )
        ecapa = name == "tpu/ecapa"
        _check_kwargs(name, kwargs, ("embedding_dim", "dtype") + (("channels",) if ecapa else ()))
        device = require_cuda(device)
        if ecapa:
            module = EcapaTDNN(
                embedding_dim=kwargs.get("embedding_dim", 192),
                channels=kwargs.get("channels", 512),
                compute_dtype=_dtype_kwarg(kwargs),
            )
        else:
            module = XVectorSincNet(
                embedding_dim=kwargs.get("embedding_dim", 512), compute_dtype=_dtype_kwarg(kwargs)
            )
        return EmbeddingModel(_build(module, name, device, seed, flax_params), name, device)

    @property
    def embedding_dim(self) -> int:
        return self.module.embedding_dim

    @property
    def sample_rate(self) -> int:
        return self.module.sample_rate

    @property
    def fbank_ring_kind(self) -> Optional[str]:
        """The mel frontend kind the engine's frame ring computes, or None."""
        return getattr(self.module, "fbank_ring_kind", None)

    @property
    def num_mels(self) -> int:
        return self.module.num_mels

    @torch.no_grad()
    def __call__(self, waveform: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """diart's call: waveform (B, C, S), weights (B, frames) or None ->
        (B, dim)."""
        frames = self.trunk(waveform)
        if weights is None:
            return self.head(frames)
        return self.head(frames, weights[:, None, :])[:, 0]

    @torch.no_grad()
    def trunk(self, waveform: torch.Tensor) -> torch.Tensor:
        return self.module.trunk(waveform)

    @torch.no_grad()
    def trunk_from_raw_fbank(self, raw: torch.Tensor) -> torch.Tensor:
        return self.module.trunk_from_raw_fbank(raw)

    @torch.no_grad()
    def head(self, frames: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.module.head(frames, weights)
