"""Building blocks shared by the embedding models (port of the parts of
``diart_tpu/models/common.py`` the x-vector and ECAPA paths use)."""

from __future__ import annotations

from typing import Callable, Hashable, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import precision as precision_policy
from ..ops import _numerics
from ..ops._grad import wants_grad
from ..ops.attn_stats import fused_attentive_stats, prepare_attn_operands
from ..ops.functional import reflect_index
from ..ops.quant import int8_conv, prepare_int8_operands

__all__ = [
    "InferenceBatchNorm",
    "QuantizableConv",
    "attentive_stats_pool",
    "held_operands",
    "int8_trunk_enabled",
    "reflect_pad_time",
    "resample_weights",
]


def held_operands(owner, tag: Hashable, params: Iterable[torch.Tensor], make: Callable):
    """The kernel operands ``make()`` lays out of ``params``, held by
    ``owner`` under ``tag`` and made again only when one of ``params``
    changes: an in-place update, a load or a move to another device (each
    is keyed on its ``data_ptr``, ``_version`` and device). None where
    autograd trains any of ``params`` in this call: held operands are cut
    off from autograd, so the caller then passes the raw parameters.

    The owner's one store is a plain dict attribute made at first use, so
    it is in no ``state_dict()``, ``named_parameters()`` or
    ``named_buffers()``."""
    params = tuple(params)
    if wants_grad(*params):
        return None
    key = tuple((p.data_ptr(), p._version, p.device) for p in params)
    store = vars(owner).setdefault("_held_operands", {})
    held = store.get(tag)
    if held is None or held[0] != key:
        with torch.no_grad():
            held = store[tag] = (key, make())
    return held[1]


def reflect_pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the time axis of a (B, T, C) activation, as speechbrain's
    ``Conv1d`` pads 'same' (``padding_mode="reflect"``)."""
    if pad == 0:
        return x
    t = x.shape[1]
    return x.index_select(1, reflect_index(t, -pad, t + pad, x.device))


def resample_weights(weights: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Nearest-neighbour resample of per-frame weights (..., src) to the
    trunk's frame grid (pyannote's StatsPool interpolates the same way)."""
    src = weights.shape[-1]
    if src == num_frames:
        return weights
    idx = torch.arange(num_frames, device=weights.device) * src // num_frames
    return weights.index_select(-1, idx)


def int8_trunk_enabled(device) -> bool:
    """Whether the dynamic int8 trunk (``ops/quant.py``) applies to tensors
    on ``device``: off by default (it changes the embeddings), on with
    ``Precision(int8_trunk=True)`` or ``DIART_TPU_INT8_TRUNK=1``."""
    return precision_policy.enabled("int8_trunk", device)


class QuantizableConv(nn.Module):
    """Unpadded 1-D or 2-D convolution over (batch, channels, time[, freq]),
    run in ``compute_dtype``; the bias, where there is one, is added in that
    dtype after the convolution, as the JAX module does. ``kernel_size`` is
    an int (1-D) or a pair (2-D); ``groups`` makes a depthwise convolution
    (TitaNet's).

    With the ``int8_trunk`` switch on, a ``quantizable`` convolution runs as
    the dynamic int8 convolution (:func:`diart_tpu_torch.ops.quant.int8_conv`)
    with its weights quantized once and held (:func:`held_operands`).
    ``quantizable=False`` marks the convolutions that are a plain
    ``nn.Conv`` in the JAX package (TitaNet's depthwise one, ResNet34's
    stem), which stay in ``compute_dtype`` under the switch. In f32 the
    plain route is true f32 on the card whatever torch's TF32 switches say
    (:func:`diart_tpu_torch.ops._numerics.conv_scope`)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size,
        dilation: int = 1,
        compute_dtype=torch.float32,
        bias: bool = True,
        stride: int = 1,
        padding=0,
        groups: int = 1,
        quantizable: bool = True,
    ):
        super().__init__()
        if quantizable and groups != 1:
            raise ValueError("a grouped convolution is not quantizable")
        kernel = tuple(kernel_size) if isinstance(kernel_size, (tuple, list)) else (kernel_size,)
        self.dilation = dilation
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.quantizable = quantizable
        self.compute_dtype = compute_dtype
        self._conv = F.conv2d if len(kernel) == 2 else F.conv1d
        self.weight = nn.Parameter(torch.zeros(features, in_channels // groups, *kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def int8(self, x: torch.Tensor) -> bool:
        """Whether a call on ``x`` takes the int8 path."""
        return self.quantizable and int8_trunk_enabled(x.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.int8(x):
            params = [p for p in (self.weight, self.bias) if p is not None]
            ops = held_operands(self, "int8", params, lambda: prepare_int8_operands(self.weight, self.bias))
            return int8_conv(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                             dt, operands=ops)
        with _numerics.conv_scope(x.device, dt):
            y = self._conv(x.to(dt), self.weight.to(dt), stride=self.stride, padding=self.padding,
                           dilation=self.dilation, groups=self.groups)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).view((1, -1) + (1,) * (y.dim() - 2))


class InferenceBatchNorm(nn.Module):
    """Inference-form batch norm with running statistics held as parameters;
    the affine is folded in f32 and applied in the input's dtype. Channels
    lie on ``channel_dim``: 1 for (batch, channels, time), -1 for the ECAPA
    family's (batch, time, channels)."""

    def __init__(self, features: int, channel_dim: int = 1):
        super().__init__()
        self.channel_dim = channel_dim
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def folded(self):
        """(a, b) with ``norm(x) == x * a + b``, both f32 (C,)."""
        a = self.scale * torch.rsqrt(self.var + 1e-5)
        return a, self.bias - self.mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.folded()
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


def attentive_stats_pool(
    frames: torch.Tensor,
    weights: Optional[torch.Tensor],
    att_local: nn.Linear,
    att_global: nn.Linear,
    att_bn: InferenceBatchNorm,
    att_scores: nn.Linear,
) -> Tuple[torch.Tensor, bool]:
    """External-weight-aware channel-attentive statistics pooling (the ECAPA
    head): attention over ``[x; global mean; global std]`` once per chunk,
    then per-speaker pooling where the frame weights re-normalize the shared
    attention. The softmax and the three moments run in
    :func:`fused_attentive_stats` (the hand-written kernel on a CUDA tensor),
    so the (B, T, C) logits never reach memory, with ``att_scores``'s
    weights laid out for it once and held (:func:`held_operands`).

    frames (B, T, C); weights (B, S, Tw) or None -> (pooled (B, S, 2C) f32,
    squeeze), ``squeeze`` telling the caller the speaker axis was made up."""
    squeeze = weights is None
    if weights is None:
        weights = torch.ones(frames.shape[0], 1, frames.shape[1], device=frames.device)
    weights = resample_weights(weights, frames.shape[1]).float()
    f32 = frames.float()
    gmean = f32.mean(dim=1, keepdim=True)
    gvar = ((f32 - gmean) ** 2).mean(dim=1, keepdim=True)
    gstd = torch.sqrt(torch.clamp(gvar, min=1e-12))
    hidden = att_local(f32) + att_global(torch.cat([gmean, gstd], dim=-1))
    hidden = torch.tanh(att_bn(torch.relu(hidden)))  # (B, T, bottleneck)
    ops = held_operands(att_scores, "attn_stats", att_scores.parameters(),
                        lambda: prepare_attn_operands(att_scores.weight.t(), att_scores.bias))
    raw = (att_scores.weight.t(), att_scores.bias) if ops is None else (None, None)
    den, s1, s2 = fused_attentive_stats(frames, hidden, *raw, weights, operands=ops)
    den = torch.clamp(den, min=1e-12)
    mu = s1 / den
    var = s2 / den - mu**2
    sg = torch.sqrt(torch.clamp(var, min=1e-12))
    return torch.cat([mu, sg], dim=-1), squeeze
