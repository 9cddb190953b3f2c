"""Dynamic int8 convolution for the embedding trunks (port of
``diart_tpu/ops/quant.py``).

Dynamic symmetric quantization, as the JAX module: activations get one
scale per sample (``s_x = max(max|x|, 1e-12) / 127``), weights one scale per
output channel, both rounded half to even and clipped to [-127, 127]; the
products accumulate exactly in int32 and are dequantized with
``float(acc) * (s_x * s_w)`` in f32, rounded to the output dtype, and the
bias (where there is one) is added in that dtype. The exact f32 parameters
stay the source of truth; the weights' int8 copy is made once per model
and held (:func:`prepare_int8_operands`), as XLA folds it at trace time.

On a CUDA tensor :func:`int8_conv` launches the hand-written kernels of
``csrc/int8_conv.cu`` (``absmax_rows`` and ``quantize_rows``, then the s8
``wgmma`` implicit-GEMM convolution, fed by TMA, with the dequantize
epilogue fused); on a CPU tensor it runs the plain version: the same f32
quantizers and an exact float64 convolution of the int8 values (|sum| <=
127^2 * K, far below 2^53). There is no fallback between the two.

The kernel's operands lay the reduction out as taps x C_pad: C_pad is
C_in rounded up to 32 and zero-filled, in the weight rows (C_out, k1 * k2 *
C_pad) of :func:`prepare_int8_operands` and the channels-last activations
(B, S, C_pad) of :func:`quantize_rows` alike, so that one tap's slice of
either is one dense box of the tensor memory accelerator. How a launch
tiles the output is :func:`conv_plan`'s choice.

The gradient is the straight-through estimator (:class:`Int8ConvFunction`,
the JAX module's ``custom_vjp``): the backward is the exact f32
convolution's VJP at the unquantized operands, on every device — rounding
has no gradient to differentiate.

Layouts are the port's: x (B, C_in, S1[, S2]) and weight (C_out, C_in, k1[,
k2]) as ``torch.nn.functional.conv1d`` / ``conv2d`` take them, with
symmetric padding, a stride and a kernel dilation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._grad import plain_vjp, refuse_trained_operands, wants_grad
from ._numerics import true_f32

__all__ = [
    "ConvPlan",
    "Int8ConvFunction",
    "Int8Operands",
    "conv_plan",
    "int8_accumulate",
    "int8_conv",
    "int8_conv_accumulators",
    "int8_conv_reference",
    "padded_channels",
    "prepare_int8_operands",
    "quantize_per_sample",
    "quantize_rows",
    "quantize_weight",
]

_EPS = 1e-12
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
K_ALIGN = 32  # each tap's input channels are padded to this in the kernel's operands
TILE_N = (80, 128, 160)  # the kernel's positions a warpgroup (its wgmma N)
BOX_MAX = 256  # elements a tensor-memory box traverses along one axis, at most
TILE_COST = 32  # a tile's fixed work (barriers, descriptors, epilogue set-up) in positions


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` correctly rounded on every device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which differs
    from JAX's division in the last bit now and then; a tensor divisor is
    divided."""
    return amax / torch.full_like(amax, 127.0)


def quantize_per_sample(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, ...) float -> (q int8 of x's shape, scale (B, 1, ..., 1) f32)
    with ``x ~ q * scale``."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    scale = _div127(torch.clamp(amax, min=_EPS))
    return torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (C_out, ...) -> (q int8 of w's shape, scale (C_out,) f32): one
    scale per OUTPUT channel, the leading axis of a torch convolution weight
    (the JAX module's trailing axis)."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, w.dim())))
    scale = _div127(torch.clamp(amax, min=_EPS))
    view = (-1,) + (1,) * (w.dim() - 1)
    return torch.clamp(torch.round(wf / scale.view(view)), -127.0, 127.0).to(torch.int8), scale


def _conv_fn(dims: int):
    return F.conv2d if dims == 2 else F.conv1d


def int8_accumulate(q_x, q_w, stride=1, padding=0, dilation=1) -> torch.Tensor:
    """The exact int32 convolution of int8 ``q_x`` (B, C_in, S...) and
    ``q_w`` (C_out, C_in, k...): a float64 convolution of the integer
    values, exact while |sum| < 2^53."""
    acc = _conv_fn(q_w.dim() - 2)(q_x.double(), q_w.double(), stride=stride, padding=padding,
                                 dilation=dilation)
    return acc.to(torch.int32)


def _dequantize(acc, s_x, s_w, out_dtype, bias):
    """JAX's epilogue order: ``(f32(acc) * (s_x * s_w)).astype(out)``, then
    ``+ bias.astype(out)``."""
    view = (1, -1) + (1,) * (acc.dim() - 2)
    y = (acc.float() * (s_x.float().view((-1,) + (1,) * (acc.dim() - 1)) * s_w.view(view)))
    y = y.to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype).view(view)


def int8_conv_reference(x, weight, bias=None, stride=1, padding=0, dilation=1,
                        out_dtype=torch.float32):
    """Plain version of :func:`int8_conv` (any device): the JAX module's f32
    quantizers, the exact int32 accumulation and its epilogue."""
    q_x, s_x = quantize_per_sample(x)
    q_w, s_w = quantize_weight(weight)
    acc = int8_accumulate(q_x, q_w, stride, padding, dilation)
    return _dequantize(acc, s_x, s_w, out_dtype, bias)


def _f32_conv(x, weight, stride, padding, dilation, out_dtype):
    """The straight-through backward's forward: the exact f32 convolution,
    rounded to the output dtype (the JAX module's ``f32_conv``); its
    caller runs it in true f32 (:func:`true_f32`)."""
    return _conv_fn(weight.dim() - 2)(
        x.float(), weight.float(), stride=stride, padding=padding, dilation=dilation
    ).to(out_dtype)


def padded_channels(channels: int) -> int:
    """C_pad: ``channels`` rounded up to a multiple of 32."""
    return -(-channels // K_ALIGN) * K_ALIGN


class Int8Operands(NamedTuple):
    """A convolution's weights laid out for the kernel, made once per model
    (:func:`prepare_int8_operands`): ``q_w`` (C_out, k1 * k2 * C_pad) int8,
    the reduction ordered as taps (k1, k2) x C_pad channels, each tap's
    channels past ``in_channels`` zero; ``s_w`` (C_out,) f32, ``bias``
    (C_out,) f32 or None, the window ``kernel`` (k1, k2) and
    ``in_channels``."""

    q_w: torch.Tensor
    s_w: torch.Tensor
    bias: Optional[torch.Tensor]
    kernel: Tuple[int, int]
    in_channels: int


def prepare_int8_operands(weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> Int8Operands:
    """Quantize ``weight`` (C_out, C_in, k1[, k2]) per output channel and lay
    it out for the kernel; ``bias`` (C_out,) as contiguous f32."""
    if weight.dim() not in (3, 4):
        raise ValueError(f"weight must be (C_out, C_in, k1[, k2]); got {tuple(weight.shape)}")
    q_w, s_w = quantize_weight(weight)
    c_out, c_in = weight.shape[:2]
    kernel = tuple(weight.shape[2:]) + (1,) * (4 - weight.dim())
    taps = q_w.view(c_out, c_in, *kernel).permute(0, 2, 3, 1)  # (C_out, k1, k2, C_in)
    rows = F.pad(taps, (0, padded_channels(c_in) - c_in)).reshape(c_out, -1).contiguous()
    b = None if bias is None else bias.float().contiguous()
    return Int8Operands(rows, s_w.contiguous(), b, kernel, int(c_in))


def _pairs(value, dims: int) -> Tuple[int, int]:
    """An int or a sequence as (first, second) spatial values; the second
    is 1 (stride, dilation) or 0 (padding) for a 1-D convolution."""
    seq = tuple(value) if isinstance(value, (tuple, list)) else (value,) * dims
    if len(seq) != dims:
        raise ValueError(f"expected {dims} spatial values; got {seq}")
    return tuple(int(v) for v in seq)


def _signature(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_conv_quantize.argtypes = [p, i, i, i, i, i, ll, ll, ll, p, p, p, p]
    lib.int8_conv_quantize.restype = i
    lib.int8_conv_launch.argtypes = [p, p, p, p, p, p] + [i] * 22 + [p]
    lib.int8_conv_launch.restype = i


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, C, S...) f32 or bf16 -> (q (B, S1*S2.., C_pad) int8
    channels-last, scale (B,) f32): :func:`quantize_per_sample` with the
    values laid out for the convolution kernel, channels C .. C_pad - 1
    zero (:func:`padded_channels`). A CUDA tensor launches the kernels'
    quantizer (``absmax_rows``, then ``quantize_rows``); a CPU tensor runs
    the plain version."""
    if x.dim() < 3:
        raise ValueError(f"x must be (B, C, S...); got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    chans = x.shape[1]
    c_pad = padded_channels(chans)
    if x.device.type == "cpu":
        q, scale = quantize_per_sample(x)
        q = F.pad(q.flatten(2).transpose(1, 2), (0, c_pad - chans))
        return q.contiguous(), scale.view(-1)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xf = x.flatten(2)
    batch, _, spatial = xf.shape
    q = torch.empty(batch, spatial, c_pad, dtype=torch.int8, device=x.device)
    scale = torch.empty(batch, device=x.device)
    amax = torch.empty(batch, dtype=torch.int32, device=x.device)  # the kernels' scratch
    lib = _build.library("int8_conv", _signature)
    sb, sc, ss = xf.stride()
    with torch.cuda.device(x.device):
        err = lib.int8_conv_quantize(
            xf.data_ptr(), _DTYPES[x.dtype], batch, chans, spatial, c_pad, sb, sc, ss,
            amax.data_ptr(), q.data_ptr(), scale.data_ptr(), _build.stream_handle(x.device),
        )
    _build.check(lib, "int8_conv", err)
    return q, scale


def _out_len(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


class ConvPlan(NamedTuple):
    """How the kernel tiles one convolution (:func:`conv_plan`): ``n``
    positions a warpgroup (its ``wgmma`` N) as a box of ``box1`` output rows
    x ``box2`` output columns, ``mw`` warpgroups along the output channels
    (2: a 128 x n tile; 1: C_out <= 64, a 64 x 2n tile), the K slice ``bk``
    (32, 64 or 128 bytes: the TMA box's row and swizzle), and the tiles
    along C_out, O1 and O2 of one sample."""

    n: int
    mw: int
    box1: int
    box2: int
    bk: int
    tiles: Tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def conv_plan(c_out: int, o1: int, o2: int, stride1: int, stride2: int, c_pad: int) -> ConvPlan:
    """The tiling of a launch: the ``n`` of :data:`TILE_N` and its box
    (``box1 * box2 == n``, each box axis traversing at most
    :data:`BOX_MAX` input elements at its stride) of the least cost, a
    tile's positions (padding included) plus :data:`TILE_COST` for its
    fixed work; on a tie the larger ``n``, then the wider ``box2`` (whole
    output rows). A 1-D convolution (``o2 == 1``) is a column of ``n``
    rows."""
    mw = 1 if c_out <= 64 else 2
    nw = 2 // mw
    best = None
    for n in TILE_N:
        for box2 in (d for d in range(1, n + 1) if n % d == 0) if o2 > 1 else (1,):
            box1 = n // box2
            if box1 * stride1 > BOX_MAX or box2 * stride2 > BOX_MAX:
                continue
            t1, t2 = -(-o1 // (box1 * nw)), -(-o2 // box2)
            key = (t1 * t2 * (n * nw + TILE_COST), -n, -box2)
            if best is None or key < best[0]:
                best = (key, ConvPlan(n, mw, box1, box2, 0, (-(-c_out // (64 * mw)), t1, t2)))
    if best is None:
        raise ValueError(f"no tile of the kernel fits strides ({stride1}, {stride2})")
    bk = next(b for b in (128, 64, 32) if c_pad % b == 0)
    return best[1]._replace(bk=bk)


_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _launch(x, ops: Int8Operands, stride, padding, dilation, out_dtype, bias: bool):
    """Launch ``quantize_rows`` and the convolution on CUDA tensors; an
    int32 ``out_dtype`` gives the accumulators themselves."""
    dims = x.dim() - 2
    (s1, s2), (p1, p2), (d1, d2) = (
        tuple(v) + (default,) * (2 - dims)
        for v, default in ((stride, 1), (padding, 0), (dilation, 1))
    )
    batch = x.shape[0]
    size1, size2 = tuple(x.shape[2:]) + (1,) * (2 - dims)
    k1, k2 = ops.kernel
    o1, o2 = _out_len(size1, k1, s1, p1, d1), _out_len(size2, k2, s2, p2, d2)
    if o1 < 1 or o2 < 1:
        raise ValueError(f"input {tuple(x.shape)} is shorter than the window {ops.kernel}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32, bfloat16 or int32; got {out_dtype}")
    c_pad = ops.q_w.shape[1] // (k1 * k2)
    c_out = ops.q_w.shape[0]
    plan = conv_plan(c_out, o1, o2, s1, s2, c_pad)
    q_x, s_x = quantize_rows(x)
    shape = (batch, c_out, o1, o2) if dims == 2 else (batch, c_out, o1)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    lib = _build.library("int8_conv", _signature)
    with torch.cuda.device(x.device):
        err = lib.int8_conv_launch(
            q_x.data_ptr(), ops.q_w.data_ptr(), s_x.data_ptr(), ops.s_w.data_ptr(),
            ops.bias.data_ptr() if bias else None, out.data_ptr(), _OUT_DTYPES[out_dtype], batch,
            c_pad, size1, size2, c_out, o1, o2, k1, k2, s1, s2, p1, p2, d1, d2, plan.n, plan.mw,
            plan.box1, plan.box2, plan.bk, _build.num_sms(x.device), _build.stream_handle(x.device),
        )
    _build.check(lib, "int8_conv", err)
    int8_conv.launches += 1
    return out


def _check(x, weight, ops: Optional[Int8Operands]) -> None:
    if x.dim() not in (3, 4) or weight.dim() != x.dim():
        raise ValueError(
            f"x must be (B, C_in, S1[, S2]) and weight (C_out, C_in, k1[, k2]); "
            f"got {tuple(x.shape)} and {tuple(weight.shape)}"
        )
    if weight.shape[1] != x.shape[1]:
        raise ValueError(f"weight takes {weight.shape[1]} input channels; x has {x.shape[1]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if weight.device != x.device or (ops is not None and ops.q_w.device != x.device):
        raise ValueError("x, the weight and its operands must be on the same device")
    if ops is not None and (ops.in_channels, ops.q_w.shape[0]) != tuple(weight.shape[1::-1]):
        raise ValueError("the prepared operands are another convolution's")


class Int8ConvFunction(torch.autograd.Function):
    """The int8 convolution with the straight-through gradient (the JAX
    module's ``custom_vjp``): the forward is :func:`int8_conv` without the
    bias (the kernel on CUDA tensors, the plain version on CPU tensors), the
    backward autograd through the exact f32 convolution at the saved,
    unquantized ``x`` and ``weight``."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, dilation, out_dtype):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, dilation, out_dtype)
        if x.device.type == "cpu":
            return int8_conv_reference(x, weight, None, stride, padding, dilation, out_dtype)
        return _launch(x, prepare_int8_operands(weight), stride, padding, dilation, out_dtype, False)

    @staticmethod
    def backward(ctx, grad):
        ref = lambda x, w: _f32_conv(x, w, *ctx.conv)
        with true_f32(grad.device):
            return (*plain_vjp(ctx, ref, (grad,)), None, None, None, None)


def int8_conv(x, weight, bias=None, stride=1, padding=0, dilation=1, out_dtype=torch.float32,
              operands: Optional[Int8Operands] = None):
    """Dynamically quantized convolution: x (B, C_in, S1[, S2]) f32 or bf16
    in, (B, C_out, O1[, O2]) ``out_dtype`` out, s8 x s8 -> s32 inside.
    ``stride``, ``padding`` (symmetric, zeros) and ``dilation`` are an int
    or one value a spatial axis. ``operands`` is ``(weight, bias)`` prepared
    by :func:`prepare_int8_operands`, where the caller holds it.

    Under autograd (grad mode and a tensor that requires a gradient) the
    call is :class:`Int8ConvFunction` plus the bias in ``out_dtype``, on
    every device: the straight-through gradient."""
    refuse_trained_operands(operands)
    _check(x, weight, operands)
    dims = x.dim() - 2
    stride, padding, dilation = (_pairs(v, dims) for v in (stride, padding, dilation))
    if wants_grad(x, weight, bias):
        y = Int8ConvFunction.apply(x, weight, stride, padding, dilation, out_dtype)
        if bias is None:
            return y
        return y + bias.to(out_dtype).view((1, -1) + (1,) * dims)
    if x.device.type == "cpu":
        return int8_conv_reference(x, weight, bias, stride, padding, dilation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if operands is None:
        operands = prepare_int8_operands(weight, bias)
    elif (operands.bias is None) != (bias is None):
        raise ValueError("the prepared operands and the call disagree on the bias")
    return _launch(x, operands, stride, padding, dilation, out_dtype, bias is not None)


int8_conv.launches = 0


def int8_conv_accumulators(x, weight, stride=1, padding=0, dilation=1,
                           operands: Optional[Int8Operands] = None) -> torch.Tensor:
    """The int32 sums of :func:`int8_conv` (B, C_out, O1[, O2]): on a CUDA
    tensor the kernels with the epilogue skipped, on a CPU tensor the plain
    version's :func:`int8_accumulate`. For checks: the sums are exact, so
    the two agree bit for bit."""
    refuse_trained_operands(operands)
    _check(x, weight, operands)
    dims = x.dim() - 2
    stride, padding, dilation = (_pairs(v, dims) for v in (stride, padding, dilation))
    if x.device.type == "cpu":
        return int8_accumulate(quantize_per_sample(x)[0], quantize_weight(weight)[0], stride, padding,
                               dilation)
    if operands is None:
        operands = prepare_int8_operands(weight)
    return _launch(x, operands, stride, padding, dilation, torch.int32, False)
