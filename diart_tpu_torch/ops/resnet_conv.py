"""ResNet34's trunk convolutions in one launch each: a 2-D convolution of
channels-last activations with the folded batch norm, optionally the
residual add, and optionally ReLU in its epilogue.

``resnet_conv(x, weight, scale, shift, ...)`` computes, on x (B, T, F,
C_in) laid out channels-last (the JAX package's layout of the trunk),

    relu?(conv2d(x, weight) * scale + shift + residual)    -> (B, T', F', C_out)

with every step rounded to the compute dtype where PyTorch's separate ops
round it: the convolution's output, ``* scale``, ``+ shift``, ``+
residual``. ``(scale, shift)`` is ``InferenceBatchNorm.folded()``.

The plain version is the composition ``models/resnet.py`` runs on NCHW
tensors (``QuantizableConv`` -> ``InferenceBatchNorm`` -> add -> ReLU), on
the NCHW view of x, and a CPU tensor runs it. A CUDA tensor launches the
hand-written kernels of ``csrc/resnet_conv.cu``, which write the output
once, channels-last, in bf16: implicit GEMM on the tensor cores for C_in a
multiple of 8 (for the 3x3 windows at stride 1 ``resnet_conv_pingpong`` up
to 64 channels and ``resnet_conv_halo`` above, each tile's input read once
with its border; ``resnet_conv_taps`` for the others, each tap's input read
at the stride), ``resnet_stem`` (the CUDA cores) for the one-channel stem;
there is no fallback between the plain version and the kernels. The kernel takes bf16 activations (the stem also its f32
features, which it rounds to bf16 as the plain version does), channel
counts that are multiples of 8, contiguous (B, T, F, C) tensors and no
gradient; it raises on anything else.

The weights and the norm are laid out for the kernel once per model and
held (:func:`prepare_conv_operands`): the weights as rows (C_out, k1 * k2
* C_pad), the reduction ordered as taps x C_pad channels (C_in rounded up
to 16, zero-filled), so that a tap's channel slice of the weights and of
the activations is one dense box of the tensor memory accelerator; the
norm's scale and shift rounded to bf16. How a launch tiles the output is
:func:`conv_plan`'s choice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, _numerics
from ._grad import refuse_trained_operands, wants_grad

__all__ = [
    "ConvOperands",
    "ConvPlan",
    "conv_plan",
    "prepare_conv_operands",
    "resnet_conv",
    "resnet_conv_reference",
]

C_ALIGN = 16  # each tap's input channels are padded to this in the kernel's weight rows
ROWS = 64  # output positions a consumer warpgroup (its wgmma M); two a block
TILE_N = (16, 32, 64, 128, 256)  # output channels a tile (its wgmma N)
BOX_MAX = 256  # elements a tensor-memory box traverses along one axis, at most
TILE_COST = 16  # a tile's fixed work (barriers, descriptors, epilogue set-up) in positions
RING_BYTES = 200 * 1024  # the shared memory a block's ring and halo buffers take, at most
STEM_KERNEL = (3, 3)  # the CUDA-core route's window (padding 1, stride 1)


def _pairs(value) -> Tuple[int, int]:
    seq = tuple(value) if isinstance(value, (tuple, list)) else (value, value)
    if len(seq) != 2:
        raise ValueError(f"expected one value or two; got {seq}")
    return int(seq[0]), int(seq[1])


def _out_len(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet_conv_reference(x, weight, scale, shift, stride=1, padding=0, residual=None, relu=True,
                          dtype=None):
    """Plain version of :func:`resnet_conv`: ``models/resnet.py``'s
    composition on the NCHW view of x (B, T, F, C_in), returned as (B, T',
    F', C_out) in ``dtype`` (default: x's). The convolution is
    ``QuantizableConv``'s (``conv2d`` in ``dtype``, true f32 on a card in
    f32), the norm ``InferenceBatchNorm``'s (``y * scale + shift``, both
    rounded to ``dtype``), then ``+ residual`` and ReLU."""
    dt = dtype or x.dtype
    nchw = x.to(dt).permute(0, 3, 1, 2).contiguous()
    with _numerics.conv_scope(x.device, dt):
        y = F.conv2d(nchw, weight.to(dt), stride=_pairs(stride), padding=_pairs(padding))
    y = y * scale.to(dt).view(1, -1, 1, 1) + shift.to(dt).view(1, -1, 1, 1)
    if residual is not None:
        y = y + residual.permute(0, 3, 1, 2)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


class ConvOperands(NamedTuple):
    """A convolution and its folded norm laid out for the kernel
    (:func:`prepare_conv_operands`). ``rows``: C_in > 1, (C_out, k1 * k2 *
    C_pad) bf16, taps (k1, k2) x C_pad channels, each tap's channels past
    ``in_channels`` zero; the one-channel stem, (C_out, k1 * k2) f32 holding
    the bf16 weights. ``scale``, ``shift``: (C_out,) the norm's, in bf16.
    ``kernel``: the window (k1, k2)."""

    rows: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    kernel: Tuple[int, int]
    in_channels: int


def padded_channels(channels: int) -> int:
    """C_pad: ``channels`` rounded up to a multiple of 16."""
    return -(-channels // C_ALIGN) * C_ALIGN


def prepare_conv_operands(weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> ConvOperands:
    """Lay ``weight`` (C_out, C_in, k1, k2) and the folded norm ``(scale,
    shift)`` (C_out,) out for the kernel, all rounded to bf16 as the plain
    version rounds them."""
    if weight.dim() != 4:
        raise ValueError(f"weight must be (C_out, C_in, k1, k2); got {tuple(weight.shape)}")
    c_out, c_in, k1, k2 = weight.shape
    if tuple(scale.shape) != (c_out,) or tuple(shift.shape) != (c_out,):
        raise ValueError(f"scale and shift must be ({c_out},); got {tuple(scale.shape)}, {tuple(shift.shape)}")
    w = weight.detach().to(torch.bfloat16)
    if c_in == 1:
        rows = w.float().reshape(c_out, k1 * k2)
    else:
        taps = w.permute(0, 2, 3, 1)  # (C_out, k1, k2, C_in)
        rows = F.pad(taps, (0, padded_channels(c_in) - c_in)).reshape(c_out, -1)
    bf16 = lambda v: v.detach().to(torch.bfloat16).contiguous()
    return ConvOperands(rows.contiguous(), bf16(scale), bf16(shift), (int(k1), int(k2)), int(c_in))


class ConvPlan(NamedTuple):
    """How the kernel tiles one convolution (:func:`conv_plan`): ``n``
    output channels a tile; boxes of 64 output positions, ``box1`` rows x
    ``box2`` columns, stacked along the rows, ``ms`` a warpgroup; the K slice
    ``bk`` (16, 32 or 64 channels: the TMA box's row of 2 bk bytes and its
    swizzle); ``c_pad``; the tiles along C_out, O1 and O2 of one sample;
    ``route``, one of :data:`ROUTES`: ``taps`` (each tap's input box read by
    TMA at the stride; both warpgroups on one tile), ``halo`` (a 3x3 window
    at stride 1: a tile's input read once a K slice with its one-position
    border, each tap's operand read out of it; both warpgroups on one tile)
    or ``pingpong`` (the halo route's reads with the nine taps' weights kept
    in shared memory, the warpgroups taking turns over the tiles, so one's
    epilogue runs under the other's products: one K slice and up to 64
    output channels)."""

    n: int
    box1: int
    box2: int
    bk: int
    c_pad: int
    tiles: Tuple[int, int, int]
    route: str
    ms: int

    @property
    def rows(self) -> int:
        """Output rows a tile: its boxes stacked along O1."""
        return (1 if self.route == "pingpong" else 2) * self.ms * self.box1


ROUTES = ("taps", "halo", "pingpong")


def _kbytes(n: int) -> int:
    """``n`` bytes rounded up to the 1024 that a swizzled tile starts on."""
    return -(-n // 1024) * 1024


def _fits(route: str, rows: int, box1: int, box2: int, stride, n: int, bk: int) -> bool:
    """Whether a box fits the route: the taps route's box axes traverse at
    most BOX_MAX input elements at their stride; a halo is at most BOX_MAX a
    side, and its buffers beside two stages of weights (the halo route) or
    the nine taps' weights (the ping-pong route) fit in RING_BYTES."""
    if route == "taps":
        return box1 * stride[0] <= BOX_MAX and box2 * stride[1] <= BOX_MAX
    halo, weights = _kbytes((rows + 2) * (box2 + 2) * 2 * bk), _kbytes(n * 2 * bk)
    if rows + 2 > BOX_MAX or box2 + 2 > BOX_MAX:
        return False
    if route == "halo":
        return 2 * halo + 2 * weights <= RING_BYTES
    return 4 * halo + 9 * weights <= RING_BYTES


@functools.lru_cache(maxsize=None)
def conv_plan(c_out: int, o1: int, o2: int, c_in: int, kernel: Tuple[int, int] = (3, 3),
              stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (1, 1)) -> ConvPlan:
    """The tiling of a launch. ``n``: the least of :data:`TILE_N` that holds
    C_out (256 and several tiles above it). ``bk``: the widest of 64, 32, 16
    that divides C_pad. The route: for a 3x3 window at stride 1 and padding
    1 the ping-pong route where C_pad is one K slice and ``n`` <= 64, else
    the halo route, with four boxes a warpgroup up to 32 channels a tile,
    two up to 128 and one at 256 (the sums' registers); any other window
    the taps route, one box a warpgroup. The box of the least cost (a
    tile's positions, padding included, plus :data:`TILE_COST` for its
    fixed work, over the tiles of a sample), on a tie the wider ``box2``,
    among those that fit (:func:`_fits`); a route that no box fits gives
    way to the next (ping-pong, halo)."""
    n = next((v for v in TILE_N if v >= c_out), TILE_N[-1])
    c_pad = padded_channels(c_in)
    bk = next(b for b in (64, 32, 16) if c_pad % b == 0)
    if tuple(kernel) == (3, 3) and tuple(stride) == (1, 1) and tuple(padding) == (1, 1):
        ms = 4 if n <= 32 else 2 if n <= 128 else 1
        routes = ("pingpong", "halo") if c_pad == bk and n <= 64 else ("halo",)
    else:
        ms, routes = 1, ("taps",)
    for route in routes:
        best = None
        for box2 in (1, 2, 4, 8, 16, 32, 64):
            box1 = ROWS // box2
            rows = (1 if route == "pingpong" else 2) * ms * box1
            if not _fits(route, rows, box1, box2, stride, n, bk):
                continue
            t1, t2 = -(-o1 // rows), -(-o2 // box2)
            key = (t1 * t2 * (rows * box2 + TILE_COST), -box2)
            if best is None or key < best[0]:
                best = (key, box1, box2, t1, t2)
        if best is not None:
            _, box1, box2, t1, t2 = best
            return ConvPlan(n, box1, box2, bk, c_pad, (-(-c_out // n), t1, t2), route, ms)
    raise ValueError(f"no tile of the kernel fits the window {kernel} at strides {stride}")


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resnet_conv_launch.argtypes = [p] * 6 + [i] * 22 + [p]
    lib.resnet_conv_launch.restype = i
    lib.resnet_stem_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p]
    lib.resnet_stem_launch.restype = i


def _check(x, weight, residual, stride, padding) -> Tuple[int, int]:
    """Shapes and devices of a call; returns the output's (O1, O2)."""
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"x must be (B, T, F, C_in) and weight (C_out, C_in, k1, k2); "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    if weight.shape[1] != x.shape[3]:
        raise ValueError(f"weight takes {weight.shape[1]} input channels; x has {x.shape[3]}")
    (s1, s2), (p1, p2) = stride, padding
    o1, o2 = _out_len(x.shape[1], weight.shape[2], s1, p1), _out_len(x.shape[2], weight.shape[3], s2, p2)
    if o1 < 1 or o2 < 1:
        raise ValueError(f"input {tuple(x.shape)} is smaller than the window {tuple(weight.shape[2:])}")
    if residual is not None and tuple(residual.shape) != (x.shape[0], o1, o2, weight.shape[0]):
        raise ValueError(f"residual must be {(x.shape[0], o1, o2, weight.shape[0])}; got {tuple(residual.shape)}")
    if any(t.device != x.device for t in (weight, residual) if t is not None):
        raise ValueError("x, the weight and the residual must be on the same device")
    return o1, o2


def _launch(x, ops: ConvOperands, stride, padding, residual, relu: bool, o1: int, o2: int):
    """Launch the kernel on CUDA tensors (checked by the caller)."""
    batch, size1, size2, c_in = x.shape
    c_out = ops.rows.shape[0]
    out = torch.empty(batch, o1, o2, c_out, dtype=torch.bfloat16, device=x.device)
    lib = _build.library("resnet_conv", _signature)
    stream = _build.stream_handle(x.device)
    if c_in == 1:
        err = lib.resnet_stem_launch(x.data_ptr(), int(x.dtype == torch.bfloat16), ops.rows.data_ptr(),
                                     ops.scale.data_ptr(), ops.shift.data_ptr(), out.data_ptr(), batch, size1,
                                     size2, c_out, int(relu), _build.num_sms(x.device), stream)
    else:
        (s1, s2), (p1, p2), (k1, k2) = stride, padding, ops.kernel
        plan = conv_plan(c_out, o1, o2, c_in, ops.kernel, stride, padding)
        err = lib.resnet_conv_launch(
            x.data_ptr(), ops.rows.data_ptr(), ops.scale.data_ptr(), ops.shift.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(), batch, c_in, size1, size2,
            c_out, o1, o2, k1, k2, s1, s2, p1, p2, plan.c_pad, plan.n, plan.box1, plan.box2, plan.bk,
            ROUTES.index(plan.route), plan.ms, int(relu), _build.num_sms(x.device), stream,
        )
    _build.check(lib, "resnet_conv", err)
    resnet_conv.launches += 1
    return out


def _refuse(x, weight, ops: ConvOperands, stride, padding, residual, dtype) -> Optional[str]:
    """Why the kernel does not take a call on CUDA tensors (None: it does)."""
    c_out, c_in = weight.shape[:2]
    if dtype != torch.bfloat16:
        return f"computes in bfloat16 only; asked for {dtype}"
    if wants_grad(x, weight, residual):
        return "has no backward: train through the plain composition"
    if x.dtype != torch.bfloat16 and not (c_in == 1 and x.dtype == torch.float32):
        return f"takes bfloat16 activations (the one-channel stem also float32); got {x.dtype}"
    if (c_in != 1 and c_in % 8) or c_out % 8:
        return f"takes channel counts that are multiples of 8; got {c_in} in, {c_out} out"
    if not x.is_contiguous() or x.data_ptr() % 16:
        return "takes channels-last activations: a contiguous, 16-byte aligned (B, T, F, C) tensor"
    if residual is not None and (residual.dtype != torch.bfloat16 or not residual.is_contiguous()
                                 or residual.data_ptr() % 16):
        return "takes a contiguous, 16-byte aligned bfloat16 (B, T', F', C_out) residual"
    if ops.rows.device != x.device or ops.in_channels != c_in or ops.rows.shape[0] != c_out:
        return "was handed another convolution's operands, or operands on another device"
    if c_in == 1 and (ops.kernel != STEM_KERNEL or stride != (1, 1) or padding != (1, 1)):
        return f"takes the one-channel stem as a 3x3 window, stride 1, padding 1; got {ops.kernel}, {stride}, {padding}"
    return None


def resnet_conv(x, weight, scale=None, shift=None, stride=1, padding=0, residual=None, relu=True, dtype=None,
                operands: Optional[ConvOperands] = None):
    """``relu?(conv2d(x, weight) * scale + shift + residual)`` on
    channels-last activations: x (B, T, F, C_in), weight (C_out, C_in, k1,
    k2), ``scale`` and ``shift`` (C_out,) the folded norm, ``residual`` (B,
    T', F', C_out) or None -> (B, T', F', C_out) in ``dtype`` (default:
    x's). ``stride`` and ``padding`` (zeros, symmetric) are an int or a
    pair. ``operands`` is ``prepare_conv_operands(weight, scale, shift)``,
    where the caller holds it; it carries ``scale`` and ``shift`` (rounded
    to bf16, as the kernel reads them), which may then be left out.

    A CPU tensor runs :func:`resnet_conv_reference`; a CUDA tensor launches
    the kernel (bf16 out) or raises where the kernel does not take the
    call."""
    refuse_trained_operands(operands)
    stride, padding = _pairs(stride), _pairs(padding)
    o1, o2 = _check(x, weight, residual, stride, padding)
    dtype = dtype or x.dtype
    if scale is None or shift is None:
        if operands is None:
            raise ValueError("give the folded norm's scale and shift, or the prepared operands")
        scale, shift = operands.scale, operands.shift
    if x.device.type == "cpu":
        return resnet_conv_reference(x, weight, scale, shift, stride, padding, residual, relu, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if operands is None:
        operands = prepare_conv_operands(weight, scale, shift)
    why = _refuse(x, weight, operands, stride, padding, residual, dtype)
    if why is not None:
        raise ValueError(f"resnet_conv's kernel {why}")
    return _launch(x, operands, stride, padding, residual, relu, o1, o2)


resnet_conv.launches = 0
