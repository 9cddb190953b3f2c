"""SincNet's first stage in one kernel: the stride-10 sinc convolution,
``|.|`` and max-pool(3), ``max_pool1d(|conv1d(wave, filters, bias,
stride)|, 3)``, with the pre-pool activation rounded to bf16 under
``bf16_frontend``.

The plain version is the composition the models ran before the kernel:
``frontend_pool(F.conv1d(...))`` in true f32 (``_numerics.true_f32``), and
a CPU tensor runs it. A CUDA tensor launches the hand-written kernel
``csrc/sinc_frontend.cu``, which writes only the pooled result; there is
no fallback between the two. The kernel folds each filter about its centre
tap, so it reads a filterbank laid out as ``sinc_filters`` lays one out
(the cosine half of the rows exactly symmetric, the sine half exactly
antisymmetric): :func:`prepare_sinc_operands` takes the left halves and the
centre taps of such a bank and nothing of the right halves, and the kernel
takes only those prepared operands: the caller's held ones
(``operands=``), else the raw bank's, prepared for the call. Under
autograd on a CUDA tensor the call is :class:`SincFrontendFunction`: the
kernel forward, autograd through the plain version backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import precision
from . import _build, _numerics
from ._grad import plain_vjp, refuse_trained_operands, wants_grad

__all__ = [
    "SincFrontendFunction",
    "SincOperands",
    "launch_plan",
    "prepare_sinc_operands",
    "sinc_frontend",
    "sinc_frontend_reference",
]

KERNEL_SIZE = 251  # the kernel's taps, stride and pool (SincNet's)
STRIDE = 10
POOL = 3
GROUP = 20  # filters a warp: 10 symmetric, then 10 antisymmetric
STEPS = 126  # pair steps laid out: the 125 pairs (k, 250 - k) and the centre tap
THREADS, WARPS, WARP_POOLED = 256, 8, 32  # a block; pooled frames a warp (one a lane)
BLOCKS_PER_SM = 2
GROUPS = (1, 2, 4, 8)  # groups of GROUP filters a block's 8 warps divide into


def sinc_frontend_reference(wave, filters, stride: int, bias=None):
    """Plain version: ``frontend_pool`` of the true-f32 convolution.
    wave (B, 1, S); filters (F, K); bias (F,) or None -> (B, F, T // 3) f32,
    T = (S - K) // stride + 1."""
    from ..models.sincnet import frontend_pool

    with _numerics.true_f32(wave.device):
        y = F.conv1d(wave.float(), filters[:, None, :], bias, stride=stride)
    return frontend_pool(y)


class SincOperands(NamedTuple):
    """A filterbank laid out for the kernel (:func:`prepare_sinc_operands`).
    ``filters`` (F, 251) and ``bias`` (F,) or None as given: the plain
    version's inputs, and autograd's. ``taps`` (F / 20, 126, 20) f32: per
    group of 10 symmetric and 10 antisymmetric rows, pair step k's
    coefficient of each (k < 125: tap k; k = 125: half the centre tap of a
    symmetric row, 0 of an antisymmetric one). ``rows`` (F / 20, 20) int32:
    the output row of each column; ``shift`` (F / 20, 20) f32: its bias (0
    where there is none)."""

    filters: torch.Tensor
    bias: Optional[torch.Tensor]
    taps: torch.Tensor
    rows: torch.Tensor
    shift: torch.Tensor


def prepare_sinc_operands(filters, bias=None, banks: int = 1) -> SincOperands:
    """Lay out ``banks`` filterbanks stacked in ``filters`` (F, 251), each as
    ``sinc_filters`` makes one: its first half of rows symmetric about the
    centre tap (the cosine filters), its second half antisymmetric (the
    sine filters, centre tap 0). Only the left halves and the centre taps
    are read; the kernel stands the mirror taps in for the right halves.
    ``bias`` (F,): added to each row's convolution (the stacked frontend's
    folded waveform norm)."""
    if filters.dim() != 2 or filters.shape[1] != KERNEL_SIZE:
        raise ValueError(f"filters must be (F, {KERNEL_SIZE}); got {tuple(filters.shape)}")
    count = filters.shape[0]
    if banks < 1 or count % (2 * banks) or count % GROUP or count // GROUP not in GROUPS:
        raise ValueError(f"the kernel takes {banks} bank(s) of sine/cosine pairs in "
                         f"{GROUPS} groups of {GROUP} filters; got F={count}")
    if bias is not None and tuple(bias.shape) != (count,):
        raise ValueError(f"bias must be ({count},); got {tuple(bias.shape)}")
    dev, groups, half = filters.device, count // GROUP, KERNEL_SIZE // 2
    per = torch.arange(count, device=dev, dtype=torch.int32).view(banks, 2, count // banks // 2)
    even, odd = per[:, 0].reshape(groups, GROUP // 2), per[:, 1].reshape(groups, GROUP // 2)
    f = filters.detach().float()
    taps = torch.zeros(groups, GROUP, STEPS, device=dev)
    taps[:, : GROUP // 2, :half] = f[even.long(), :half]
    taps[:, : GROUP // 2, half] = f[even.long(), half] * 0.5
    taps[:, GROUP // 2 :, :half] = f[odd.long(), :half]
    rows = torch.cat([even, odd], dim=1).contiguous()
    shift = torch.zeros(groups, GROUP, device=dev) if bias is None else bias.detach().float()[rows.long()]
    return SincOperands(filters, bias, taps.transpose(1, 2).contiguous(), rows, shift.contiguous())


def num_pooled(samples: int) -> int:
    """Pooled frames of ``samples`` (S >= 251)."""
    return ((samples - KERNEL_SIZE) // STRIDE + 1) // POOL


def launch_plan(batch: int, samples: int, filters: int, sms: int) -> dict:
    """The kernel's launch plan (``csrc/sinc_frontend.cu`` computes the same
    tile and shared memory): the block's 8 warps cover ``filters / 20``
    groups x tiles of 32 pooled frames, so an item (one stream's ``tile``
    pooled frames, all filters) is one block's; a persistent grid of two
    blocks an SM walks the items. Pure arithmetic."""
    groups = filters // GROUP
    tile = WARP_POOLED * WARPS // groups
    pooled = num_pooled(samples)
    tiles = -(-pooled // tile)
    strip = POOL * STRIDE * tile + KERNEL_SIZE - STRIDE
    smem = 4 * (groups * STEPS * GROUP + 2 * (-(-strip // 4) * 4))
    return dict(groups=groups, tile=tile, pooled=pooled, tiles=tiles, items=batch * tiles,
                grid=max(1, min(batch * tiles, BLOCKS_PER_SM * sms)), strip=strip, smem=smem)


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sinc_frontend_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.sinc_frontend_launch.restype = i
    lib.sinc_frontend_smem.argtypes = [i]
    lib.sinc_frontend_smem.restype = ctypes.c_longlong


def _check(wave, filters, bias, stride) -> None:
    if wave.dim() != 3 or wave.shape[1] != 1:
        raise ValueError(f"wave must be mono (B, 1, samples); got {tuple(wave.shape)}")
    if filters.dim() != 2:
        raise ValueError(f"filters must be (F, K); got {tuple(filters.shape)}")
    if wave.shape[2] < filters.shape[1]:
        raise ValueError(f"{wave.shape[2]} samples are fewer than the filters' {filters.shape[1]} taps")
    if bias is not None and tuple(bias.shape) != (filters.shape[0],):
        raise ValueError(f"bias must be ({filters.shape[0]},); got {tuple(bias.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be positive; got {stride}")
    if any(t.device != wave.device for t in (filters, bias) if t is not None):
        raise ValueError("all inputs must be on the same device")


def _launch(wave, ops: SincOperands, bf16: bool):
    """Launch the kernel on CUDA tensors."""
    batch, _, samples = wave.shape
    filters = ops.filters.shape[0]
    if any(t.device != wave.device for t in (ops.taps, ops.rows, ops.shift)):
        raise ValueError("the prepared operands lie on another device")
    plan = launch_plan(batch, samples, filters, _build.num_sms(wave.device))
    out = torch.empty(batch, filters, plan["pooled"], device=wave.device)
    if plan["pooled"] == 0:
        return out
    x = wave.float().contiguous()
    lib = _build.library("sinc_frontend", _signature)
    with torch.cuda.device(wave.device):
        err = lib.sinc_frontend_launch(
            x.data_ptr(), ops.taps.data_ptr(), ops.shift.data_ptr(), ops.rows.data_ptr(), out.data_ptr(),
            batch, samples, filters, int(bf16), plan["grid"], _build.stream_handle(wave.device),
        )
    _build.check(lib, "sinc_frontend", err)
    sinc_frontend.launches += 1
    return out


class SincFrontendFunction(torch.autograd.Function):
    """The first stage with a gradient: the forward launches the kernel on
    the prepared ``ops``; the backward is autograd through
    :func:`sinc_frontend_reference` on the saved raw inputs (wave, filters
    and, where given, bias), under the forward's ``bf16_frontend``: autograd
    runs a CUDA backward on a thread of its own, whose precision policy is
    not the caller's."""

    @staticmethod
    def forward(ctx, wave, filters, bias, ops: SincOperands, bf16: bool):
        ctx.save_for_backward(*(t for t in (wave, filters, bias) if t is not None))
        ctx.bf16 = bf16
        return _launch(wave, ops, bf16)

    @staticmethod
    def backward(ctx, grad):
        with precision.use(precision.Precision(bf16_frontend=ctx.bf16), force=True):
            grads = plain_vjp(ctx, lambda *t: sinc_frontend_reference(t[0], t[1], STRIDE, *t[2:]), (grad,))
        return (*grads, *([None] * (5 - len(grads))))


def sinc_frontend(wave, filters, stride: int, bias=None, banks: int = 1,
                  operands: Optional[SincOperands] = None):
    """``max_pool1d(|conv1d(wave, filters, bias, stride)|, 3)`` as (B, F, T
    // 3) f32, the pre-pool activation rounded to bf16 under
    ``bf16_frontend``.

    wave: (B, 1, S) f32, the standardized waveform. filters: (F, K), with
    ``bias`` (F,) or None. ``operands`` is ``prepare_sinc_operands(filters,
    bias, banks)``, where the caller holds it; it carries both, which are
    then left out. A CUDA tensor takes a bank laid out as ``sinc_filters``
    lays one out, ``banks`` of them stacked (K = 251, stride 10, F / 20 in
    {1, 2, 4, 8}), and without ``operands`` prepares them for the call."""
    refuse_trained_operands(operands)
    if operands is not None:
        if filters is not None or bias is not None:
            raise ValueError("the prepared operands carry the bias and the filters")
        filters, bias = operands.filters, operands.bias
    _check(wave, filters, bias, stride)
    if wave.device.type == "cpu":
        return sinc_frontend_reference(wave, filters, stride, bias)
    if wave.device.type != "cuda":
        raise ValueError(f"unsupported device {wave.device}")
    if stride != STRIDE or filters.shape[1] != KERNEL_SIZE:
        raise ValueError(f"the kernel takes {KERNEL_SIZE} taps at stride {STRIDE}; "
                         f"got {filters.shape[1]} at {stride}")
    if operands is None:
        operands = prepare_sinc_operands(filters, bias, banks)
    bf16 = precision.enabled("bf16_frontend", wave.device)
    if wants_grad(wave, filters, bias):
        return SincFrontendFunction.apply(wave, filters, bias, operands, bf16)
    return _launch(wave, operands, bf16)


sinc_frontend.launches = 0
