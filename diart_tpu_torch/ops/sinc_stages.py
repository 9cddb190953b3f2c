"""SincNet's second and third stages: from the first stage's pooled output
(B, 80, P1) to the trunk's (B, 60, P3),

    x = leaky(norm1(pooled))
    x = leaky(norm2(max_pool3(conv2(x) + b2)))      conv2: 80 -> 60, k = 5
    x = leaky(norm3(max_pool3(conv3(x) + b3)))      conv3: 60 -> 60, k = 5

each norm an instance norm over time with its affine (:func:`instance_norm`),
leaky the slope 0.01, the convolutions in ``dtype`` (f32: true f32; bf16:
operands and output rounded to bf16) with everything else in f32.

The plain version is the composition ``SincNet`` ran before the kernels,
and a CPU tensor runs it. A CUDA tensor launches the hand-written kernels
of ``csrc/sinc_stages.cu`` (norm1's statistics, then each convolution as
an implicit GEMM on the tensor cores, ``wgmma``, with the norm before it
applied as its input is loaded and the bias and max-pool in its epilogue,
three launches a call), which write no (B, 80, P1) or (B, 60, P1 - 4) f32
activation; there is no fallback between the two. The products are
3xTF32 at f32 and one product of bf16 values at bf16.

The convolutions' weights and biases are laid out for the kernels once per
model and held (:func:`prepare_stage_operands`, passed as ``operands=``,
which then carries them); the norms' parameters go in as they are. Under
autograd on a CUDA tensor the call is :class:`SincStagesFunction`: the
kernels forward, autograd through the plain version backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build, _numerics
from ._grad import plain_vjp, refuse_trained_operands, wants_grad

__all__ = [
    "SincStagesFunction",
    "StageOperands",
    "instance_norm",
    "launch_plan",
    "prepare_stage_operands",
    "sinc_stages",
    "sinc_stages_reference",
]

C_IN, C_OUT, TAPS, POOL = 80, 60, 5, 3  # SincNet's stages
N_PAD = 64  # output channels padded to the kernels' wgmma N
SLICE = 32  # k a slice of the kernels' W^T ring holds
TILE = 42  # pooled frames a tile of the kernels (its 128 conv frames, 3 x 42 of them pooled)
BLOCKS_PER_SM = 2
SLOPE = 0.01


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps=1e-5) -> torch.Tensor:
    """InstanceNorm1d(affine) with the biased variance, as ``jnp.var``.
    x: (batch, channels, time)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * scale[None, :, None] + bias[None, :, None]


def sinc_stages_reference(pooled, norms: Sequence[torch.Tensor], w2, b2, w3, b3, dtype):
    """Plain version. pooled (B, 80, P1); norms the six (scale, shift) of
    norm1 (80,), norm2 and norm3 (60,); w2 (60, 80, 5), w3 (60, 60, 5), b2,
    b3 (60,) -> (B, 60, P3) f32."""
    s1, c1, s2, c2, s3, c3 = norms
    x = F.leaky_relu(instance_norm(pooled, s1, c1), SLOPE)
    for w, b, s, c in ((w2, b2, s2, c2), (w3, b3, s3, c3)):
        with _numerics.conv_scope(x.device, dtype):
            x = F.conv1d(x.to(dtype), w.to(dtype), b.to(dtype)).float()
        x = F.max_pool1d(x, POOL)
        x = F.leaky_relu(instance_norm(x, s, c), SLOPE)
    return x


def frames(p1: int):
    """(P2, P3): pooled frames after conv2 and after conv3 for P1 input frames."""
    p2 = (p1 - (TAPS - 1)) // POOL
    return p2, (p2 - (TAPS - 1)) // POOL


class StageOperands(NamedTuple):
    """The convolutions laid out for the kernels (:func:`prepare_stage_operands`).
    ``w2``, ``b2``, ``w3``, ``b3`` as given: the plain version's inputs, and
    autograd's. ``dtype``: the products' type they were laid out for.
    ``wt2`` (2, 64, 416) and ``wt3`` (2, 64, 320) f32: each convolution as
    W^T, hi then lo, the ``wgmma`` B operand: row n an output channel (60
    padded to 64), column k = tap x C + channel (C: 80, or conv3's 60
    padded to 64) padded to whole slices of 32, zero where either is
    padding; at f32 hi and lo split as the kernels split their A operand
    (``_numerics.split_tf32``), at bf16 the bf16 values and a zero lo.
    ``bias2``, ``bias3`` (60,) f32, bf16 values at bf16."""

    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    dtype: torch.dtype
    wt2: torch.Tensor
    bias2: torch.Tensor
    wt3: torch.Tensor
    bias3: torch.Tensor


def _transposed(w: torch.Tensor, dtype) -> torch.Tensor:
    c_out, c_in, taps = w.shape
    c_pad = -(-c_in // 8) * 8
    k_pad = -(-taps * c_pad // SLICE) * SLICE
    wp = torch.zeros(N_PAD, taps, c_pad, device=w.device)
    wp[:c_out, :, :c_in] = w.detach().to(dtype).float().permute(0, 2, 1)
    wt = torch.zeros(N_PAD, k_pad, device=w.device)
    wt[:, : taps * c_pad] = wp.reshape(N_PAD, taps * c_pad)
    hi, lo = (wt, torch.zeros_like(wt)) if dtype == torch.bfloat16 else _numerics.split_tf32(wt)
    return torch.stack([hi, lo]).contiguous()


def prepare_stage_operands(w2, b2, w3, b3, dtype) -> StageOperands:
    """Lay out conv2 (60, 80, 5) and conv3 (60, 60, 5) with their biases
    (60,) for products in ``dtype`` (f32 or bf16)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernels take f32 or bf16 products; got {dtype}")
    _check_convs(w2, b2, w3, b3)
    bias = lambda b: b.detach().to(dtype).float().contiguous()
    return StageOperands(w2, b2, w3, b3, dtype, _transposed(w2, dtype), bias(b2), _transposed(w3, dtype), bias(b3))


def launch_plan(batch: int, p1: int, sms: int) -> dict:
    """The kernels' launch plan, which ``csrc/sinc_stages.cu`` takes as it
    is (and refuses unless it fits the buffers): conv2 over (stream, tile)
    items and conv3 over streams, each by a persistent grid of two blocks
    an SM. Pure arithmetic."""
    p2, p3 = frames(p1)
    tiles2, tiles3 = -(-p2 // TILE), -(-p3 // TILE)
    slots = BLOCKS_PER_SM * sms
    return dict(p2=p2, p3=p3, tiles2=tiles2, tiles3=tiles3, items=batch * tiles2,
                grid2=max(1, min(batch * tiles2, slots)), grid3=max(1, min(batch, slots)))


def _signature(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sinc_stages_launch.argtypes = [p, ll] + [p] * 14 + [i] * 9 + [p]
    lib.sinc_stages_launch.restype = i


def _check_convs(w2, b2, w3, b3) -> None:
    want = {"w2": (C_OUT, C_IN, TAPS), "b2": (C_OUT,), "w3": (C_OUT, C_OUT, TAPS), "b3": (C_OUT,)}
    for name, t in zip(want, (w2, b2, w3, b3)):
        if t is None or tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}; got {None if t is None else tuple(t.shape)}")


def _check(pooled, norms, w2, b2, w3, b3) -> None:
    if pooled.dim() != 3 or pooled.shape[1] != C_IN:
        raise ValueError(f"pooled must be (B, {C_IN}, frames); got {tuple(pooled.shape)}")
    if pooled.stride(2) != 1 or pooled.stride(1) != pooled.shape[2]:
        raise ValueError("each stream's (channels, frames) rows of pooled must be contiguous; got strides "
                         f"{pooled.stride()}")
    _check_convs(w2, b2, w3, b3)
    if len(norms) != 6 or [tuple(t.shape) for t in norms] != [(C_IN,)] * 2 + [(C_OUT,)] * 4:
        raise ValueError("norms are norm1's (80,) scale and shift, then norm2's and norm3's (60,)")
    if any(t.device != pooled.device for t in (*norms, w2, b2, w3, b3)):
        raise ValueError("all inputs must be on the same device")


def _launch(pooled, norms, ops: StageOperands):
    """Launch the three kernels on CUDA tensors."""
    batch, _, p1 = pooled.shape
    if pooled.dtype != torch.float32:
        raise ValueError(f"the kernels take f32 pooled input; got {pooled.dtype}")
    plan = launch_plan(batch, p1, _build.num_sms(pooled.device))
    if plan["p3"] < 1:
        raise ValueError(f"{p1} pooled frames leave no frame after conv3's pool")
    dev = pooled.device
    stats = torch.empty(batch, C_IN, 2, device=dev)
    mid = torch.empty(batch, C_OUT, plan["p2"], device=dev)
    part = torch.empty(batch, plan["tiles2"], C_OUT, 2, device=dev)
    out = torch.empty(batch, C_OUT, plan["p3"], device=dev)
    params = [t.detach().float().contiguous() for t in norms]
    lib = _build.library("sinc_stages", _signature)
    with torch.cuda.device(dev):
        err = lib.sinc_stages_launch(
            pooled.data_ptr(), pooled.stride(0) if batch > 1 else C_IN * p1, ops.wt2.data_ptr(), ops.bias2.data_ptr(), ops.wt3.data_ptr(),
            ops.bias3.data_ptr(), *(t.data_ptr() for t in params), stats.data_ptr(), mid.data_ptr(),
            part.data_ptr(), out.data_ptr(), batch, p1,
            *(plan[k] for k in ("p2", "p3", "tiles2", "tiles3", "grid2", "grid3")),
            int(ops.dtype == torch.bfloat16), _build.stream_handle(dev),
        )
    _build.check(lib, "sinc_stages", err)
    sinc_stages.launches += 1
    return out


class SincStagesFunction(torch.autograd.Function):
    """The stages with a gradient: the forward launches the kernels on the
    prepared ``ops``; the backward is autograd through
    :func:`sinc_stages_reference` on the saved raw inputs, in the forward's
    ``dtype``."""

    @staticmethod
    def forward(ctx, pooled, s1, c1, s2, c2, s3, c3, w2, b2, w3, b3, ops: StageOperands):
        ctx.save_for_backward(pooled, s1, c1, s2, c2, s3, c3, w2, b2, w3, b3)
        ctx.dtype = ops.dtype
        return _launch(pooled, (s1, c1, s2, c2, s3, c3), ops)

    @staticmethod
    def backward(ctx, grad):
        grads = plain_vjp(ctx, lambda p, *t: sinc_stages_reference(p, t[:6], *t[6:], ctx.dtype), (grad,))
        return (*grads, None)


def sinc_stages(pooled, norms: Sequence[torch.Tensor], w2, b2, w3, b3, dtype,
                operands: Optional[StageOperands] = None):
    """SincNet's second and third stages: pooled (B, 80, P1) f32, each
    stream's rows contiguous (a batch stride of its own allowed: the
    stacked frontend's halves) -> (B, 60, P3) f32, P2 = (P1 - 4) // 3, P3 =
    (P2 - 4) // 3.

    norms: norm1's scale and shift (80,), then norm2's and norm3's (60,).
    w2 (60, 80, 5), b2, w3 (60, 60, 5), b3: the convolutions; ``operands``
    is ``prepare_stage_operands(w2, b2, w3, b3, dtype)`` where the caller
    holds it, and carries them, which are then left out. A CUDA tensor
    without ``operands`` prepares them for the call."""
    refuse_trained_operands(operands)
    if operands is not None:
        if any(t is not None for t in (w2, b2, w3, b3)):
            raise ValueError("the prepared operands carry the convolutions' weights and biases")
        if operands.dtype != dtype:
            raise ValueError(f"the operands were laid out for {operands.dtype} products, not {dtype}")
        w2, b2, w3, b3 = operands.w2, operands.b2, operands.w3, operands.b3
        if any(t.device != pooled.device for t in (operands.wt2, operands.bias2, operands.wt3, operands.bias3)):
            raise ValueError("the prepared operands lie on another device")
    norms = tuple(norms)
    _check(pooled, norms, w2, b2, w3, b3)
    if pooled.device.type == "cpu":
        return sinc_stages_reference(pooled, norms, w2, b2, w3, b3, dtype)
    if pooled.device.type != "cuda":
        raise ValueError(f"unsupported device {pooled.device}")
    if operands is None:
        operands = prepare_stage_operands(w2, b2, w3, b3, dtype)
    if wants_grad(pooled, *norms, w2, b2, w3, b3):
        return SincStagesFunction.apply(pooled, *norms, w2, b2, w3, b3, operands)
    return _launch(pooled, norms, operands)


sinc_stages.launches = 0
