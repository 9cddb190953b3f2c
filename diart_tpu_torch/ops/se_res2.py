"""Fused ECAPA SE-Res2Block, with a stage mode for diagnosis.

Counterpart of ``diart_tpu/ops/pallas_res2.py``'s ``fused_se_res2_block``,
equal to its ``se_res2_block_reference``; the stage mode is the counterpart
of ``staged`` / ``reference_stage`` (``scripts/res2_stage_debug.py``). On
a CUDA tensor they launch the hand-written kernels of ``csrc/se_res2.cu``;
on a CPU tensor they run the plain versions below. There is no fallback
between the two. Under autograd on a CUDA tensor the block is
:class:`SERes2Function`: the kernel forward, autograd through the plain
version backward (as the JAX package's ``custom_vjp``); prepared operands
are cut off from autograd, so trained parameters go in as the raw 16-tuple.
The stage mode is a diagnostic and has no gradient.

``params`` is the 16-tuple ``(w1, b1, a1, c1, wg, bg, ag, cg, w2, b2, a2,
c2, ws1, bs1, ws2, bs2)`` of the JAX package: w1/w2 (C, C) as (in, out);
b*/a*/c* (C,), the folded inference batch norms; wg (G, K, W, W) group
convolutions (tap, in, out); bg/ag/cg (G, W); ws1 (C, H), bs1 (H,),
ws2 (H, C), bs2 (C,). The 1x1 and group weights are rounded to the
activation dtype, as the TPU kernel's wrapper does; the gate MLP stays f32.
:func:`kernel_operands` lays the tuple out for the kernel once; the
wrappers take either form, so a model with fixed weights prepares its
operands once instead of on every call.

The kernel splits the group cascade in time: :func:`cascade_tile` gives the
frames of one tile for a batch on a card, and :func:`cascade_tiled` is the
plain version of that split (window, halo, the in-place group input), equal
to the unsplit cascade whatever the tile.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Union

import torch

from . import _build
from ._grad import plain_vjp, refuse_trained_operands, wants_grad
from .functional import reflect_index

__all__ = [
    "Res2Operands",
    "SERes2Function",
    "cascade_tile",
    "cascade_tiled",
    "fused_se_res2_block",
    "kernel_operands",
    "se_res2_block_reference",
    "se_res2_stage_reference",
    "se_res2_staged",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_WIDTH = 64  # the cascade kernel takes 64-wide groups (C = 64 * scale)
KERNEL_MAX_TIME = 512  # and at most 512 frames (a tile's window of one group in shared memory)
MIN_TILE = 64  # frames: shorter tiles mostly recompute halos


def _tdnn(v, w, b, a, c):
    """dt(a * relu(v @ w + b) + c) with f32 sums; w rounded to v's dtype."""
    dt = v.dtype
    y = torch.matmul(v.float(), w.to(dt).float()) + b.float()
    return (torch.relu(y) * a.float() + c.float()).to(dt)


def _cascade(z1, wg, bg, ag, cg, dilation: int, run_groups: int):
    """cat(g0, y1..y_run, zeros) from z1 (B, T, C): the sequential
    reflect-padded dilated group convolutions."""
    dt = z1.dtype
    groups, taps, width, _ = wg.shape
    chunks = torch.split(z1, width, dim=-1)
    pad = (taps - 1) * dilation // 2
    wq = wg.to(dt).float()
    outputs, y = [chunks[0]], None
    for i in range(run_groups):
        inp = chunks[i + 1] if y is None else chunks[i + 1] + y
        acc = 0.0
        for j in range(taps):
            shift, time = j * dilation - pad, inp.shape[1]
            idx = reflect_index(time, shift, time + shift, inp.device)
            acc = acc + torch.matmul(inp.index_select(1, idx).float(), wq[i, j])
        y = (torch.relu(acc + bg[i].float()) * ag[i].float() + cg[i].float()).to(dt)
        outputs.append(y)
    outputs.extend(torch.zeros_like(chunks[0]) for _ in range(groups - run_groups))
    return torch.cat(outputs, dim=-1)


def cascade_tile(batch: int, time: int, dtype: torch.dtype, num_sms: int) -> int:
    """Frames of one time tile of the kernel's cascade: as many tiles a
    stream as fill the card's block slots (two a multiprocessor for the bf16
    kernel, one for the f32 kernel) in one wave, none shorter than
    ``MIN_TILE``. The kernel's result does not depend on the tile, only its
    time does."""
    slots = num_sms * (2 if dtype == torch.bfloat16 else 1)
    tiles = max(1, min(slots // batch, time // MIN_TILE))
    return -(-time // tiles)


def cascade_tiled(z1, wg, bg, ag, cg, dilation: int, run_groups: int, tile: int):
    """:func:`_cascade` the way the kernel splits it: each tile of ``tile``
    frames works alone on its window, the tile and ``run_groups * pad``
    frames a side, clipped to the sequence. Group i is computed on the tile
    and ``(run_groups - i) * pad`` frames a side; its input rows, shifted by
    each tap and reflected only at the sequence's two ends, all lie where
    group i - 1 was computed, and ``g_{i+1} + y_i`` overwrites them in
    place. Only the tile's own rows of each y go out."""
    dt = z1.dtype
    groups, taps, width, _ = wg.shape
    time = z1.shape[1]
    pad = (taps - 1) * dilation // 2
    wq = wg.to(dt).float()
    out = torch.zeros_like(z1)
    for t0 in range(0, time, tile):
        t1 = min(time, t0 + tile)
        out[:, t0:t1, :width] = z1[:, t0:t1, :width]
        wlo, whi = max(0, t0 - run_groups * pad), min(time, t1 + run_groups * pad)
        inp = z1[:, wlo:whi, width:2 * width].clone()  # the window's group input
        for i in range(1, run_groups + 1):
            lo, hi = max(0, t0 - (run_groups - i) * pad), min(time, t1 + (run_groups - i) * pad)
            rows = torch.arange(lo, hi, device=z1.device)
            acc = 0.0
            for j in range(taps):
                src = rows + (j * dilation - pad)
                src = torch.where(src < 0, -src, src)
                src = torch.where(src >= time, 2 * (time - 1) - src, src)
                if int(src.min()) < wlo or int(src.max()) >= whi:
                    raise AssertionError("a tap reads outside the tile's window")
                acc = acc + torch.matmul(inp.index_select(1, src - wlo).float(), wq[i - 1, j])
            y = (torch.relu(acc + bg[i - 1].float()) * ag[i - 1].float() + cg[i - 1].float()).to(dt)
            out[:, t0:t1, i * width:(i + 1) * width] = y[:, t0 - lo:t1 - lo]
            if i < run_groups:
                inp[:, lo - wlo:hi - wlo] = z1[:, lo:hi, (i + 1) * width:(i + 2) * width] + y
    return out


def se_res2_block_reference(x, w1, b1, a1, c1, wg, bg, ag, cg, w2, b2, a2, c2,
                            ws1, bs1, ws2, bs2, dilation: int):
    """Plain version of one SE-Res2Block on x (B, T, C): compute in x's
    dtype with f32 sums; BN affines and the SE MLP in f32; z1, each
    ``chunk + y``, each y, the concat and z2 rounded to the dtype; the gate
    cast to it; ``z2 * gate`` rounded, then ``x + ...`` rounded."""
    dt = x.dtype
    z1 = _tdnn(x, w1, b1, a1, c1)
    cat = _cascade(z1, wg, bg, ag, cg, dilation, wg.shape[0])
    z2 = _tdnn(cat, w2, b2, a2, c2)
    s = z2.float().mean(dim=1)
    s = torch.relu(torch.matmul(s, ws1.float()) + bs1.float())
    gate = torch.sigmoid(torch.matmul(s, ws2.float()) + bs2.float())
    return x + z2 * gate[:, None, :].to(dt)


def se_res2_stage_reference(x, params: Sequence[torch.Tensor], dilation: int, stage: int):
    """Plain version of the stage mode: z1 for ``stage == 0``, else
    ``cat(g0, y1..y_stage, zeros)`` (stages beyond the group count give the
    whole concat)."""
    w1, b1, a1, c1, wg, bg, ag, cg = params[:8]
    z1 = _tdnn(x, w1, b1, a1, c1)
    if stage == 0:
        return z1
    return _cascade(z1, wg, bg, ag, cg, dilation, min(wg.shape[0], stage))


class Res2Operands(NamedTuple):
    """The block's parameters laid out for the kernel: the 1x1 and group
    weights in the activation dtype, each (bias, scale, shift) triple
    stacked in f32 — v1/v2 (3, C), vg (G, 3, W) — and the gate MLP in f32."""

    w1: torch.Tensor
    v1: torch.Tensor
    wg: torch.Tensor
    vg: torch.Tensor
    w2: torch.Tensor
    v2: torch.Tensor
    ws1: torch.Tensor
    bs1: torch.Tensor
    ws2: torch.Tensor
    bs2: torch.Tensor

    def params(self):
        """The 16-tuple these operands were made from (weights rounded)."""
        return (self.w1, *self.v1, self.wg, *self.vg.unbind(1), self.w2, *self.v2,
                self.ws1, self.bs1, self.ws2, self.bs2)


def kernel_operands(params: Sequence[torch.Tensor], dtype: torch.dtype) -> Res2Operands:
    """Lay the 16-tuple ``params`` out for activations of ``dtype``."""
    if len(params) != 16:
        raise ValueError(f"params must be the 16-tuple of the block; got {len(params)} entries")
    w1, b1, a1, c1, wg, bg, ag, cg, w2, b2, a2, c2, ws1, bs1, ws2, bs2 = params
    f32 = lambda v: v.float().contiguous()
    return Res2Operands(
        w1=w1.to(dtype).contiguous(), v1=f32(torch.stack([b1, a1, c1])),
        wg=wg.to(dtype).contiguous(), vg=f32(torch.stack([bg, ag, cg], dim=1)),
        w2=w2.to(dtype).contiguous(), v2=f32(torch.stack([b2, a2, c2])),
        ws1=f32(ws1), bs1=f32(bs1), ws2=f32(ws2), bs2=f32(bs2),
    )


Params = Union[Sequence[torch.Tensor], Res2Operands]


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.se_res2_block_launch.argtypes = [p] * 15 + [i] * 9 + [p]
    lib.se_res2_block_launch.restype = i
    lib.se_res2_staged_launch.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.se_res2_staged_launch.restype = i


def _operands(x, params: Params, dilation: int) -> Res2Operands:
    """``params`` as checked kernel operands for x."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C); got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if isinstance(params, Res2Operands):
        refuse_trained_operands(params, "the prepared block operands (Res2Operands)")
        ops = params
    else:
        with torch.no_grad():  # the kernel's layout; a gradient goes through the raw tuple
            ops = kernel_operands(params, x.dtype)
    if ops.w1.dtype != x.dtype:
        raise TypeError(f"the operands were laid out for {ops.w1.dtype}, x is {x.dtype}")
    batch, time, chans = x.shape
    w1, wg, w2, ws1, ws2 = ops.w1, ops.wg, ops.w2, ops.ws1, ops.ws2
    groups, taps, width, width_out = wg.shape
    if chans != (groups + 1) * width or width_out != width:
        raise ValueError(f"wg {tuple(wg.shape)} does not split {chans} channels")
    if tuple(w1.shape) != (chans, chans) or tuple(w2.shape) != (chans, chans):
        raise ValueError(f"w1 and w2 must be ({chans}, {chans})")
    if ws1.shape[0] != chans or tuple(ws2.shape) != (ws1.shape[1], chans):
        raise ValueError(f"ws1 must be ({chans}, H) and ws2 (H, {chans})")
    if (taps - 1) * dilation // 2 >= time:
        raise ValueError(f"{time} frames are too few to reflect-pad dilation {dilation}")
    if any(p.device != x.device for p in ops):
        raise ValueError("all inputs must be on the same device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and (width != KERNEL_WIDTH or time > KERNEL_MAX_TIME or taps % 2 == 0):
        raise ValueError(
            f"the SE-Res2Block kernel takes {KERNEL_WIDTH}-wide groups, an odd tap count and "
            f"at most {KERNEL_MAX_TIME} frames; got width {width}, {taps} taps, {time} frames"
        )
    return ops


def _aligned(x):
    """x contiguous at a 16-byte boundary (the kernels move 16 bytes a thread)."""
    xc = x.contiguous()
    return xc.clone() if xc.data_ptr() % 16 else xc


def _launch(x, k: Res2Operands, dilation: int):
    """Launch the block's kernels on CUDA tensors. Two (B, T, C) buffers:
    the output, which holds z1 and z2 on the way, and the concat."""
    batch, time, chans = x.shape
    groups, taps = k.wg.shape[:2]
    hidden = k.ws1.shape[1]
    lib = _build.library("se_res2", _signature)
    xc = _aligned(x)
    out, cat = torch.empty_like(xc), torch.empty_like(xc)
    part = torch.empty(batch, -(-time // 64), chans, device=x.device)
    gate = torch.empty(batch, chans, device=x.device)
    tile = cascade_tile(batch, time, x.dtype, _build.num_sms(x.device))
    ptr = lambda t: t.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.se_res2_block_launch(
            ptr(xc), ptr(out), ptr(cat), ptr(part), ptr(gate),
            *map(ptr, k),
            batch, time, chans, groups, taps, hidden, int(dilation), tile, _DTYPES[x.dtype],
            _build.stream_handle(x.device),
        )
    _build.check(lib, "se_res2", err)
    fused_se_res2_block.launches += 1
    return out


class SERes2Function(torch.autograd.Function):
    """The block with a gradient (``jax.custom_vjp`` of ``pallas_res2.py``):
    ``apply(x, *params, ops, dilation)``. The forward launches the kernels
    on CUDA tensors (the plain version on CPU tensors) with ``ops``, or the
    16-tuple ``params`` laid out for the call; the backward is autograd
    through :func:`se_res2_block_reference` on the saved x and ``params``."""

    @staticmethod
    def forward(ctx, x, *args):
        *params, ops, dilation = args
        ctx.save_for_backward(x, *params)
        ctx.dilation = dilation
        if x.device.type == "cpu":
            return se_res2_block_reference(x, *params, dilation)
        return _launch(x, ops if ops is not None else kernel_operands(params, x.dtype), dilation)

    @staticmethod
    def backward(ctx, grad):
        ref = lambda *args: se_res2_block_reference(*args, ctx.dilation)
        return (*plain_vjp(ctx, ref, (grad,)), None, None)


def fused_se_res2_block(x, params: Params, dilation: int):
    """One SE-Res2Block of x (B, T, C) f32 or bf16 with the 16-tuple
    ``params`` or its :class:`Res2Operands`; returns (B, T, C) in x's
    dtype. Counts one launch per call (the block's five kernels run on the
    caller's stream)."""
    k = _operands(x, params, dilation)
    raw = k.params() if isinstance(params, Res2Operands) else tuple(params)
    if x.device.type == "cpu":
        return se_res2_block_reference(x, *raw, dilation)
    if wants_grad(x, *raw):
        return SERes2Function.apply(x, *raw, k, dilation)
    return _launch(x, k, dilation)


fused_se_res2_block.launches = 0


def se_res2_staged(x, params: Params, dilation: int, stage: int):
    """The block's partial result after ``stage``: z1 for 0, else
    ``cat(g0, y1..y_stage, zeros)``; (B, T, C) in x's dtype. Stages beyond
    the group count give the whole concat."""
    k = _operands(x, params, dilation)
    if stage < 0:
        raise ValueError(f"stage must be >= 0; got {stage}")
    if wants_grad(x, *(() if isinstance(params, Res2Operands) else params)):
        raise TypeError("se_res2_staged is a diagnostic and has no gradient; call it under torch.no_grad()")
    if x.device.type == "cpu":
        return se_res2_stage_reference(x, k.params(), dilation, stage)
    batch, time, chans = x.shape
    groups, taps = k.wg.shape[:2]
    lib = _build.library("se_res2", _signature)
    xc = _aligned(x)
    stage = min(int(stage), groups)
    out = torch.empty_like(xc)
    z1 = torch.empty_like(xc) if stage else out  # the cascade reads z1 and writes out
    tile = cascade_tile(batch, time, x.dtype, _build.num_sms(x.device))
    with torch.cuda.device(x.device):
        err = lib.se_res2_staged_launch(
            xc.data_ptr(), out.data_ptr(), z1.data_ptr(), k.w1.data_ptr(), k.v1.data_ptr(),
            k.wg.data_ptr(), k.vg.data_ptr(), batch, time, chans, groups, taps,
            int(dilation), stage, tile, _DTYPES[x.dtype], _build.stream_handle(x.device),
        )
    _build.check(lib, "se_res2", err)
    se_res2_staged.launches += 1
    return out


se_res2_staged.launches = 0
