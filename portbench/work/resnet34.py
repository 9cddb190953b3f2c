"""WeSpeaker ResNet34's work a hop: the kaldi fbank frames of the new block
(the frame ring keeps the rest), the trunk's 36 convolutions over the whole
window's (time, mel) plane, and the statistics head. No hand-written kernel
runs in it: its convolutions are cuDNN's."""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import BYTES, HBM_BYTES_PER_S, PRODUCT_PEAK, add

FRAMES = 498  # kaldi frames of a 5 s window: 25 ms every 10 ms, edges snipped
NEW_FRAMES = 50  # a 0.5 s block's frames
FRAME, PADDED = 400, 512  # samples a frame; the DFT's size (256 bins below Nyquist)
SPEAKERS = 4

Conv = Tuple[int, int, int, int, int]  # (in, out, taps, positions in, positions out)


def _down(n: int) -> int:
    """A map's side after a stride-2 convolution (3x3, padding 1; or 1x1)."""
    return (n - 1) // 2 + 1


def convs(args: dict) -> List[Conv]:
    """The trunk's convolutions in order: the stem, then each BasicBlock's
    two 3x3 convolutions and, where the shape changes, its 1x1
    downsample."""
    t, f, c = FRAMES, args["num_mels"], args["base_channels"]
    out = [(1, c, 9, t * f, t * f)]
    cin = c
    for stage, depth in enumerate(args["depths"]):
        width = c * 2 ** stage
        for i in range(depth):
            stride = 2 if stage and not i else 1
            t2, f2 = (_down(t), _down(f)) if stride == 2 else (t, f)
            out.append((cin, width, 9, t * f, t2 * f2))
            out.append((width, width, 9, t2 * f2, t2 * f2))
            if stride != 1 or cin != width:
                out.append((cin, width, 1, t * f, t2 * f2))
            cin, t, f = width, t2, f2
    return out


def pooled(args: dict) -> Tuple[int, int]:
    """(frames, values a frame) the head pools: the last stage's time and
    channels x mels."""
    t, f = FRAMES, args["num_mels"]
    for _ in args["depths"][1:]:
        t, f = _down(t), _down(f)
    return t, args["base_channels"] * 2 ** (len(args["depths"]) - 1) * f


def trunk_flops(args: dict) -> float:
    return sum(2.0 * cin * cout * taps * p_out for cin, cout, taps, _, p_out in convs(args))


def flops(args: dict, parts: dict) -> Dict[str, float]:
    """A stream's products a hop, by precision."""
    bins = PADDED // 2
    out = add({}, parts["fbank"], NEW_FRAMES * (2.0 * 2 * bins * FRAME + 2.0 * bins * args["num_mels"]))
    add(out, parts["embedding"], trunk_flops(args))
    t, d = pooled(args)
    head = 2 * 2.0 * SPEAKERS * t * d + 2.0 * SPEAKERS * 2 * d * args["embedding_dim"]
    return add(out, parts["head"], head)


def kernels(args: dict, parts: dict, batch: int) -> list:
    return []


def trunk_least_s(args: dict, parts: dict, batch: int) -> float:
    """The trunk's least seconds a hop over ``batch`` streams: the sum, over
    its convolutions, of the larger of the products at the stated
    precision's peak and the bytes (the input read, the output and the
    weights written or read once, at the stated precision) over HBM."""
    prec = parts["embedding"]
    s = BYTES[prec]
    total = 0.0
    for cin, cout, taps, p_in, p_out in convs(args):
        ops = 2.0 * batch * cin * cout * taps * p_out / PRODUCT_PEAK[prec]
        nbytes = s * (batch * (cin * p_in + cout * p_out) + cin * cout * taps) / HBM_BYTES_PER_S
        total += max(ops, nbytes)
    return total
