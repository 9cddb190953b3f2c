"""The SincNet x-vector's work a hop: SincNet, the TDNN stack, the weighted
statistics (the ``linear_stats`` kernel computes the last TDNN and the
moments), the embedding."""

from __future__ import annotations

from typing import Dict

from . import BYTES, add, conv
from .pyannet import sincnet_flops, sincnet_frames

TDNN = ((5, 1, 512), (3, 2, 512), (3, 3, 512), (1, 1, 512), (1, 1, 1500))
SPEAKERS = 4


def tdnn_frames():
    """(frames in, frames out) of each TDNN layer."""
    t, out = sincnet_frames()[-1], []
    for k, d, _ in TDNN:
        out.append((t, t - (k - 1) * d))
        t = out[-1][1]
    return out


def flops(args: dict, parts: dict) -> Dict[str, float]:
    out = sincnet_flops(parts, "embedding")
    cin = 60
    for (k, _, c), (_, t) in zip(TDNN, tdnn_frames()):
        add(out, parts["embedding"], conv(cin, c, k, t))
        cin = c
    t = tdnn_frames()[-1][1]
    add(out, parts["embedding"], 2 * 2.0 * SPEAKERS * t * cin)  # the weighted moments
    return add(out, parts["embedding"], 2.0 * SPEAKERS * 2 * cin * args["embedding_dim"])


def kernels(args: dict, parts: dict, batch: int) -> list:
    """``linear_stats``: the last TDNN's product and the speakers' moments,
    the frames, the weight and the speakers' weights read once, the moments
    written once."""
    t = tdnn_frames()[-1][1]
    cin, c = TDNN[-2][2], TDNN[-1][2]
    return [dict(name="linear_stats", pattern=r"linear_stats", precision=parts["embedding"],
                 flops=2.0 * batch * t * cin * c + 2 * 2.0 * batch * SPEAKERS * t * c,
                 bytes=BYTES[parts["embedding"]] * batch * t * cin + 4 * (cin * c + batch * SPEAKERS * t
                                                                           + 2 * batch * SPEAKERS * c))]
