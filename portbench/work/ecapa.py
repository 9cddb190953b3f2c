"""ECAPA-TDNN's work a hop: the log-mel frames of the new block (the frame
ring keeps the rest), the stem, three SE-Res2Blocks (the ``se_res2``
kernels), the aggregation, the attention (the ``attn_stats`` kernel) and
the embedding."""

from __future__ import annotations

from typing import Dict

from . import BYTES, add, conv

FRAMES = 501  # 5 s at a 160-sample hop, centred
NEW_FRAMES = 50  # a 0.5 s block's frames
N_FFT, MELS, SPEAKERS, SCALE, TAPS = 400, 80, 4, 8, 3


def block_flops(c: int, t: int) -> float:
    """One SE-Res2Block's products: two 1x1 TDNNs and the cascade of
    ``SCALE - 1`` k=3 groups."""
    g = c // SCALE
    return 2 * conv(c, c, 1, t) + (SCALE - 1) * conv(g, g, TAPS, t)


def flops(args: dict, parts: dict) -> Dict[str, float]:
    c, e, t = args["channels"], args["embedding_dim"], FRAMES
    bins = N_FFT // 2 + 1
    out = add({}, parts["fbank"], NEW_FRAMES * (2.0 * 2 * bins * N_FFT + 2.0 * bins * MELS))
    trunk = conv(MELS, c, 5, t) + 3 * block_flops(c, t) + conv(3 * c, 3 * c, 1, t)
    add(out, parts["embedding"], trunk)
    att = 128
    head = conv(3 * c, att, 1, t) + conv(att, 3 * c, 1, t) + 3 * 2.0 * SPEAKERS * t * 3 * c
    return add(out, parts["attention"], head + 2.0 * SPEAKERS * 6 * c * e)


def kernels(args: dict, parts: dict, batch: int) -> list:
    """The three blocks' ``se_res2`` launches (each block's input read and
    output written once, with its weights) and ``attn_stats`` (the frames,
    the attention's hidden states, the speakers' weights and the scores'
    weight read once, the three moments written once)."""
    c, t, s = args["channels"], FRAMES, BYTES[parts["embedding"]]
    g = c // SCALE
    block = dict(name="se_res2", pattern=r"tdnn_wgmma|tdnn_fma|res2_cascade|se_residual|se_gate",
                 precision=parts["embedding"], flops=batch * block_flops(c, t),
                 bytes=s * (2 * batch * t * c + 2 * c * c + (SCALE - 1) * TAPS * g * g))
    att = 128
    attn = dict(name="attn_stats", pattern=r"attn_stats", precision=parts["attention"],
                flops=batch * (conv(att, 3 * c, 1, t) + 3 * 2.0 * SPEAKERS * t * 3 * c),
                bytes=s * batch * t * 3 * c + 4 * (batch * t * att + batch * SPEAKERS * t + att * 3 * c
                                                   + 3 * batch * SPEAKERS * 3 * c))
    return [dict(block) for _ in range(3)] + [attn]
