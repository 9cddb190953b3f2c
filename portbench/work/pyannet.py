"""PyanNet's work a hop: SincNet, the BiLSTM (the ``lstm_sweep`` kernel's
recurrence), the linear layers."""

from __future__ import annotations

from typing import Dict

from . import BYTES, add, conv

SAMPLES = 80000  # 5 s at 16 kHz


def sincnet_frames(samples: int = SAMPLES):
    """Frames after the sinc convolution, each pool and each k=5 convolution."""
    t = (samples - 251) // 10 + 1
    p1 = t // 3
    c2 = p1 - 4
    p2 = c2 // 3
    c3 = p2 - 4
    return t, p1, c2, p2, c3, c3 // 3


def sincnet_flops(parts: dict, part: str) -> Dict[str, float]:
    t, _, c2, _, c3, _ = sincnet_frames()
    out = add({}, parts["sinc"], conv(1, 80, 251, t))
    return add(out, parts[part], conv(80, 60, 5, c2) + conv(60, 60, 5, c3))


def flops(args: dict, parts: dict) -> Dict[str, float]:
    """A stream's products a hop, by precision."""
    frames = sincnet_frames()[-1]
    h, layers = args["lstm_hidden"], args["lstm_layers"]
    out = sincnet_flops(parts, "segmentation")
    for layer in range(layers):
        fan_in = 60 if layer == 0 else 2 * h
        add(out, parts["lstm"], 2 * 2.0 * frames * 4 * h * (fan_in + h))
    dims = [2 * h, *args["linear_dims"], args["num_speakers"]]
    return add(out, parts["segmentation"], sum(2.0 * frames * a * b for a, b in zip(dims, dims[1:])))


def kernels(args: dict, parts: dict, batch: int) -> list:
    """The sweep's launches a hop: each layer's recurrence in both
    directions, the gate stream read and the hidden states written once."""
    frames = sincnet_frames()[-1]
    h, s = args["lstm_hidden"], BYTES[parts["lstm"]]
    one = dict(name="lstm_sweep", pattern=r"lstm_sweep_(mma|split|kernel)", precision=parts["lstm"],
               flops=2 * frames * batch * 2.0 * 4 * h * h,
               bytes=s * (frames * 2 * batch * 4 * h + 2 * 4 * h * h + frames * 2 * batch * h))
    return [dict(one) for _ in range(args["lstm_layers"])]
