"""The work a hop needs, counted from a configuration's shapes and
precision (not from the route a kernel takes, so a change of route leaves
the yardstick where it was), and the published peaks it is held against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s for
bf16 products; f32 products at 495 / 3 = 165 TFLOP/s, the rate of three
TF32 passes, the fastest f32-accurate product the port uses; 3.35 TB/s of
HBM. Each family of models has a module here (``pyannet``, ``xvector``,
``ecapa``) with ``flops(args, parts)``, a stream's products a hop by
precision, and ``kernels(args, parts, batch)``, the hand-written kernels a
hop launches with their operations and bytes.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# tensor cores (int8: operations); f32 outside them (chip_smoke.py :295 at 50f33b4)
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}
# the peak a product of each stated precision is held to
PRODUCT_PEAK = {"bf16": PEAK_FLOPS["bf16"], "f32": PEAK_FLOPS["tf32"] / 3}
BYTES = {"bf16": 2, "f32": 4}


def bound_ms(nbytes: float, flops: float, kind: str):
    """(least ms, what bounds it) of ``flops`` at ``kind``'s peak and
    ``nbytes`` read or written once (copy of ``chip_smoke.py`` ``bound_ms``,
    :341 at 50f33b4)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tf32_bounds(nbytes, tensor_flops, fma_flops=0.0):
    """The 3xTF32 bound (three TF32 products of ``tensor_flops`` at the
    tensor cores' peak, the ``fma_flops`` beside them on the f32 units, or
    the bytes) and the bound of the same work as f32 FMAs: ((ms, by), (ms,
    by)) (copy of ``chip_smoke.py`` ``tf32_bounds``, :559 at 50f33b4)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(3 * tensor_flops / PEAK_FLOPS["tf32"], fma_flops / PEAK_FLOPS["f32"])
    return ((max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"),
            bound_ms(nbytes, tensor_flops + fma_flops, "f32"))


def product_seconds(flops_by_precision: Dict[str, float]) -> float:
    """The least seconds of these products at their precisions' peaks."""
    return sum(f / PRODUCT_PEAK[p] for p, f in flops_by_precision.items())


def kernel_bound_s(kernel: dict) -> float:
    """A kernel's least seconds: the larger of its operations at its
    precision's peak (f32: three TF32 products) and its bytes over HBM."""
    if kernel["precision"] == "f32":
        (ms, _), _ = tf32_bounds(kernel["bytes"], kernel["flops"])
    else:
        ms, _ = bound_ms(kernel["bytes"], kernel["flops"], kernel["precision"])
    return ms * 1e-3


def family(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def conv(cin: int, cout: int, kernel: int, t_out: int) -> float:
    """Operations of a 1-D convolution (a multiply and an add a tap)."""
    return 2.0 * cin * cout * kernel * t_out


def add(total: Dict[str, float], precision: str, flops: float) -> Dict[str, float]:
    total[precision] = total.get(precision, 0.0) + flops
    return total


def hop_work(config: dict, batch: int) -> Tuple[Dict[str, float], list]:
    """(products a hop by precision over ``batch`` streams, kernels a hop)."""
    parts = config["precision_of_parts"]
    flops: Dict[str, float] = {}
    kernels = []
    for role in ("segmentation", "embedding"):
        fam = family(config[role]["reference"])
        for p, f in fam.flops(config[role]["args"], parts).items():
            add(flops, p, f * batch)
        kernels += [dict(k, role=role) for k in fam.kernels(config[role]["args"], parts, batch)]
    return flops, kernels
