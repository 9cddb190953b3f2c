"""A cell of ``BENCHMARK.json`` resolved into what a run needs: its
configuration and traffic files, the weights and the audio made from the
seed, and the port's engine built from them.

Everything one configuration or one traffic mix owns sits in a file of its
own, found by the name ``BENCHMARK.json`` gives: ``configs/<config>.json``
(or the file the configuration's entry names) and
``traffic/<traffic>.json``.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(workload: str, root: Path = ROOT) -> Tuple[dict, dict, dict]:
    """(cell entry, configuration, traffic) of the cell named ``workload``."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / HERE.name / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def scrub_policy_variables() -> list:
    """Remove the port's ``DIART_TPU_*`` switches from the environment, so
    the configuration's ``precision`` alone decides (pattern of
    ``chip_smoke.py`` ``scrub_policy_variables``, :5244 at 50f33b4)."""
    gone = sorted(k for k in os.environ if k.startswith("DIART_TPU_"))
    for k in gone:
        del os.environ[k]
    return gone


# --------------------------------------------------------------------- #
# Weights from the seed
# --------------------------------------------------------------------- #
def _module(spec: dict) -> torch.nn.Module:
    """The port's module class a configuration names, built on the host
    (its parameters' shapes and the SincNet cutoffs' mel init)."""
    cls = getattr(importlib.import_module(spec["module"]), spec["class"])
    args = {k: tuple(v) if isinstance(v, list) else v for k, v in spec["args"].items()}
    return cls(**args)


# a BiLSTM layer's stacked (direction, 4H, in) weights: fan-in is the last axis
RECURRENT = re.compile(r"l\d+_w_(ih|hh)$")


def _init_kind(name: str, shape) -> str:
    """How a parameter starts: the SincNet cutoffs keep their mel init;
    matrices and convolutions draw LeCun-normal values (as the port's
    registry does, its recurrent weights included); norm scales and
    variances start at 1; biases and means at 0."""
    if name.endswith(("low_hz", "band_hz")):
        return "mel"
    if len(shape) >= 2 and not name.endswith("_b"):
        return "normal"
    if name.endswith(("scale", "var")):
        return "one"
    return "zero"


def make_weights(spec: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The raw float32 parameters of one model, made on ``device`` from
    ``gen`` in one draw: {name: tensor}, keyed as the module's state dict.
    ``spec["perturb_sinc"]``: the relative spread of a multiplicative
    perturbation of the SincNet cutoffs, so the two models' filterbanks are
    distinct, as with a real checkpoint pair (pattern of ``bench.py``
    ``_distinct_filterbanks``, :79 at 50f33b4)."""
    init = _module(spec).state_dict()
    shapes = {k: tuple(v.shape) for k, v in init.items()}
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in names]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    perturb = float(spec.get("perturb_sinc", 0.0))
    for name, size in zip(names, sizes):
        shape, part = shapes[name], draw[at:at + size]
        at += size
        kind = _init_kind(name, shape)
        if kind == "normal":
            fan_in = shape[-1] if RECURRENT.search(name) else size // shape[0]
            out[name] = (part / fan_in ** 0.5).view(shape)
        elif kind == "mel":
            out[name] = init[name].to(device) * (1.0 + perturb * part.view(shape))
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def seeded_generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``salt``) of a run's seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + salt) % (2**63))


def make_all_weights(config: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"segmentation": ..., "embedding": ...} raw weights of the seed."""
    return {role: make_weights(config[role], seeded_generator(seed, i + 1, device), device)
            for i, role in enumerate(("segmentation", "embedding"))}


# --------------------------------------------------------------------- #
# Audio from the seed
# --------------------------------------------------------------------- #
def make_pool(traffic: dict, streams: int, seed: int, device, step: int = 8000) -> np.ndarray:
    """int16 PCM (blocks, streams, step): noise bursts under a per-stream
    loudness envelope, so windows differ (pattern of ``chip_smoke.py``
    ``make_audio``, :1087 at 50f33b4), made on ``device`` in one draw. A
    stream's hop ``h`` takes block ``h % blocks``: the audio repeats every
    ``blocks`` hops, so the reference recomputes ``blocks`` windows a
    stream."""
    blocks = int(traffic["audio_blocks"])
    gen = seeded_generator(seed, 0, device)
    noise = torch.randn((blocks, streams, step), generator=gen, device=device)
    t = torch.arange(blocks * step, device=device, dtype=torch.float64).view(blocks, 1, step) / 16000.0
    freq = 0.2 + 0.05 * torch.arange(streams, device=device, dtype=torch.float64).view(1, streams, 1)
    env = (0.5 + 0.5 * torch.sin(2 * np.pi * freq * t)).float()
    pcm = torch.clamp(noise * env * float(traffic["audio_scale"]), -32768, 32767).to(torch.int16)
    return pcm.cpu().numpy()


class StreamAudio:
    """Which audio each served stream hears: stream ``i`` of cohort ``j``
    reads pool column ``(i + j * cohort_offset) % columns`` shifted by
    ``j * time_offset`` blocks, so cohorts do not hear the same audio. One
    cohort's blocks of a hop are a contiguous view of the pool when its
    columns do not wrap."""

    def __init__(self, pool: np.ndarray, batch: int, cohort_offset: int = 0, time_offset: int = 0):
        self.pool, self.batch = pool, batch
        self.cohort_offset, self.time_offset = cohort_offset, time_offset

    def key(self, cohort: int, stream: int) -> Tuple[int, int]:
        """(pool column, time offset) of one stream."""
        return (stream + cohort * self.cohort_offset) % self.pool.shape[1], cohort * self.time_offset

    def blocks(self, cohort: int, hop: int) -> np.ndarray:
        """(batch, step) int16 blocks of one cohort's hop."""
        row = self.pool[(hop + cohort * self.time_offset) % self.pool.shape[0]]
        lo = (cohort * self.cohort_offset) % self.pool.shape[1]
        if lo + self.batch <= self.pool.shape[1]:
            return row[lo:lo + self.batch]
        return np.take(row, np.arange(lo, lo + self.batch) % self.pool.shape[1], axis=0)

    def window(self, key: Tuple[int, int], hop: int, hops: int) -> np.ndarray:
        """A stream's last ``hops`` blocks up to hop ``hop``, as one window."""
        column, offset = key
        rows = [(h + offset) % self.pool.shape[0] for h in range(hop - hops + 1, hop + 1)]
        return self.pool[rows, column].reshape(-1)


# --------------------------------------------------------------------- #
# The port's engine
# --------------------------------------------------------------------- #
def build_engine(config: dict, weights: dict, batch: int, device):
    """The port's ``MultiStreamEngine`` for ``batch`` streams, with the
    configuration's models holding ``weights`` and its explicit precision
    policy."""
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel
    from diart_tpu_torch.precision import Precision

    models = {}
    for role, wrapper in (("segmentation", SegmentationModel), ("embedding", EmbeddingModel)):
        spec = config[role]
        module = _module(dict(spec, args=dict(spec["args"], compute_dtype=_dtype(spec["dtype"]))))
        module = module.to(device).eval().requires_grad_(False)
        module.load_state_dict(weights[role])
        models[role] = wrapper(module, spec["name"], device)
    e = config["engine"]
    return MultiStreamEngine(
        models["segmentation"], models["embedding"], duration=e["duration"], step=e["step"],
        latency=e["latency"], sample_rate=e["sample_rate"], tau_active=e["tau_active"],
        rho_update=e["rho_update"], delta_new=e["delta_new"], gamma=e["gamma"], beta=e["beta"],
        max_speakers=e["max_speakers"], batch_size=batch, precision=Precision(**config["precision"]),
    )


def _dtype(name: str) -> torch.dtype:
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]
