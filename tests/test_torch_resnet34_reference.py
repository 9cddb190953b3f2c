"""The benchmark's plain WeSpeaker ResNet34 reference
(``portbench/reference/resnet34.py``) against the port's ``ResNet34`` on the
CPU, on seeded random weights made as the benchmark makes them
(``portbench.cell.make_weights``) at ``base_channels`` 8 and 1-2 s windows:
its kaldi fbank against ``models/fbank.py``'s, its embedding against the
port's trunk and weighted head (uniform weights, an all-zero speaker, the
engine's kaldi frame ring), and the whole ``frame_scores`` of the
``pyannet-resnet34-bf16`` configuration against the port's engine over a
few hops. Each tolerance is set between the port's float32 reading and what
the same comparison reads one precision step lower (the trunk in bfloat16,
the fbank in bfloat16).
"""

import json

import numpy as np
import pytest
import torch

from diart_tpu_torch.models.fbank import kaldi_log_mel
from diart_tpu_torch.ops.functional import normalize_embeddings
from portbench import cell as cells
from portbench import reference
from portbench.reference import resnet34 as ref
from portbench.reference.common import Numerics

CONFIG = json.loads((cells.HERE / "configs" / "pyannet-resnet34-bf16.json").read_text())
ARGS = dict(CONFIG["embedding"]["args"], base_channels=8)
NUM = Numerics(CONFIG["precision_of_parts"])
LOWER = Numerics(CONFIG["precision_of_parts"], lower=True)

# the fbank's log energies: the port's DFT convolution and torch.fft round
# differently, and a mel bin's log is off by its energy's rounding relative
# to the frame's total energy, 3.5e-4 at most on these windows; the power
# and mel energies in bfloat16 read 8.5e-3
FBANK_TOL = 1e-3
# unit embeddings, float32 on both sides: 2.5e-7 apart (the folded batch
# norm, the sums' order); the trunk in bfloat16 reads 8.6e-4
EMB_TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _weights(seed=5):
    spec = dict(CONFIG["embedding"], args=ARGS)
    return cells.make_weights(spec, torch.Generator().manual_seed(seed), "cpu")


def _port(weights, dtype=torch.float32):
    spec = CONFIG["embedding"]
    m = cells._module(dict(spec, args=dict(ARGS, compute_dtype=dtype))).eval()
    m.load_state_dict(weights)
    return m


def _waves(n, samples, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).normal(scale=0.1, size=(n, samples)).astype(np.float32))


def _port_embed(m, feats_or_wave, weights, raw=False):
    with torch.no_grad():
        frames = m.trunk_from_raw_fbank(feats_or_wave) if raw else m.trunk(feats_or_wave[:, None])
        return normalize_embeddings(m.head(frames, weights), 1.0)


def test_kaldi_fbank_against_port():
    waves = _waves(3, 24000)
    want = kaldi_log_mel(waves)
    got = ref.kaldi_fbank(waves, NUM)
    assert got.shape == want.shape == (3, 148, 80)
    assert (got - want).abs().max() < FBANK_TOL
    assert (ref.kaldi_fbank(waves, LOWER) - want).abs().max() > 2 * FBANK_TOL


def test_kaldi_mel_triangles_against_port():
    from diart_tpu_torch.models.fbank import kaldi_mel_matrix

    mel = ref.kaldi_mel()
    assert mel.shape == (80, 257) and not mel[:, -1].any()
    assert np.abs(mel[:, :-1] - kaldi_mel_matrix(80, 512, 16000)).max() < 1e-6


@pytest.mark.parametrize("kind", ["weighted", "uniform", "zero_speaker"])
def test_embed_against_port(kind):
    weights = _weights()
    waves = _waves(2, 32000)
    frames = 198  # the segmentation's frames a window; resampled to the trunk's
    w = torch.rand(2, 3, frames, generator=torch.Generator().manual_seed(1))
    if kind == "uniform":
        w = torch.ones_like(w)
    elif kind == "zero_speaker":
        w[:, 1] = 0.0
    with torch.no_grad():
        got = ref.embed(weights, waves[:, None], w, NUM, ARGS)
    want = _port_embed(_port(weights), waves, w)
    assert got.shape == want.shape == (2, 3, 256)
    assert (got - want).abs().max() < EMB_TOL
    assert (_port_embed(_port(weights, torch.bfloat16), waves, w) - got).abs().max() > 10 * EMB_TOL


def test_uniform_weights_are_tstp():
    """Uniform weights pool to wespeaker's TSTP: the mean and the unbiased
    standard deviation with 1e-7 under the root."""
    frames = torch.randn(2, 7, 5, dtype=torch.float64).float()
    got = ref.weighted_tstp(frames, torch.ones(2, 1, 7), NUM)[:, 0]
    want = torch.cat([frames.mean(1), torch.sqrt(frames.var(1, unbiased=True) + 1e-7)], dim=-1)
    assert (got - want).abs().max() < 1e-6


def test_ring_route_against_reference():
    """The engine's kaldi frame ring: the raw frames it assembles for a
    window, through the port's ``trunk_from_raw_fbank`` and head, against the
    reference's embedding of the same window's waveform."""
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel
    from diart_tpu_torch.precision import Precision

    weights = _weights()
    seg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=3, num_speakers=3, lstm_hidden=8,
                                          lstm_layers=1, linear_dims=(8,))
    engine = MultiStreamEngine(seg, EmbeddingModel(_port(weights), "tpu/resnet34", "cpu"), duration=1.5, step=0.5,
                               latency=0.5, batch_size=2, precision=Precision(fbank_ring=True))
    assert engine._fring is not None and engine._fring.kind == "kaldi"
    blocks = _waves(5, 2 * 8000, seed=9).view(5, 2, 8000)
    audio = engine.init_state().audio
    mask = torch.ones(2, dtype=torch.bool)
    w = torch.rand(2, 3, 100, generator=torch.Generator().manual_seed(2))
    for hop in range(5):
        audio, window, raw = engine._advance_audio(audio, blocks[hop], mask)
        got = _port_embed(engine._emb.module, raw, w, raw=True)
        with torch.no_grad():
            want = ref.embed(weights, window[:, None], w, NUM, ARGS)
        assert (got - want).abs().max() < EMB_TOL, hop


def test_frame_scores_against_engine():
    """``portbench.reference.frame_scores`` of the configuration (float32
    trunk, base_channels 8, 2 s windows) against what the port's engine
    computes for the same windows over a few hops, through the frame ring."""
    config = json.loads(json.dumps(CONFIG))
    config["embedding"]["args"] = ARGS
    config["embedding"]["dtype"] = "f32"
    config["engine"]["duration"] = 2.0
    weights = cells.make_all_weights(config, 2**31 + 5, "cpu")
    engine = cells.build_engine(config, weights, 2, "cpu")
    assert engine._fring is not None
    blocks = _waves(6, 2 * 8000, seed=11).view(6, 2, 8000)
    state = engine.init_state()
    hops_window = 4
    for hop in range(6):
        pseg, pemb = engine.probe_frame_scores(state, blocks[hop])
        state, _ = engine.step(state, blocks[hop])
        if hop < hops_window - 1:
            continue
        waves = blocks[hop - hops_window + 1:hop + 1].transpose(0, 1).reshape(2, -1)
        seg, emb = reference.frame_scores(config, weights["segmentation"], weights["embedding"], waves, NUM)
        # the segmentation: the same f32 forward (tests/portbench's 1e-5);
        # the embeddings: EMB_TOL, the OSP weights taken from it as well
        assert np.abs(seg - pseg.double().numpy()).max() < 1e-5, hop
        assert np.abs(emb - pemb.double().numpy()).max() < EMB_TOL, hop
