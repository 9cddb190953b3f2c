"""Write ``tests/golden/jax_files/``: files that diart_tpu writes, with
diart_tpu's outputs beside them, for the port to read.

Run from the repo root:  python tests/make_jax_files.py   (JAX on the CPU)

* ``models/``: a narrow model file of each of the six module classes
  (``save``: flax msgpack plus ``<file>.json``; the x-vector's under a
  ``.npz`` suffix, which diart_tpu writes as msgpack too);
* ``session.msgpack`` (+ ``session.json``): a 2-stream x-vector session of
  the PyanNet and x-vector files above (2 s window, 0.5 s hops) saved after
  ``SESSION_HOPS`` hops;
* ``train/``: the segmentation trainer's directory (``step_00000002.msgpack``
  and ``latest.json``) after 2 AdamW steps from the PyanNet file, and
  ``train_after.msgpack``: its parameters after 2 more;
* ``outputs.npz``: the inputs and diart_tpu's outputs: each model's on a
  seeded waveform (``<name>:out``), the session's next hops' int16 blocks,
  aggregated scores and RTTM text, the training batch, and as JSON the
  engine's arguments (``session:engine``) and the learning rate
  (``train:lr``), which the readers (``tests/test_torch_jax_files.py``,
  ``chip_smoke.py``) take from here.

The narrowest ECAPA the card's SE-Res2Block kernel takes (64-wide groups,
two of them) holds 1.4 MB of f32 parameters: most of the folder's bytes.
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))

from diart_tpu import precision  # noqa: E402
from diart_tpu.models import EmbeddingModel, SegmentationModel  # noqa: E402
from diart_tpu.models.ecapa import EcapaTDNN  # noqa: E402
from diart_tpu.models.embedding import XVectorSincNet  # noqa: E402
from diart_tpu.models.resnet import ResNet34  # noqa: E402
from diart_tpu.models.segmentation import PyanNet  # noqa: E402
from diart_tpu.models.titanet import TitaNet  # noqa: E402
from diart_tpu.models.xvect import XVectorFbank  # noqa: E402
from diart_tpu.parallel import MultiStreamEngine, MultiStreamSession  # noqa: E402
from diart_tpu.train import make_train_state, save_train_state, train_step  # noqa: E402

OUT = Path(__file__).parent / "golden" / "jax_files"
SMALL_TDNN = ((5, 1, 32), (3, 2, 32), (3, 3, 32), (1, 1, 32), (1, 1, 64))
# file name -> (role, module)
MODELS = {
    "pyannet.msgpack": ("segmentation", PyanNet(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))),
    "xvector.npz": ("embedding", XVectorSincNet(embedding_dim=16, tdnn_specs=SMALL_TDNN)),
    # 64-wide res2 groups and H = 16: the widths the card's kernels take
    "ecapa.msgpack": ("embedding", EcapaTDNN(embedding_dim=16, channels=128, num_mels=24, res2_scale=2,
                                             attention_bottleneck=16, se_bottleneck=16)),
    "resnet34.msgpack": ("embedding", ResNet34(embedding_dim=16, base_channels=2, num_mels=24)),
    "titanet.msgpack": ("embedding", TitaNet(embedding_dim=16, channels=32, num_mels=24,
                                             attention_bottleneck=16)),
    "xvect_sb.msgpack": ("embedding", XVectorFbank(embedding_dim=16, num_mels=24, tdnn_specs=SMALL_TDNN)),
}
INPUT_SAMPLES, SPEAKERS, WEIGHT_FRAMES = 8000, 3, 40
ENGINE_KW = dict(duration=2.0, step=0.5, latency=0.5, sample_rate=16000, max_speakers=4, batch_size=2,
                 tau_active=0.45, rho_update=0.05)
SESSION_HOPS, RESUME_HOPS = 6, 4
TRAIN_LR, TRAIN_SAMPLES = 1e-3, 4000


def _model(cls, module, seed):
    """A diart_tpu model of ``module`` with seeded parameters (init as one
    compiled program)."""
    with precision.use(precision.Precision.portable(), force=True):
        params = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 1, 8000)))
    return cls(lambda: (module, params, {"sample_rate": 16000})).load()


def _tones(rng, hops, batch, step):
    """int16 PCM blocks (hops, batch, step): tones under noise, loudness
    per stream."""
    t = np.arange(hops * step) / 16000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * (300.0 + 170.0 * b) * t) for b in range(batch)])
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 0.3 * t))[None] + 0.05 * rng.normal(size=sig.shape)
    pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
    return pcm.reshape(batch, hops, step).transpose(1, 0, 2).copy()


def main():
    (OUT / "models").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    outputs = {
        "wave": (0.1 * rng.normal(size=(2, 1, INPUT_SAMPLES))).astype(np.float32),
        "weights": rng.uniform(size=(2, SPEAKERS, WEIGHT_FRAMES)).astype(np.float32),
    }
    for seed, (name, (role, module)) in enumerate(MODELS.items()):
        cls = SegmentationModel if role == "segmentation" else EmbeddingModel
        path = OUT / "models" / name
        _model(cls, module, seed).save(path)
        model = cls.from_pretrained(str(path))  # diart_tpu reads it back
        wave = jnp.asarray(outputs["wave"])
        if role == "segmentation":
            out = model(wave)
        else:
            model.load()
            frames = model.trunk_fn()(model.params, wave)
            out = model.head_fn()(model.params, frames, jnp.asarray(outputs["weights"]))
        outputs[f"{name}:out"] = np.asarray(out)

    # the session: 2 streams of the PyanNet and x-vector files
    seg = SegmentationModel.from_pretrained(str(OUT / "models" / "pyannet.msgpack"))
    emb = EmbeddingModel.from_pretrained(str(OUT / "models" / "xvector.npz"))
    engine = MultiStreamEngine(segmentation=seg, embedding=emb, **ENGINE_KW)
    record = []
    step = engine.step

    def spy(state, blocks, audio_mask=None, run_mask=None):
        state, out = step(state, blocks, audio_mask, run_mask)
        record.append(np.asarray(out.aggregated))
        return state, out

    engine.step = spy
    session = MultiStreamSession(engine, tau_active=ENGINE_KW["tau_active"], collect_audio=False)
    blocks = _tones(rng, SESSION_HOPS + RESUME_HOPS, 2, 8000)
    for hop in range(SESSION_HOPS):
        session.push_rttm(blocks[hop])
    session.save(OUT / "session.msgpack")
    record.clear()
    texts = [session.push_rttm(blocks[hop]) for hop in range(SESSION_HOPS, SESSION_HOPS + RESUME_HOPS)]
    outputs["session:blocks"] = blocks[SESSION_HOPS:]
    outputs["session:aggregated"] = np.stack(record)
    # per hop, each stream's text (empty while it emits none), NUL-joined
    outputs["session:rttm"] = np.array(["\x00".join(t or "" for t in hop).encode() for hop in texts])

    # the segmentation trainer: 2 steps, a checkpoint, 2 more
    waves = (0.1 * rng.normal(size=(2, 1, TRAIN_SAMPLES))).astype(np.float32)
    apply_fn = seg.apply_fn()
    frames = jax.eval_shape(apply_fn, seg.params, jnp.asarray(waves)).shape[1]
    targets = (rng.uniform(size=(2, frames, 3)) > 0.6).astype(np.float32)
    state, tx = make_train_state(seg.params, learning_rate=TRAIN_LR)
    step_fn = jax.jit(lambda s: train_step(apply_fn, tx, s, jnp.asarray(waves), jnp.asarray(targets)))
    for _ in range(2):
        state, _ = step_fn(state)
    save_train_state(OUT / "train", state)
    for _ in range(2):
        state, _ = step_fn(state)
    from flax import serialization

    (OUT / "train_after.msgpack").write_bytes(serialization.to_bytes(state.params))
    outputs["train:waves"], outputs["train:targets"] = waves, targets
    outputs["train:lr"] = np.float32(TRAIN_LR)
    outputs["session:engine"] = np.array(json.dumps(ENGINE_KW).encode())
    np.savez(OUT / "outputs.npz", **outputs)
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(json.dumps({p.relative_to(OUT).as_posix(): p.stat().st_size
                      for p in sorted(OUT.rglob("*")) if p.is_file()}, indent=1))
    print(f"wrote {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
