"""One rank of the port's two-process run (``tests/test_torch_mesh.py``).

Launched twice with ``DIART_TPU_COORDINATOR`` / ``DIART_TPU_NUM_PROCESSES``
/ ``DIART_TPU_PROCESS_ID`` set; ``jax``, ``diart_tpu`` and ``pandas`` are
made unimportable first, so the rank runs on ``diart_tpu_torch`` alone.
It joins the ``gloo`` group through ``streams_mesh`` (two CPU shard slots
a rank: a global mesh of four), then

* drives the sharded engine over its half of the streams and writes its
  rows of the final aggregated scores and centers;
* takes one data-parallel AAM step of the x-vector (its half of 8 samples,
  over a one-device mesh) and one PIT-BCE step of the segmentation model
  (over the process group), and writes the losses, the gradients and the
  parameters after each step; saves a checkpoint into a directory of its
  own (only rank 0's gets a file).

Everything it builds comes from seeds and files the parent wrote, so the
parent repeats the same work in one process. Usage:
``python tests/torch_mesh_child.py <outdir>``.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)
ENGINE_KW = dict(duration=0.5, step=0.25, latency=0.5, sample_rate=16000, max_speakers=4,
                 tau_active=0.45, rho_update=0.05)
BATCH, HOPS, STEP_SAMPLES = 8, 8, 4000
TRAIN_BATCH, TRAIN_SAMPLES, CLASSES, LR = 8, 8000, 3, 1e-3


def models(outdir):
    """The segmentation model from a seed; the x-vector with the weights the
    parent wrote to ``<outdir>/xvector.pt`` (JAX's, carried over)."""
    from diart_tpu_torch import EmbeddingModel, SegmentationModel

    seg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", seed=3, **SEG_KW)
    emb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", seed=4, **EMB_KW)
    emb.module.load_state_dict(torch.load(os.path.join(outdir, "xvector.pt"), weights_only=True))
    return seg, emb


def engine_blocks():
    return np.random.default_rng(5).normal(scale=0.1, size=(HOPS, BATCH, STEP_SAMPLES)).astype(np.float32)


def run_engine(engine, rows: slice):
    """HOPS hops with warm-up masks over the streams ``rows``; a pause of
    stream 1 at hop 3. Returns the last output and state."""
    blocks = engine_blocks()[:, rows]
    state = engine.init_state()
    warmup = int(round(engine.duration / engine.step_duration))
    out = None
    for i in range(HOPS):
        present = np.ones(BATCH, bool)
        if i == 3:
            present[1] = False
        present = present[rows]
        state, out = engine.step(state, blocks[i], present, present & (i + 1 >= warmup))
    return state, out


def train_data():
    rng = np.random.default_rng(6)
    waves = rng.normal(scale=0.2, size=(TRAIN_BATCH, 1, TRAIN_SAMPLES)).astype(np.float32)
    labels = np.arange(TRAIN_BATCH) % CLASSES
    return torch.from_numpy(waves), torch.from_numpy(labels)


def train_steps(seg, emb, dp_emb=None, dp_seg=None):
    """One AAM step and one PIT-BCE step; returns {name: array} with the
    losses, the first gradients and the parameters after each step."""
    from diart_tpu_torch.train import (
        embedding_train_step,
        make_embedding_train_state,
        make_train_state,
        train_step,
    )

    waves, labels = train_data()
    out = {}
    state, opt = make_embedding_train_state(emb, CLASSES, EMB_KW["embedding_dim"], learning_rate=LR, seed=2)
    state, loss = embedding_train_step(lambda m, x: m(x), opt, state, waves, labels, dp=dp_emb)
    out["emb_loss"] = loss.numpy()
    for n, p in [*state.module.named_parameters(), ("prototypes", state.prototypes)]:
        out[f"emb_grad/{n}"] = p.grad.numpy()
        out[f"emb_param/{n}"] = p.detach().numpy()
    with torch.no_grad():
        frames = seg.module(waves).shape[1]
    targets = torch.from_numpy(
        (np.random.default_rng(7).uniform(size=(TRAIN_BATCH, frames, SEG_KW["num_speakers"])) > 0.6)
        .astype(np.float32))
    sstate, sopt = make_train_state(seg, learning_rate=LR)
    sstate, sloss = train_step(lambda m, x: m(x), sopt, sstate, waves, targets, dp=dp_seg)
    out["seg_loss"] = sloss.numpy()
    for n, p in sstate.module.named_parameters():
        out[f"seg_grad/{n}"] = p.grad.numpy()
        out[f"seg_param/{n}"] = p.detach().numpy()
    return out, sstate


def main():
    import torch.distributed as dist

    from diart_tpu_torch.parallel import MultiStreamEngine, streams_mesh
    from diart_tpu_torch.train import save_train_state

    outdir = sys.argv[1]
    mesh = streams_mesh(devices=["cpu", "cpu"])
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert mesh.world_size == 2 and mesh.size == 4 and mesh.rank == int(os.environ["DIART_TPU_PROCESS_ID"])
    seg, emb = models(outdir)
    engine = MultiStreamEngine(seg, emb, batch_size=BATCH, mesh=mesh, **ENGINE_KW)
    rows = mesh.local_slice(BATCH)
    assert engine.batch_size == rows.stop - rows.start == BATCH // 2
    state, out = run_engine(engine, rows)
    dump = {"rows": np.array([rows.start, rows.stop]), "agg": out.aggregated.cpu().numpy(),
            "centers": state.centers.cpu().numpy()}
    seg, emb = models(outdir)  # fresh weights for training
    trained, sstate = train_steps(seg, emb, dp_emb=streams_mesh(devices=["cpu"]), dp_seg=dist.group.WORLD)
    dump.update(trained)
    # a directory a rank: only rank 0's holds a file afterwards
    save_train_state(os.path.join(outdir, f"ckpt{mesh.rank}"), sstate)
    dist.barrier()
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), **dump)
    assert not any(sys.modules.get(n) for n in ("jax", "diart_tpu", "pandas"))
    dist.destroy_process_group()
    print(f"rank{mesh.rank}: ok", flush=True)


if __name__ == "__main__":
    for name in ("jax", "diart_tpu", "pandas"):
        sys.modules[name] = None  # the rank must not need them
    main()
