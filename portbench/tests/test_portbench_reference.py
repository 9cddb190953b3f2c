"""The plain reference against the port on the CPU (the port's plain
versions) at full width on two windows, and the whole check at a tiny
size: a sound run of each cell comes out correct."""

import numpy as np
import pytest
import torch

from portbench import cell as cells, reference
from portbench.reference.common import Numerics
from portbench.reference.online import Clustering, Geometry, permute, render_rttm

CONFIGS = ["pyannet-xvector", "pyannet-ecapa-bf16"]


def load(name):
    import json

    return json.loads((cells.HERE / "configs" / f"{name}.json").read_text())


def port_frame_scores(config, weights, waves):
    """The port's models (CPU: plain versions, f32 compute) on the windows."""
    from diart_tpu_torch.ops.functional import normalize_embeddings, overlapped_speech_penalty

    mods = {}
    for role in ("segmentation", "embedding"):
        spec = config[role]
        m = cells._module(dict(spec, args=dict(spec["args"], compute_dtype=torch.float32))).eval()
        m.load_state_dict(weights[role])
        mods[role] = m
    with torch.no_grad():
        wave = waves[:, None, :]
        seg = mods["segmentation"](wave)
        w = overlapped_speech_penalty(seg, 3.0, 10.0).transpose(1, 2)
        emb = mods["embedding"].head(mods["embedding"].trunk(wave), w)
    return seg.double().numpy(), normalize_embeddings(emb, 1.0).double().numpy()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_models_against_port(name):
    config = load(name)
    weights = cells.make_all_weights(config, 123456789012, "cpu")
    pool = cells.make_pool({"audio_blocks": 10, "audio_scale": 4000}, 2, 7, "cpu")
    waves = torch.from_numpy(pool.transpose(1, 0, 2).reshape(2, -1).astype(np.float32) / 32768.0)
    seg, emb = reference.frame_scores(config, weights["segmentation"], weights["embedding"], waves,
                                      Numerics(config["precision_of_parts"]))
    pseg, pemb = port_frame_scores(config, weights, waves)
    assert seg.shape == pseg.shape == (2, 293, 4)
    assert np.abs(seg - pseg).max() < 1e-5
    assert np.abs(emb - pemb).max() < 1e-4
    low, _ = reference.frame_scores(config, weights["segmentation"], weights["embedding"], waves,
                                    Numerics(config["precision_of_parts"], lower=True))
    assert np.abs(low - seg).max() > 10 * np.abs(seg - pseg).max()


def test_geometry_and_text_against_port():
    from diart_tpu_torch.core.segment import SlidingWindow, SlidingWindowFeature
    from diart_tpu_torch.ops.aggregation import build_geometry
    from diart_tpu_torch.ops.binarize import binarize_rttm

    port = build_geometry(5.0, 0.5, 0.5, 293)
    g = Geometry(5.0, 0.5, 0.5, 293)
    assert np.array_equal(g.focus, port.indices[0, 0]) and np.array_equal(g.first, port.first_indices)
    assert g.out_resolution == port.out_resolution and g.first_resolution == port.first_resolution
    rng = np.random.default_rng(0)
    for chunk in (0, 7):
        rows = g.first if chunk == 0 else g.focus
        res = g.first_resolution if chunk == 0 else g.out_resolution
        scores = rng.uniform(0.3, 0.6, (len(rows), 20))
        want = binarize_rttm(SlidingWindowFeature(scores, SlidingWindow(start=g.window_start(chunk),
                                                                        duration=res, step=res)), 0.45, uri="u")
        assert render_rttm(scores > 0.45, "u", g.window_start(chunk), res) == want


def test_clustering_against_port():
    from diart_tpu_torch.ops.clustering import ClusteringParams, cluster_step, init_state

    rng = np.random.default_rng(1)
    state = init_state(1, 20, 8)
    clus = Clustering(20, 0.45, 0.3, 1.0)
    for hop in range(12):
        seg = rng.uniform(0.2, 0.9, (50, 4)) * (rng.uniform(size=4) > 0.2)
        emb = rng.normal(size=(4, 8))
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        state, perm, _ = cluster_step(state, torch.from_numpy(seg[None]).float(),
                                      torch.from_numpy(emb[None]).float(), ClusteringParams(0.45, 0.3, 1.0))
        mine = permute(seg, clus.step(seg, emb), 20)
        assert np.abs(mine - perm[0].double().numpy()).max() < 1e-6, hop


def small(name, **over):
    cell, config, traffic = cells.resolve(name)
    traffic = dict(traffic, batch=2, pool_streams=4, audio_blocks=12, checked_streams=2, settle_hops=1,
                   trace_seconds=1, **over)
    if traffic["mode"] == "open":
        traffic["cohorts"] = 2
    return cell, config, traffic


@pytest.mark.parametrize("name", ["xvector.saturate", "xvector.realtime"])
def test_sound_run_is_correct(name):
    from portbench.run import run_cell

    cell, config, traffic = small(name)
    res = run_cell(cell, config, traffic, cells.load_benchmark(), 2**31 + 11, 1.0, False, device="cpu")
    assert res["correct"], res["check"]
    assert res["check"]["hops_judged"]["value"] > 4
