"""Parity of the port's serving path (step output -> RTTM) with diart_tpu.

Host modules (``core/segment.py``, ``core/annotation.py``,
``ops/binarize.py``, the native assembler) are held against the JAX
package's on seeded inputs, with RTTM strings compared exactly. The session
runs on the CPU beside ``diart_tpu.parallel.MultiStreamSession`` with the
same weights (the flax init carried over by ``load_flax_params``) and audio;
the engines agree to atol 1e-4 (``test_torch_engine.py``), so the test also
shows that no score the RTTM depends on lies within 1e-4 of the threshold.
The rest are the port's own equivalents of the JAX session tests
(``tests/test_engine.py``, ``tests/test_tools.py``).
"""

import ctypes
import importlib
import json
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from diart_tpu import native as jax_native
from diart_tpu.core import annotation as jax_annotation
from diart_tpu.core import segment as jax_segment
from diart_tpu.models import EmbeddingModel as JaxEmbeddingModel
from diart_tpu.models import SegmentationModel as JaxSegmentationModel
from diart_tpu.parallel import MultiStreamEngine as JaxMultiStreamEngine
from diart_tpu.parallel import MultiStreamSession as JaxMultiStreamSession
from diart_tpu_torch import (
    CohortScheduler,
    EmbeddingModel,
    MultiStreamEngine,
    MultiStreamSession,
    SegmentationModel,
)
from diart_tpu_torch import native, tracing
from diart_tpu_torch.core import annotation, segment
from diart_tpu_torch.ops import binarize
from diart_tpu_torch.parallel.engine import to_device
from diart_tpu_torch.precision import Precision

SEG_KW = dict(num_speakers=3, lstm_hidden=8, lstm_layers=1, linear_dims=(8,))
EMB_KW = dict(embedding_dim=16)
ENGINE_KW = dict(duration=0.5, step=0.25, latency=0.5, sample_rate=16000, max_speakers=4)
TAU = 0.45
# thresholds low enough that the random models' ~0.5 activations map speakers
DIAR_KW = dict(ENGINE_KW, tau_active=TAU, rho_update=0.05)
BATCH, HOPS, STEP_SAMPLES = 3, 12, 4000
# the module, not the function diart_tpu.ops exports under its name
jax_binarize = importlib.import_module("diart_tpu.ops.binarize")
RES = 5.0 / 293.0  # the serving out_resolution's irrational-ish flavour


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jseg = JaxSegmentationModel.from_registry("tpu/pyannet", init_samples=8000, **SEG_KW).load()
    jemb = JaxEmbeddingModel.from_registry("tpu/xvector", init_samples=8000, **EMB_KW).load()
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)
    pseg = SegmentationModel.from_registry("tpu/pyannet", device="cpu", flax_params=tree(jseg), **SEG_KW)
    pemb = EmbeddingModel.from_registry("tpu/xvector", device="cpu", flax_params=tree(jemb), **EMB_KW)
    return (jseg, jemb), (pseg, pemb)


def _engine(models, batch=BATCH, vad=False):
    _, (pseg, pemb) = models
    kw = ENGINE_KW if vad else DIAR_KW
    return MultiStreamEngine(pseg, None if vad else pemb, batch_size=batch, **kw)


def _blocks(seed=21, hops=HOPS, batch=BATCH):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.1, size=(hops, batch, STEP_SAMPLES)).astype(np.float32)


def _schedule(hops=HOPS, batch=BATCH):
    """Per hop: (present, reset of slot 0 after the hop). Stream 1 pauses at
    hop 4; slot 0 is recycled after hop 6 under a new uri and shift, and
    warms up again."""
    plan = []
    for i in range(hops):
        present = np.ones(batch, bool)
        if i == 4:
            present[1] = False
        plan.append((present, i == 6))
    return plan


def _drive(session, blocks, route):
    """Texts per hop: ``push_rttm``'s list, or ``push``'s annotations as RTTM."""
    texts = []
    for blk, (present, reset) in zip(blocks, _schedule(len(blocks), blocks.shape[1])):
        if route == "rttm":
            texts.append(session.push_rttm(blk, present))
        else:
            texts.append([None if o is None else o[0].to_rttm() for o in session.push(blk, present)])
        if reset:
            session.reset_slot(0, uri="fresh", shift=1.5)
    return texts


# --------------------------------------------------------------------- #
# core/segment.py and core/annotation.py
# --------------------------------------------------------------------- #
def _random_segments(rng, n, mod):
    starts = np.round(rng.uniform(0, 20, n), 3)
    durs = np.round(rng.uniform(0, 3, n), 3)
    durs[::7] = 0.0  # empty segments are dropped by both
    return [mod.Segment(float(s), float(s + d)) for s, d in zip(starts, durs)]


def _as_tuples(segments):
    return [(s.start, s.end) for s in segments]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_and_window_match(seed):
    rng = np.random.default_rng(seed)
    a, b = _random_segments(rng, 2, segment)
    ja, jb = (jax_segment.Segment(s.start, s.end) for s in (a, b))
    for op in (lambda x, y: x & y, lambda x, y: x | y):
        got, want = op(a, b), op(ja, jb)
        assert (got.start, got.end) == (want.start, want.end)
    assert a.gap(b) == ja.gap(jb) and (b in a) == (jb in ja) and str(a) == str(ja)
    assert a.middle == ja.middle and a.intersects(b) == ja.intersects(jb)
    step = float(rng.uniform(0.01, 0.05))
    sw = segment.SlidingWindow(duration=2 * step, step=step, start=0.3, end=1.7)
    jsw = jax_segment.SlidingWindow(duration=2 * step, step=step, start=0.3, end=1.7)
    assert _as_tuples(sw) == _as_tuples(jsw)
    assert (sw[5].start, sw[5].end) == (jsw[5].start, jsw[5].end)
    data = rng.normal(size=(40, 3))
    feat = segment.SlidingWindowFeature(data, sw)
    jfeat = jax_segment.SlidingWindowFeature(data, jsw)
    assert (feat.extent.start, feat.extent.end) == (jfeat.extent.start, jfeat.extent.end)
    for mode in ("loose", "strict", "center"):
        focus = segment.Segment(float(rng.uniform(0, 1)), float(rng.uniform(1, 2.5)))
        jfocus = jax_segment.Segment(focus.start, focus.end)
        for fixed in (None, 0.5):
            assert sw.crop_range(focus, mode, fixed) == jsw.crop_range(jfocus, mode, fixed)
            np.testing.assert_array_equal(feat.crop(focus, mode, fixed), jfeat.crop(jfocus, mode, fixed))
            np.testing.assert_array_equal(
                feat.crop_indices(focus, mode, fixed), jfeat.crop_indices(jfocus, mode, fixed)
            )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_timeline_matches(seed):
    rng = np.random.default_rng(seed)
    segs = _random_segments(rng, 25, segment)
    tl = annotation.Timeline(segs, uri="u")
    jtl = jax_annotation.Timeline([jax_segment.Segment(s.start, s.end) for s in segs], uri="u")
    focus = (2.5, 11.25)
    assert _as_tuples(tl) == _as_tuples(jtl)
    for collar in (0.0, 0.5, 1.0):
        assert _as_tuples(tl.support(collar)) == _as_tuples(jtl.support(collar))
    assert _as_tuples(tl.crop(segment.Segment(*focus))) == _as_tuples(jtl.crop(jax_segment.Segment(*focus)))
    assert _as_tuples(tl.gaps()) == _as_tuples(jtl.gaps())
    assert _as_tuples(tl.gaps(segment.Segment(*focus))) == _as_tuples(jtl.gaps(jax_segment.Segment(*focus)))
    assert tl.duration() == jtl.duration()
    assert tl.to_annotation("speech").to_rttm() == jtl.to_annotation("speech").to_rttm()


def test_support_merges_only_gaps_shorter_than_collar():
    """A gap of exactly the collar stays split, as in the JAX package."""
    tl = annotation.Timeline([segment.Segment(0.0, 1.0), segment.Segment(1.5, 2.0)])
    jtl = jax_annotation.Timeline([jax_segment.Segment(0.0, 1.0), jax_segment.Segment(1.5, 2.0)])
    assert len(tl.support(0.5)) == len(jtl.support(0.5)) == 2
    assert len(tl.support(0.5000001)) == len(jtl.support(0.5000001)) == 1


def _random_annotations(seed):
    rng = np.random.default_rng(seed)
    ann, jann = annotation.Annotation(uri="s/1"), jax_annotation.Annotation(uri="s/1")
    for track, s in enumerate(_random_segments(rng, 30, segment)):
        label = f"speaker{rng.integers(0, 4)}"
        ann[s, track] = label
        jann[jax_segment.Segment(s.start, s.end), track] = label
    return ann, jann


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_annotation_matches(seed, tmp_path):
    ann, jann = _random_annotations(seed)
    assert ann.to_rttm() == jann.to_rttm() and str(ann) == str(jann)
    assert ann.labels() == jann.labels() and ann.chart() == jann.chart()
    for collar in (0.0, 0.25, 1.0):
        assert ann.support(collar).to_rttm() == jann.support(collar).to_rttm()
    assert ann.crop(segment.Segment(3.0, 9.5)).to_rttm() == jann.crop(jax_segment.Segment(3.0, 9.5)).to_rttm()
    assert (ann.extrude(segment.Segment(4.0, 6.0)).to_rttm()
            == jann.extrude(jax_segment.Segment(4.0, 6.0)).to_rttm())
    mapping = {"speaker0": "A", "speaker2": "C"}
    assert ann.rename_labels(mapping).to_rttm() == jann.rename_labels(mapping).to_rttm()
    assert ann.shift(0.125).to_rttm() == jann.shift(0.125).to_rttm()
    other, jother = _random_annotations(seed + 10)
    assert ann.update(other).to_rttm() == jann.update(jother).to_rttm()
    annotation.write_rttm(ann, tmp_path / "port.rttm")
    jax_annotation.write_rttm(jann, tmp_path / "jax.rttm")
    assert (tmp_path / "port.rttm").read_text() == (tmp_path / "jax.rttm").read_text()
    got = annotation.load_rttm(tmp_path / "jax.rttm")
    want = jax_annotation.load_rttm(tmp_path / "port.rttm")
    assert list(got) == list(want)
    assert all(got[u].to_rttm() == want[u].to_rttm() for u in got)


# --------------------------------------------------------------------- #
# ops/binarize.py
# --------------------------------------------------------------------- #
def _scores(rng, b, frames, speakers, fill):
    """Scores with runs of activity; ``fill`` puts cells exactly at f32(TAU)
    ("at") or at the next f32 above it ("next") into the runs."""
    scores = rng.uniform(0, 1, (b, frames, speakers)).astype(np.float32)
    scores[:, ::3] = 0.2  # break runs, so turns start and end inside
    if fill != "random":
        at = np.float32(TAU)
        value = at if fill == "at" else np.nextafter(at, np.float32(1))
        scores[rng.uniform(size=scores.shape) < 0.3] = value
    return scores


SHAPES = [(16, 4), (8, 1), (29, 20), (7, 3)]  # frames x speakers: multiples of 8 and not
FILLS = ["random", "at", "next"]


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("frames,speakers", SHAPES)
def test_binarize_routes_match(frames, speakers, fill):
    rng = np.random.default_rng(frames * 31 + speakers)
    data = _scores(rng, 4, frames, speakers, fill)
    starts = rng.uniform(-3, 100, 4)
    uris = ["a", None, "stream/2", "b" * 40]
    for i in range(4):
        sw = segment.SlidingWindow(start=starts[i], duration=RES, step=RES)
        jsw = jax_segment.SlidingWindow(start=starts[i], duration=RES, step=RES)
        feat = segment.SlidingWindowFeature(data[i], sw)
        jfeat = jax_segment.SlidingWindowFeature(data[i], jsw)
        ann = binarize.binarize(feat, TAU, uris[i])
        assert ann.to_rttm() == jax_binarize.binarize(jfeat, TAU, uris[i]).to_rttm()
        assert binarize.binarize_rttm(feat, TAU, uris[i]) == jax_binarize.binarize_rttm(jfeat, TAU, uris[i])
        assert binarize.binarize_rttm(feat, TAU, uris[i]) == ann.to_rttm()
    want = jax_binarize.batch_binarize_rttm(data, starts, RES, TAU, uris)
    assert binarize.batch_binarize_rttm(data, starts, RES, TAU, uris) == want
    packed = np.packbits((data > np.float32(TAU)).reshape(4, -1), axis=1)
    assert binarize.batch_bits_rttm(packed, frames, speakers, starts, RES, uris) == want
    assert jax_binarize.batch_bits_rttm(packed, frames, speakers, starts, RES, uris) == want
    if fill != "random":
        assert any(want)  # the filled cells made turns


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("frames,speakers", SHAPES)
def test_pack_binarized_bits_matches_jax(frames, speakers, fill):
    rng = np.random.default_rng(frames + 7 * speakers)
    data = _scores(rng, 3, frames, speakers, fill)
    got = binarize.pack_binarized_bits(torch.from_numpy(data), float(TAU))
    want = np.asarray(jax_binarize.pack_binarized_bits(data, np.float32(TAU)))
    assert got.dtype == torch.uint8 and got.shape == (3, binarize.packed_stride(frames, speakers))
    np.testing.assert_array_equal(got.numpy(), want)
    # a cell at exactly f32(tau) is inactive, the next f32 above it active
    probe = torch.full((1, frames, speakers), float(np.float32(TAU)))
    assert not binarize.pack_binarized_bits(probe, TAU).any()
    probe[0, 0, 0] = float(np.nextafter(np.float32(TAU), np.float32(1)))
    assert binarize.pack_binarized_bits(probe, TAU)[0, 0] == 128


# --------------------------------------------------------------------- #
# native/ (the port's own rttm.cpp and loader)
# --------------------------------------------------------------------- #
def _native_case(rng, b, f, s, dense=False):
    if dense:
        scores = rng.uniform(0, 1, (b, f, s)).astype(np.float32)
    else:
        scores = np.zeros((b, f, s), np.float32)
        for i in range(b):
            for _ in range(rng.integers(0, 4)):
                spk, a = rng.integers(0, s), rng.integers(0, f)
                scores[i, a : a + rng.integers(1, f), spk] = rng.uniform(0.61, 1.0)
    starts = rng.uniform(-3, 1000, b)
    uris = [None if i % 5 == 0 else ("u" * 600 if i % 7 == 3 else f"stream/{i}") for i in range(b)]
    return scores, starts, uris


# diart_tpu's rttm.cpp, built apart from diart_tpu.native's own library:
# that loader keeps its build state in module globals and compiles straight
# into its final path, so under parallel test workers one of them can load
# a half-written file and then return None for the rest of its life. The
# port's atomic build (a temporary file, then os.replace) into this
# module's own directory, loaded with the port's signature, is the JAX
# package's C++ with no state shared with any other test.
JAX_RTTM_SRC = Path(jax_native.__file__).resolve().parent / "rttm.cpp"


@pytest.fixture(scope="module")
def jax_rttm_lib(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_rttm") / "librttm.so"
    return native._declare_rttm(ctypes.CDLL(str(native._compile(JAX_RTTM_SRC, path, "RTTM assembler", True))))


def _through(lib, fn, *args, **kw):
    """``fn`` (one of the port's native calls) run on the library ``lib``."""
    saved = native._lib
    native._lib = lib
    try:
        return fn(*args, **kw)
    finally:
        native._lib = saved


def _native_routes(scores, starts, res, tau, uris, jax_lib, emit=None):
    """Every route's texts: the port's native calls (scores and bits), the
    same calls on diart_tpu's rttm.cpp, diart_tpu's numpy batch routes, and
    the port's numpy batch routes (the reference)."""
    b, f, s = scores.shape
    packed = binarize.pack_binarized_bits(torch.from_numpy(scores), float(tau)).numpy()
    routes = {
        "port scores": native.rttm_from_scores(scores, starts, res, tau, uris, emit=emit),
        "port bits": native.rttm_from_bits(packed, f, s, starts, res, uris, emit=emit),
        "jax C++ scores": _through(jax_lib, native.rttm_from_scores, scores, starts, res, tau, uris, emit=emit),
        "jax C++ bits": _through(jax_lib, native.rttm_from_bits, packed, f, s, starts, res, uris, emit=emit),
        "jax numpy scores": jax_binarize.batch_binarize_rttm(scores, starts, res, tau, uris),
        "jax numpy bits": jax_binarize.batch_bits_rttm(packed, f, s, starts, res, uris),
    }
    numpy_texts = binarize.batch_binarize_rttm(scores, starts, res, tau, uris)
    assert binarize.batch_bits_rttm(packed, f, s, starts, res, uris) == numpy_texts
    if emit is not None:
        numpy_texts = [t if e else None for t, e in zip(numpy_texts, emit)]
        for name in ("jax numpy scores", "jax numpy bits"):  # the numpy routes emit every stream
            routes[name] = [t if e else None for t, e in zip(routes[name], emit)]
    return routes, numpy_texts


def _case_random(dense):
    rng = np.random.default_rng(3 + dense)
    cases = []
    for b, f, s in [(1, 5, 1), (9, 29, 20), (4, 64, 4)]:
        scores, starts, uris = _native_case(rng, b, f, s, dense)
        cases.append((scores, starts, RES, TAU, uris, None))
    return cases


def _case_strict():
    scores = np.full((1, 6, 2), np.float32(0.6))  # == tau: inactive
    scores[0, 2:4, 1] = 0.9
    return [(scores, np.zeros(1), RES, 0.6, ["u"], None)]


def _case_emit():
    rng = np.random.default_rng(11)
    scores, starts, uris = _native_case(rng, 8, 29, 20)
    silent = np.zeros((1, 29, 20), np.float32)
    return [(scores, starts, RES, TAU, uris, np.array([True, False] * 4)),
            (silent, np.zeros(1), RES, TAU, ["u"], None)]


def _case_huge():
    rng = np.random.default_rng(13)
    scores = (rng.uniform(0, 1, (4, 6, 3)) > 0.5).astype(np.float32)
    cases = [(scores, np.array([0.0, m, -m, m * 1.7]), RES, TAU, ["u"] * 4, None)
             for m in (1e12, 1e19, 1e30, 1e300)]
    return cases + [(scores, np.zeros(4), 1e22, TAU, ["u"] * 4, None)]


def _case_ties():
    rng = np.random.default_rng(12)
    scores = (rng.uniform(0, 1, (2, 8, 20)) > 0.5).astype(np.float32)
    return [(scores, np.full(2, 1e15), RES, TAU, ["a", "b"], None)]


NATIVE_CASES = {
    "sparse": lambda: _case_random(False),
    "dense": lambda: _case_random(True),
    "strictly_greater": _case_strict,
    "emit_mask_and_empty": _case_emit,
    "huge_values": _case_huge,
    "sort_ties": _case_ties,
}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_matches_jax_and_numpy(case, jax_rttm_lib):
    for scores, starts, res, tau, uris, emit in NATIVE_CASES[case]():
        routes, want = _native_routes(scores, starts, res, tau, uris, jax_rttm_lib, emit)
        for name, got in routes.items():
            assert got == want, name
    if case == "strictly_greater":
        assert want[0].count("\n") == 1  # only the 0.9 run
    if case == "emit_mask_and_empty":
        assert want == [""]  # an all-inactive stream gives "", not None


def test_native_parity_ignores_jax_native_state(monkeypatch, jax_rttm_lib):
    """The comparison holds whatever diart_tpu.native's per-process build
    state says: here it claims a failed build and holds no library."""
    monkeypatch.setattr(jax_native, "_rttm_lib", None)
    monkeypatch.setattr(jax_native, "_rttm_failed", True)
    assert jax_native.rttm_from_scores(np.zeros((1, 4, 2), np.float32), np.zeros(1), RES, TAU, ["u"]) is None
    for case in NATIVE_CASES.values():
        for scores, starts, res, tau, uris, emit in case():
            routes, want = _native_routes(scores, starts, res, tau, uris, jax_rttm_lib, emit)
            for name, got in routes.items():
                assert got == want, name


def test_native_raises_without_compiler(monkeypatch, tmp_path):
    """No quiet fallback: where no compiler can build the assembler, the
    loader raises instead of returning None."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "librttm.so")
    monkeypatch.setattr(native, "COMPILERS", ("no-such-c++-compiler",))
    with pytest.raises(RuntimeError, match="cannot build the native RTTM assembler"):
        native.rttm_available()
    scores = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="cannot build"):
        native.rttm_from_scores(scores, np.zeros(1), RES, TAU, ["u"])


def test_native_builds_outside_the_package():
    native.rttm_available()
    assert native._LIB_PATH.exists()
    assert native._LIB_PATH.parent.name == "native" and native._LIB_PATH.parent.parent.name == "build"
    assert native._LIB_PATH.parent.parent.parent == native._SRC.parents[2]


# --------------------------------------------------------------------- #
# The session against diart_tpu's, and the engine's host inputs
# --------------------------------------------------------------------- #
def _spy(engine, record):
    """Record the scores of every step the JAX engine takes."""
    step = engine.step

    def spy(state, blocks, audio_mask=None, run_mask=None):
        state, out = step(state, blocks, audio_mask, run_mask)
        record.append((np.asarray(out.aggregated), np.asarray(out.newest), np.asarray(run_mask)))
        return state, out

    engine.step = spy


@pytest.mark.parametrize("vad", [False, True], ids=["xvector", "vad"])
def test_session_matches_jax(models, vad):
    """The port's session and diart_tpu's, on the same weights and audio,
    with warm-up, a pause and a slot reset: identical RTTM text from both
    routes at every hop."""
    (jseg, jemb), _ = models
    blocks = _blocks()
    kw = ENGINE_KW if vad else DIAR_KW
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=None if vad else jemb,
                                batch_size=BATCH, **kw)
    peng = _engine(models, vad=vad)
    record = []
    _spy(jeng, record)
    got, want = {}, {}
    for route in ("rttm", "annotation"):
        want[route] = _drive(JaxMultiStreamSession(jeng, tau_active=TAU), blocks, route)
        got[route] = _drive(MultiStreamSession(peng, tau_active=TAU), blocks, route)
    # the engines agree to atol 1e-4, so exact text needs every score the
    # text depends on (the running rows) farther than that from tau
    margin = min(
        min(np.abs(a[run] - TAU).min(), np.abs(n[run] - TAU).min())
        for a, n, run in record if run.any()
    )
    print(f"min |score - tau| over the JAX run ({'vad' if vad else 'xvector'}): {margin:.3e}")
    assert margin > 1e-4
    for hop in range(HOPS):
        for route in got:
            assert got[route][hop] == want[route][hop], (route, hop)
        assert got["rttm"][hop] == got["annotation"][hop]
    texts = [t for hop in got["rttm"] for t in hop if t]
    assert texts and any("fresh" in t for t in texts)
    assert sum(t.count("\n") for t in texts) > 2 * HOPS  # turns were made


def test_engine_inputs_on_cpu_are_unchanged(models):
    """On the CPU ``to_device`` neither pins nor copies to another device,
    and the step's host inputs give the step they gave before."""
    arr = np.arange(6, dtype=np.int16).reshape(2, 3)
    t = to_device(arr, torch.device("cpu"))
    assert t.dtype == torch.int16 and not t.is_pinned() and torch.equal(t, torch.from_numpy(arr))
    mask = to_device(np.array([1, 0], bool), torch.device("cpu"), torch.bool)
    assert mask.tolist() == [True, False]
    assert to_device(np.ones(2), torch.device("cpu")).dtype == torch.float32
    engine = _engine(models)
    blocks = _blocks(hops=3)
    s1 = s2 = engine.init_state()
    for i, blk in enumerate(blocks):
        run = np.full(BATCH, i >= 1)
        s1, o1 = engine.step(s1, blk, np.ones(BATCH, bool), run)
        s2, o2 = engine.step(s2, torch.from_numpy(blk), torch.ones(BATCH, dtype=torch.bool),
                             torch.from_numpy(run))
        assert torch.equal(o1.aggregated, o2.aggregated)


def test_output_timestamps_match_jax(models):
    (jseg, jemb), _ = models
    jeng = JaxMultiStreamEngine(segmentation=jseg, embedding=jemb, batch_size=1, **DIAR_KW)
    peng = _engine(models, batch=1)
    assert peng.output_resolution == jeng.output_resolution
    assert [peng.output_start(c) for c in range(50)] == [jeng.output_start(c) for c in range(50)]


def test_precision_provenance():
    p = Precision()
    assert p.as_dict() == {"bf16_lstm": True, "bf16_frontend": True, "fbank_ring": True,
                           "int8_trunk": False, "stack_frontend": False}
    assert p.resolved("cpu") == {"bf16_lstm": False, "bf16_frontend": False, "fbank_ring": True,
                                 "int8_trunk": False, "stack_frontend": False}
    assert p.resolved("cuda") == p.as_dict()
    assert Precision.portable().resolved("cuda") == dict.fromkeys(p.as_dict(), False)


# --------------------------------------------------------------------- #
# The port's own equivalents of the JAX session tests
# --------------------------------------------------------------------- #
def test_push_rttm_matches_annotation_route(models):
    """push_rttm emits exactly push(...)[i][0].to_rttm() for every stream
    and hop: first-chunk rows (per-stream route) and steady rows (native)."""
    blocks = _blocks(5)
    ann = _drive(MultiStreamSession(_engine(models), tau_active=TAU, collect_audio=False), blocks, "annotation")
    fast = _drive(MultiStreamSession(_engine(models), tau_active=TAU, collect_audio=False), blocks, "rttm")
    assert any(t for hop in ann for t in hop)
    assert ann == fast


def test_fetch_modes_and_numpy_routes_agree(models, monkeypatch):
    """The packed-bits fetch (default), the scores fetch
    (binarize_on_device=False) and the numpy batch routes put in the native
    assembler's place emit identical RTTM strings."""
    blocks = _blocks(6)

    def run(**kw):
        return _drive(MultiStreamSession(_engine(models), tau_active=TAU, collect_audio=False, **kw),
                      blocks, "rttm")

    bits_route = run()
    scores_route = run(binarize_on_device=False)

    def by_name(texts_fn):
        def route(*args, emit=None):
            texts = texts_fn(*args)
            return [t if e else None for t, e in zip(texts, emit)]
        return route

    monkeypatch.setattr(native, "rttm_from_bits", by_name(binarize.batch_bits_rttm))
    monkeypatch.setattr(native, "rttm_from_scores", by_name(binarize.batch_binarize_rttm))
    numpy_bits, numpy_scores = run(), run(binarize_on_device=False)
    assert any(t for hop in bits_route for t in hop)
    assert bits_route == scores_route == numpy_bits == numpy_scores


def _pipelined(session, blocks, depth=2, reset_between=False):
    """push_begin / push_finish with ``depth`` hops in flight; with
    ``reset_between``, slot 0 is reset after the dispatch of hop 6 and
    before its harvest."""
    out, inflight = [], deque()

    def harvest(pending):
        out.append(session.push_finish_rttm(pending))

    for hop, blk in enumerate(blocks):
        pending = session.push_begin(blk)
        if reset_between and hop == 6:
            session.reset_slot(0, uri="fresh", shift=1.5)
        if pending is not None:
            inflight.append(pending)
        while len(inflight) > depth:
            harvest(inflight.popleft())
    while inflight:
        harvest(inflight.popleft())
    return out


def test_pipelined_push_matches_sync(models):
    """Two hops in flight, and a reset landing between a hop's dispatch and
    its harvest: the outputs equal the synchronous push_rttm run."""
    blocks = _blocks(7)
    sync = MultiStreamSession(_engine(models), tau_active=TAU, collect_audio=False)
    want = []
    for hop, blk in enumerate(blocks):
        texts = sync.push_rttm(blk)
        if hop == 6:
            sync.reset_slot(0, uri="fresh", shift=1.5)
        if any(t is not None for t in texts):
            want.append(texts)
    pipe = MultiStreamSession(_engine(models), tau_active=TAU, collect_audio=False)
    got = _pipelined(pipe, blocks, reset_between=True)
    assert got == want
    assert any("fresh" in (hop[0] or "") for hop in got)  # slot 0 came back


def test_collect_audio_overlap_refused(models):
    engine = _engine(models, batch=1)
    session = MultiStreamSession(engine, tau_active=TAU, collect_audio=True)
    blocks = _blocks(8, batch=1)
    pending = None
    for blk in blocks:
        pending = session.push_begin(blk)
        if pending is not None:
            break
    assert pending is not None
    with pytest.raises(RuntimeError, match="collect_audio"):
        session.push_begin(blocks[-1])
    session.push_finish(pending)  # finishing the hop clears the guard
    session.push_begin(blocks[-1])


def test_slot_reset_between_begin_and_finish(models):
    """The in-flight hop keeps the old uri; after the reset, the slot warms
    up again and then emits under the new uri."""
    session = MultiStreamSession(_engine(models, batch=2), tau_active=TAU, collect_audio=False)
    blocks = _blocks(9, batch=2)
    got_old = False
    for blk in blocks:
        pending = session.push_begin(blk)
        if pending is None:
            continue
        if not got_old:
            session.reset_slot(0, uri="newclient", shift=1.0)
            outs = session.push_finish(pending)
            assert outs[0] is not None and outs[0][0].uri == "stream0"
            got_old = True
            continue
        outs = session.push_finish(pending)
        if outs[0] is not None:
            assert outs[0][0].uri == "newclient"
            assert session.blocks_seen[0] >= session.warmup_blocks
            return
    pytest.fail("slot 0 never emitted under its new uri")


def _state_tensors(state):
    for t in state:
        yield from (t.values() if isinstance(t, dict) else [t])


def test_inflight_count_under_threads(models):
    """The in-flight count is raised on the dispatching thread and lowered on
    harvest threads; with many harvest threads and a short switch interval
    no update is lost, nor a harvest's span."""
    session = MultiStreamSession(_engine(models, batch=2), tau_active=TAU, collect_audio=False)
    blocks = _blocks(40, hops=16, batch=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as record, ThreadPoolExecutor(8) as pool:
            pendings = [session.push_begin(blk) for blk in blocks]
            futures = [pool.submit(session.push_finish_rttm, p) for p in pendings if p is not None]
            results = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 15 and all(isinstance(t, str) for r in results for t in r)
    assembled = [s for s in record.spans if s.name == "session.assemble"]
    assert session._inflight_hops == 0 and len(assembled) == 15
    assert len({s.hop for s in assembled}) == 15


@pytest.mark.parametrize("vad", [False, True], ids=["xvector", "vad"])
def test_checkpoint_round_trip(models, tmp_path, vad):
    """Save halfway, restore into a fresh session on a fresh engine: the
    remaining outputs equal the uninterrupted run's, and the sidecar holds
    the precision provenance."""
    blocks, half = _blocks(10), HOPS // 2

    def first_half():
        session = MultiStreamSession(_engine(models, vad=vad), tau_active=TAU)
        texts = _drive(session, blocks[:half], "annotation")
        session.reset_slot(2, uri="renamed", shift=0.5)
        return session, texts

    ref_session, ref = first_half()
    ref += _drive(ref_session, blocks[half:], "annotation")

    first, got = first_half()
    first.save(tmp_path / "session.pt")
    resumed = MultiStreamSession(_engine(models, vad=vad), tau_active=TAU)
    resumed.restore(tmp_path / "session.pt")
    assert resumed.uris[2] == "renamed" and resumed.shifts[2] == 0.5
    np.testing.assert_array_equal(resumed.blocks_seen, first.blocks_seen)
    np.testing.assert_array_equal(resumed._audio, first._audio)
    for a, b in zip(_state_tensors(first.state), _state_tensors(resumed.state), strict=True):
        assert torch.equal(a, b)
    meta = json.loads((tmp_path / "session.json").read_text())
    assert meta["precision"] == Precision().as_dict()
    assert meta["precision_resolved"] == Precision().resolved("cpu")
    got += _drive(resumed, blocks[half:], "annotation")
    assert any(t for hop in got[half:] for t in hop)
    assert got == ref


def test_restore_refuses_another_geometry(models, tmp_path):
    session = MultiStreamSession(_engine(models, batch=2), tau_active=TAU)
    session.save(tmp_path / "s.pt")
    other = MultiStreamSession(_engine(models, batch=3), tau_active=TAU)
    with pytest.raises(ValueError, match="checkpoint field"):
        other.restore(tmp_path / "s.pt")


def test_warm_is_side_effect_free(models):
    blocks = _blocks(12)

    def run(warm):
        session = MultiStreamSession(_engine(models), tau_active=TAU)
        if warm:
            with tracing.recording() as record:
                session.warm()
            assert session.blocks_seen.sum() == 0 and record.spans == []
            assert session.uris == [f"stream{i}" for i in range(BATCH)]
        return _drive(session, blocks, "rttm")

    assert run(True) == run(False)


def test_quantize_transfer_matches_float_session(models):
    """quantize_transfer ships int16 PCM; on quantization-exact audio the
    emitted turns equal the float session's."""
    rng = np.random.default_rng(11)
    pcm = rng.integers(-4000, 4000, size=(8, BATCH, STEP_SAMPLES)).astype(np.int16)
    blocks = pcm.astype(np.float32) / 32768.0

    def run(quantize):
        session = MultiStreamSession(_engine(models), tau_active=TAU, collect_audio=False,
                                     quantize_transfer=quantize)
        return [session.push_rttm(blk) for blk in blocks]

    want = run(False)
    assert any(t for hop in want for t in hop)
    assert run(True) == want


@pytest.mark.parametrize("pipelined", [False, True], ids=["blocked", "pipelined"])
def test_cohort_scheduler_serves_every_cohort(models, pipelined):
    """K=2 sessions sharing one engine at staggered phases: every steady
    hop emits RTTM for every stream, in both harvest modes, and the text
    equals each cohort's own synchronous session."""
    engine = _engine(models, batch=2)
    audio = {j: _blocks(30 + j, hops=10, batch=2) for j in range(2)}
    present = np.ones(2, bool)

    def get_blocks(j, k):
        return audio[j][k], present

    scheduler = CohortScheduler(engine, cohorts=2, tau_active=TAU)
    assert scheduler.capacity == 4 and scheduler.phase == engine.step_duration / 2
    scheduler.warm()
    scheduler.prime(get_blocks)
    warm = scheduler.sessions[0].warmup_blocks
    outputs = {}
    timings = scheduler.run(lambda j, p: get_blocks(j, p + warm), periods=3, pipelined=pipelined,
                            on_outputs=lambda j, p, outs: outputs.setdefault(j, []).append(outs))
    assert len(timings) == 6
    for t in timings:
        assert t.done >= t.dispatched >= t.due
    assert [t.cohort for t in sorted(timings, key=lambda t: t.due)] == [0, 1] * 3
    for j in (0, 1):
        assert len(outputs[j]) == 3
        assert all(isinstance(o, str) for outs in outputs[j] for o in outs)
        ref = MultiStreamSession(engine, uris=[f"c{j}s{i}" for i in range(2)], tau_active=TAU,
                                 collect_audio=False)
        want = [ref.push_rttm(audio[j][k], present) for k in range(warm + 3)][warm:]
        assert outputs[j] == want


def test_chronometer_reports(capsys):
    from diart_tpu_torch.utils import Chronometer

    chrono = Chronometer("hop")
    chrono.start()
    assert chrono.is_running
    chrono.stop()
    chrono.start()
    chrono.stop(do_count=False)
    assert len(chrono.history) == 1 and not chrono.is_running
    chrono.report()
    assert "seconds/hop -- ran 1 times" in capsys.readouterr().out
