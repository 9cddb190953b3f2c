"""The port's console entry points (``python -m
diart_tpu_torch.console.stream|benchmark|serve|client``) as real
subprocesses with ``--cpu``, on the default registry models
(``tpu/pyannet`` + ``tpu/xvector`` at full width, random weights from their
fixed seeds) and synthetic audio: the subprocess CLI tests of
``tests/test_cli.py``, ported, each held to the same run made in process
(RTTM text string-equal: same code, same weights, same audio). Without
``--cpu`` a CLI needs a GPU and fails here; the flags of features the port
does not have yet raise; the runtime and the CLIs import without jax,
diart_tpu, pandas and websockets.
"""

import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from diart_tpu_torch import EmbeddingModel, SegmentationModel
from diart_tpu_torch.audio import write_wav
from diart_tpu_torch.blocks import (
    SpeakerDiarization,
    SpeakerDiarizationConfig,
    VoiceActivityDetection,
    VoiceActivityDetectionConfig,
)
from diart_tpu_torch.parallel import MultiStreamEngine, MultiStreamSession
from diart_tpu_torch.runtime import Benchmark, FileAudioSource, StreamingInference

from fakes import SAMPLE_RATE, Turn, synth_audio

REPO = Path(__file__).parent.parent
TURNS = [Turn(0.0, 2.0, 0), Turn(2.5, 5.0, 1)]
# the CLIs' geometry in these tests (the JAX CLI tests' own), defaults else
GEOMETRY = ["--duration", "1", "--step", "0.5", "--latency", "0.5", "--max-speakers", "6"]
CONFIG = dict(duration=1.0, step=0.5, latency=0.5, max_speakers=6, tau_active=0.5,
              rho_update=0.3, delta_new=1.0)


def _env():
    # two compute threads a CLI process: the suite runs beside other workers,
    # and an oversubscribed CPU slows these runs tenfold
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    return env


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run_cli(module, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"diart_tpu_torch.console.{module}", *map(str, args)],
        capture_output=True, text=True, timeout=timeout, env=_env(), cwd=REPO)


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "meeting.wav"
    write_wav(path, synth_audio(TURNS, 6.0), SAMPLE_RATE)
    return path


def models(embedding=True):
    """The CLIs' default models on the CPU (the registry's fixed seeds)."""
    seg = SegmentationModel.from_pretrained("tpu/pyannet", device="cpu")
    return seg, EmbeddingModel.from_pretrained("tpu/xvector", device="cpu") if embedding else None


def in_process(wav, kind):
    seg, emb = models(kind == "SpeakerDiarization")
    if kind == "SpeakerDiarization":
        config = SpeakerDiarizationConfig(segmentation=seg, embedding=emb, **CONFIG)
        pipeline = SpeakerDiarization(config)
    else:
        config = VoiceActivityDetectionConfig(segmentation=seg, duration=1.0, step=0.5, latency=0.5,
                                              tau_active=0.5)
        pipeline = VoiceActivityDetection(config)
    padding = config.get_file_padding(wav)
    source = FileAudioSource(wav, SAMPLE_RATE, padding, config.step)
    pipeline.set_timestamp_shift(-padding[0])
    return StreamingInference(pipeline, source, batch_size=1, do_profile=False, show_progress=False)()


@pytest.mark.parametrize("kind", ["SpeakerDiarization", "VoiceActivityDetection"])
def test_stream_cli_matches_in_process(wav_file, tmp_path, kind):
    """stream --cpu writes a well-formed RTTM whose text equals the same
    StreamingInference run in process; the profile line is printed."""
    result = run_cli("stream", wav_file, "--no-plot", "--cpu", "--pipeline", kind, *GEOMETRY,
                     "--output", tmp_path)
    assert result.returncode == 0, result.stderr[-2000:]
    text = (tmp_path / "meeting.rttm").read_text()
    lines = text.splitlines()
    assert lines and all(l.split()[:2] == ["SPEAKER", "meeting"] for l in lines)
    assert text == in_process(wav_file, kind).to_rttm()
    assert "seconds/chunk" in result.stdout + result.stderr


@pytest.mark.parametrize("multi", [False, True])
def test_benchmark_cli_report(wav_file, tmp_path, multi):
    """benchmark --cpu over a one-file corpus with references: the RTTM
    equals the in-process Benchmark's in the same mode, the report is
    printed and written; --score-against scores the per-file RTTMs again."""
    from diart_tpu_torch.core import Annotation, Segment

    audio_dir, rttm_dir, out_dir = tmp_path / "audio", tmp_path / "rttm", tmp_path / "out"
    audio_dir.mkdir()
    rttm_dir.mkdir()
    shutil.copy(wav_file, audio_dir / "meeting.wav")
    ref = Annotation("meeting")
    for k, t in enumerate(TURNS):
        ref[Segment(t.start, t.end), k] = f"spk{t.speaker}"
    with open(rttm_dir / "meeting.rttm", "w") as f:
        ref.write_rttm(f)
    result = run_cli("benchmark", audio_dir, "--reference", rttm_dir, "--output", out_dir, "--cpu",
                     *GEOMETRY, "--batch-size", "4", *(["--multi-stream"] if multi else []))
    assert result.returncode == 0, result.stderr[-2000:]
    assert (out_dir / "benchmark_report.csv").exists()
    assert "diarization error rate" in result.stdout
    seg, emb = models()
    want = Benchmark(audio_dir, None, tmp_path / "want", show_progress=False, batch_size=4,
                     multi_stream=multi)(
        SpeakerDiarization, SpeakerDiarizationConfig(segmentation=seg, embedding=emb, **CONFIG))
    assert (out_dir / "meeting.rttm").read_text() == want[0].to_rttm()
    if not multi:
        scored = run_cli("benchmark", out_dir, "--score-against", rttm_dir, "--output", tmp_path / "s")
        assert scored.returncode == 0, scored.stderr[-2000:]
        assert (tmp_path / "s" / "parity_report.csv").exists()


def _wait_listening(port, proc, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 1).close()
            return
        except OSError:
            if proc.poll() is not None:
                pytest.fail(f"server exited early: {proc.stderr.read()[-2000:]}")
            time.sleep(0.2)
    pytest.fail("server never listened")


def test_serve_client_cli_end_to_end(wav_file):
    """serve --cpu + client as real subprocesses: the client streams the
    wav over the websocket and prints the RTTM lines it gets back, which
    equal a MultiStreamSession of the same models pushed the file's blocks
    in process (slot 0, uri client0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = subprocess.Popen(
        [sys.executable, "-m", "diart_tpu_torch.console.serve", "--cpu", "--port", str(port),
         "--num-streams", "2", *GEOMETRY],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)
    try:
        _wait_listening(port, server)
        result = run_cli("client", wav_file, "--host", "127.0.0.1", "--port", port, "--step", "0.5",
                         "--drain-timeout", "8")
    finally:
        server.terminate()
        try:
            server.wait(timeout=10)
        except subprocess.TimeoutExpired:
            server.kill()
    assert result.returncode == 0, result.stderr[-2000:]
    lines = [l for l in result.stdout.splitlines() if l.strip()]
    assert lines and all(l.split()[:2] == ["SPEAKER", "client0"] for l in lines)

    seg, emb = models()
    engine = MultiStreamEngine(seg, emb, batch_size=2, sample_rate=SAMPLE_RATE, **CONFIG)
    session = MultiStreamSession(engine, uris=["client0", "client1"], tau_active=0.5,
                                 collect_audio=False)
    blocks = []
    source = FileAudioSource(wav_file, SAMPLE_RATE, block_duration=0.5)
    source.stream.subscribe(on_next=blocks.append)
    source.read()
    want = ""
    for block in blocks:
        batch = np.zeros((2, block.shape[1]), np.float32)
        batch[0] = block[0]
        want += session.push_rttm(batch, np.array([True, False]))[0] or ""
    assert result.stdout == want


@pytest.mark.parametrize("module", ["stream", "serve"])
def test_cli_without_card_raises(wav_file, tmp_path, module):
    """Without --cpu the CLIs build on the card; with no card they fail
    (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLI would run on it")
    args = [wav_file, "--no-plot", "--output", tmp_path] if module == "stream" else ["--port", "0"]
    result = run_cli(module, *args, *GEOMETRY)
    assert result.returncode != 0
    assert "no GPU is available" in result.stderr


@pytest.mark.parametrize("module,flags,item", [
    ("stream", ["--powerset", "3", "2"], "item 4"),
    ("benchmark", ["--powerset", "3", "2"], "item 4"),
    ("serve", ["--mesh", "2"], "item 6"),
])
def test_unported_flags_raise(monkeypatch, wav_file, tmp_path, module, flags, item):
    """--powerset and --mesh are kept so the command lines match, and raise
    NotImplementedError naming their ROADMAP.md item."""
    import importlib

    cli = importlib.import_module(f"diart_tpu_torch.console.{module}")
    first = {"stream": [str(wav_file), "--no-plot"], "benchmark": [str(tmp_path)], "serve": []}[module]
    monkeypatch.setattr(sys, "argv", [module, *first, "--cpu", *flags])
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        cli.run()


def test_precision_flag(monkeypatch):
    """--precision installs the process default (every thread sees it);
    'portable' turns every switch off; an unknown switch raises."""
    import argparse

    from diart_tpu_torch import precision
    from diart_tpu_torch.console.stream import apply_precision_arg

    prev = precision.active()
    try:
        apply_precision_arg(argparse.Namespace(precision="bf16_lstm=0"))
        assert precision.active() == precision.Precision(bf16_lstm=False)
        apply_precision_arg(argparse.Namespace(precision="portable"))
        assert precision.active() == precision.Precision.portable()
        with pytest.raises(ValueError, match="pallas_lstm"):
            apply_precision_arg(argparse.Namespace(precision="pallas_lstm=1"))
    finally:
        precision.set_default(prev)


def test_runtime_and_clis_import_without_jax_pandas_websockets():
    """diart_tpu_torch.runtime (server included), the four CLIs, progress,
    argdoc and metrics.parity import with jax, diart_tpu, pandas and
    websockets blocked, and expose the JAX package's public names."""
    code = (
        "import sys\n"
        "for m in ('jax', 'diart_tpu', 'pandas', 'websockets'):\n"
        "    sys.modules[m] = None\n"
        "import diart_tpu_torch.runtime as rt, diart_tpu_torch.runtime.server\n"
        "import diart_tpu_torch.console.stream, diart_tpu_torch.console.serve\n"
        "import diart_tpu_torch.console.client, diart_tpu_torch.console.benchmark\n"
        "import diart_tpu_torch.progress, diart_tpu_torch.argdoc, diart_tpu_torch.metrics.parity\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', 'diart_tpu.', 'pandas',\n"
        "            'websockets')) and sys.modules[m] is not None]\n"
        "print(' '.join(sorted(rt.__all__)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr
    import diart_tpu.runtime as jax_runtime

    assert out.stdout.split() == sorted(jax_runtime.__all__)
    from diart_tpu.metrics import parity as jax_parity
    from diart_tpu_torch.metrics import parity

    assert parity.__all__ == jax_parity.__all__
    for name in ("stream", "serve", "client", "benchmark"):
        module = __import__(f"diart_tpu_torch.console.{name}", fromlist=["run"])
        assert callable(module.run)
