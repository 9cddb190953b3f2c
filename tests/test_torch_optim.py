"""Parity of the port's tuning layer (``diart_tpu_torch.optim`` and the tune
CLI) with diart_tpu's, on the CPU.

The TPE sampler proposes the JAX package's values for the same seed and
history; a study database written by either package is read and extended
by the other; ``Optimizer`` (sequential and multi-stream) runs over
``tests/test_tools.py``'s fixture corpus beside the JAX package's, the port
on the torch copies of ``tests/fakes.py``'s models
(``tests/test_torch_pipeline.py``), with the same trial values and best
parameters; the objective equals the pandas report's TOTAL; the tune CLI
runs in a subprocess with ``--cpu``.
"""

import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diart_tpu import SpeakerDiarization as JaxSpeakerDiarization
from diart_tpu import SpeakerDiarizationConfig as JaxSpeakerDiarizationConfig
from diart_tpu.audio import write_wav
from diart_tpu.core import write_rttm
from diart_tpu.optim import Optimizer as JaxOptimizer
from diart_tpu.optim import Study as JaxStudy
from diart_tpu.optim import TPESampler as JaxTPESampler
from diart_tpu_torch.blocks import HyperParameter, SpeakerDiarization, SpeakerDiarizationConfig
from diart_tpu_torch.optim import Optimizer, Study, TPESampler
from diart_tpu_torch.runtime import Benchmark

import fakes
from fakes import SAMPLE_RATE, synth_audio, turns_to_annotation
from test_tools import FILES, PIPELINE_PARAMS, TOTAL
from test_torch_pipeline import fake_embedding, fake_segmentation

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_tools.py's corpus: two synthesized conversations and their
    reference RTTMs, written by the JAX package."""
    root = tmp_path_factory.mktemp("corpus")
    audio_dir, rttm_dir = root / "audio", root / "rttm"
    audio_dir.mkdir()
    rttm_dir.mkdir()
    for i, (uri, turns) in enumerate(FILES.items()):
        write_wav(audio_dir / f"{uri}.wav", synth_audio(turns, TOTAL, seed=i), SAMPLE_RATE)
        write_rttm(turns_to_annotation(turns, uri), rttm_dir / f"{uri}.rttm")
    return audio_dir, rttm_dir


def _port_config(**overrides):
    return SpeakerDiarizationConfig(segmentation=fake_segmentation(), embedding=fake_embedding(),
                                    **{**PIPELINE_PARAMS, **overrides})


def _jax_config():
    return JaxSpeakerDiarizationConfig(segmentation=fakes.fake_segmentation(),
                                       embedding=fakes.fake_embedding(), **PIPELINE_PARAMS)


# ----------------------------------------------------------------------- #
# the sampler and the study


def _quadratic_run(sampler, n=60):
    history, proposed = [], []
    for _ in range(n):
        x = sampler.suggest("x", 0.0, 1.0, history, minimize=True)
        proposed.append(x)
        history.append(({"x": x}, (x - 0.3) ** 2))
    return proposed, history


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_sampler_proposes_jax_values(seed):
    got, history = _quadratic_run(TPESampler(n_startup=8, seed=seed))
    want, _ = _quadratic_run(JaxTPESampler(n_startup=8, seed=seed))
    assert got == want  # the same numpy code on the same generator: the same floats
    best = min(history, key=lambda t: t[1])[0]["x"]
    assert abs(best - 0.3) < 0.05
    assert np.mean([v for _, v in history[-15:]]) < np.mean([v for _, v in history[:15]])


def test_tpe_sampler_maximizes_like_jax():
    history = [({"x": x}, -abs(x - 0.7)) for x in np.linspace(0.0, 1.0, 12)]
    got = [TPESampler(seed=2).suggest("x", 0.0, 1.0, history, minimize=False) for _ in range(3)]
    want = [JaxTPESampler(seed=2).suggest("x", 0.0, 1.0, history, minimize=False) for _ in range(3)]
    assert got == want


def _rows(db):
    with sqlite3.connect(str(db)) as conn:
        return conn.execute("SELECT number, params, value, state FROM trials ORDER BY number").fetchall()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_study_databases_are_shared(tmp_path, first):
    """A study written by one package is read and extended by the other:
    the same schema, rows and best trial."""
    db = tmp_path / "study.db"
    writer, reader = (JaxStudy, Study) if first == "jax" else (Study, JaxStudy)
    a = writer(db)
    a.tell({"tau_active": 0.5}, 10.0)
    a.tell({"tau_active": 0.7}, 5.0)
    b = reader(db)
    assert b.best_value == 5.0 and b.best_params == {"tau_active": 0.7} and len(b.trials) == 2
    b.tell({"tau_active": 0.6}, 2.5)
    b.enqueue_trial({"tau_active": 0.6})  # already there: skipped
    assert b._queue == []
    assert writer(db).best_params == {"tau_active": 0.6} and len(writer(db).trials) == 3
    assert [r[0] for r in _rows(db)] == [1, 2, 3]


def test_study_asks_like_jax(tmp_path):
    hparams = [HyperParameter.from_name(n) for n in ("tau_active", "rho_update", "delta_new")]
    history = [({"tau_active": t, "rho_update": 0.1, "delta_new": 0.5}, (t - 0.4) ** 2)
               for t in np.linspace(0.1, 0.9, 12)]
    port, jax_study = Study(sampler=TPESampler(seed=5)), JaxStudy(sampler=JaxTPESampler(seed=5))
    for params, value in history:
        port.tell(params, value)
        jax_study.tell(params, value)
    from diart_tpu.blocks.base import HyperParameter as JaxHyperParameter

    jax_hparams = [JaxHyperParameter.from_name(h.name) for h in hparams]
    for _ in range(3):
        assert port.ask(hparams) == jax_study.ask(jax_hparams)


# ----------------------------------------------------------------------- #
# the optimizer


def _trial_values(study):
    return [(p, v) for p, v, s in study.trials if s == "COMPLETE"]


@pytest.mark.parametrize("multi_stream", [False, True])
def test_optimizer_matches_jax(corpus, tmp_path, multi_stream):
    """Same sampler seed, same corpus: the same trials (parameters and
    values) and the same best parameters as the JAX package's Optimizer,
    whose value is its pandas report's TOTAL."""
    audio_dir, rttm_dir = corpus
    kw = dict(speech_path=audio_dir, reference_path=rttm_dir, batch_size=8, multi_stream=multi_stream)
    jax_study = JaxStudy(tmp_path / "jax.db", sampler=JaxTPESampler(n_startup=3, seed=1))
    JaxOptimizer(pipeline_class=JaxSpeakerDiarization, study_or_path=jax_study, base_config=_jax_config(),
                 **kw)(num_iter=4, show_progress=False)
    study = Study(tmp_path / "port.db", sampler=TPESampler(n_startup=3, seed=1))
    optimizer = Optimizer(pipeline_class=SpeakerDiarization, study_or_path=study, base_config=_port_config(),
                          **kw)
    engines = []
    evaluate = optimizer._evaluate

    def recorded(params):
        value = evaluate(params)
        engines.append(getattr(optimizer.benchmark, "_engine_cache", (None, None))[1])
        return value

    optimizer._evaluate = recorded
    optimizer(num_iter=4, show_progress=False)
    got, want = _trial_values(study), _trial_values(jax_study)
    assert len(got) == 4 and [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-12)
    assert optimizer.best_hparams == jax_study.best_params
    assert got[0][0] == {h: PIPELINE_PARAMS[h] for h in ("tau_active", "rho_update", "delta_new")}  # kickstart
    if multi_stream:  # one engine serves every trial
        assert engines[0] is not None and all(e is engines[0] for e in engines)


def test_objective_is_the_report_total(corpus, tmp_path):
    """The pandas-free objective equals the port's own Benchmark report's
    TOTAL for the same config."""
    pytest.importorskip("pandas")
    audio_dir, rttm_dir = corpus
    optimizer = Optimizer(SpeakerDiarization, audio_dir, rttm_dir, tmp_path / "s", batch_size=8,
                          base_config=_port_config(), multi_stream=True)
    params = {"tau_active": 0.55, "rho_update": 0.2, "delta_new": 0.9}
    value = optimizer._evaluate(params)
    report = Benchmark(audio_dir, rttm_dir, show_progress=False, show_report=False, multi_stream=True)(
        SpeakerDiarization, _port_config(**params))
    name = SpeakerDiarization.suggest_metric().name
    assert value == pytest.approx(float(report.loc["TOTAL", (name, "%")]), rel=1e-12)
    assert (tmp_path / "s" / "s.db").exists()


def test_optuna_study_probe(tmp_path):
    assert not Optimizer._is_optuna_study(Study(tmp_path / "x.db"))
    assert not Optimizer._is_optuna_study(tmp_path)
    with pytest.raises(ValueError):
        Optimizer(SpeakerDiarization, tmp_path, tmp_path, 3, base_config=_port_config())


# ----------------------------------------------------------------------- #
# the CLI


def test_tune_cli_runs_on_the_cpu(tmp_path):
    """The tune CLI with ``--cpu --multi-stream`` on the full-width default
    models over two 3 s files, in a process where jax, pandas and the JAX
    package cannot be imported: exit 0 and its trials in the study
    database."""
    audio_dir, rttm_dir = tmp_path / "audio", tmp_path / "rttm"
    audio_dir.mkdir()
    rttm_dir.mkdir()
    turns = {"a": [fakes.Turn(0.0, 1.5, 0), fakes.Turn(1.5, 3.0, 1)], "b": [fakes.Turn(0.5, 2.5, 2)]}
    for i, (uri, ts) in enumerate(turns.items()):
        write_wav(audio_dir / f"{uri}.wav", synth_audio(ts, 3.0, seed=i), SAMPLE_RATE)
        write_rttm(turns_to_annotation(ts, uri), rttm_dir / f"{uri}.rttm")
    db = tmp_path / "study.db"
    args = [str(audio_dir), "--reference", str(rttm_dir), "--cpu", "--multi-stream", "--num-iter", "2",
            "--storage", str(db), "--duration", "2", "--hparams", "tau_active", "rho_update"]
    # run as `python -m`, with jax, pandas and the JAX package unimportable
    code = ("import runpy, sys\n"
            "for name in ('jax', 'pandas', 'diart_tpu'):\n    sys.modules[name] = None\n"
            f"sys.argv = ['tune'] + {args!r}\n"
            "runpy.run_module('diart_tpu_torch.console.tune', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Best hyper-parameters" in proc.stdout
    rows = _rows(db)
    assert len(rows) == 2 and all(state == "COMPLETE" for *_, state in rows)
