"""Hyper-parameter tuning with persistent, distributable studies (a copy of
``diart_tpu/optim.py``; the sampler and the study are plain numpy and
sqlite3, the database schema is the JAX package's, so either package reads
and extends the other's studies).

Parity target: diart's ``optim.py`` — an Optuna TPE search
over pipeline hyper-parameters whose objective is a full Benchmark run, with
SQLite persistence so interrupted studies resume and independent workers can
share one storage (``optim.py:65-78``; distributed recipe README.md:246-273).

This implementation is self-contained: a built-in Tree-structured Parzen
Estimator sampler over the (independent, uniform-range) hyper-parameters and
an sqlite3-backed study. When ``optuna`` is installed, an
``optuna.Study`` can be passed directly and is used as-is. The objective
needs no pandas: it scores the benchmark's predictions itself.
"""

from __future__ import annotations

import json
import sqlite3
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np

from . import blocks
from .audio import FilePath
from .core import load_rttm
from .metrics import BaseMetric
from .runtime.inference import Benchmark

__all__ = ["Study", "TPESampler", "Optimizer"]


class TPESampler:
    """Tree-structured Parzen Estimator for independent uniform parameters.

    After ``n_startup`` random trials, observations are split at the
    ``gamma`` quantile into "good" and "bad" sets; candidates are drawn from
    a Gaussian KDE over the good set and ranked by the density ratio
    l(x)/g(x) (Bergstra et al., 2011).
    """

    def __init__(
        self,
        n_startup: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = np.random.default_rng(seed)

    def suggest(
        self,
        name: str,
        low: float,
        high: float,
        history: Sequence[tuple],  # (params dict, value)
        minimize: bool = True,
    ) -> float:
        complete = [(p, v) for p, v in history if v is not None and name in p]
        if len(complete) < self.n_startup:
            return float(self.rng.uniform(low, high))

        values = np.array([v for _, v in complete])
        xs = np.array([p[name] for p, _ in complete])
        order = np.argsort(values if minimize else -values)
        n_good = max(1, int(np.ceil(self.gamma * len(xs))))
        good, bad = xs[order[:n_good]], xs[order[n_good:]]
        if len(bad) == 0:
            bad = xs

        span = high - low
        prior = 0.2  # uniform mixture weight (keeps the search exploratory
        # and prevents the density ratio from locking onto one mode)

        def kde_logpdf(points: np.ndarray, queries: np.ndarray) -> np.ndarray:
            # Scott bandwidth with a floor to stay exploratory
            bw = max(1.06 * (np.std(points) + 1e-12) * len(points) ** -0.2,
                     0.05 * span)
            diffs = (queries[:, None] - points[None, :]) / bw
            log_kernels = -0.5 * diffs**2 - np.log(bw * np.sqrt(2 * np.pi))
            m = log_kernels.max(axis=1, keepdims=True)
            kde = (m[:, 0] + np.log(np.exp(log_kernels - m).sum(axis=1))) - np.log(
                len(points)
            )
            # mix with the uniform prior over [low, high]
            return np.logaddexp(
                np.log1p(-prior) + kde, np.log(prior) - np.log(span)
            )

        bw_good = max(1.06 * (np.std(good) + 1e-12) * len(good) ** -0.2, 0.05 * span)
        n_exploit = max(1, int(0.75 * self.n_candidates))
        exploit = good[self.rng.integers(0, len(good), n_exploit)]
        exploit = exploit + self.rng.normal(0, bw_good, n_exploit)
        explore = self.rng.uniform(low, high, self.n_candidates - n_exploit)
        candidates = np.clip(np.concatenate([exploit, explore]), low, high)
        score = kde_logpdf(good, candidates) - kde_logpdf(bad, candidates)
        return float(candidates[np.argmax(score)])


class Study:
    """A persistent collection of trials backed by sqlite3.

    Multiple worker processes (or hosts over a shared filesystem) may attach
    to the same database path; sqlite's locking serializes trial insertion,
    which is the same coordination model the reference uses
    (``optim.py:69-75``).
    """

    def __init__(
        self,
        path: Optional[FilePath] = None,
        direction: str = "minimize",
        sampler: Optional[TPESampler] = None,
    ):
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self._queue = []
        self.path = None if path is None else Path(path)
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._db = sqlite3.connect(str(self.path), timeout=60)
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS trials ("
                "number INTEGER PRIMARY KEY AUTOINCREMENT,"
                "params TEXT, value REAL, state TEXT, timestamp REAL)"
            )
            self._db.commit()
        else:
            self._db = None
            self._memory = []

    # ------------------------------------------------------------------ #
    def _insert(self, params: Dict[str, float], value: Optional[float], state: str) -> int:
        if self._db is None:
            self._memory.append((params, value, state))
            return len(self._memory) - 1
        cur = self._db.execute(
            "INSERT INTO trials (params, value, state, timestamp) VALUES (?, ?, ?, ?)",
            (json.dumps(params), value, state, time.time()),
        )
        self._db.commit()
        return cur.lastrowid

    def _all(self):
        if self._db is None:
            return list(self._memory)
        rows = self._db.execute("SELECT params, value, state FROM trials").fetchall()
        return [(json.loads(p), v, s) for p, v, s in rows]

    @property
    def trials(self):
        return self._all()

    def enqueue_trial(self, params: Dict[str, float], skip_if_exists: bool = True):
        if skip_if_exists:
            for p, _, _ in self._all():
                if all(abs(p.get(k, 1e18) - v) < 1e-12 for k, v in params.items()):
                    return
        self._queue.append(dict(params))

    def ask(self, hparams) -> Dict[str, float]:
        if self._queue:
            return self._queue.pop(0)
        history = [(p, v) for p, v, s in self._all() if s == "COMPLETE"]
        return {
            hp.name: self.sampler.suggest(
                hp.name, hp.low, hp.high, history, self.direction == "minimize"
            )
            for hp in hparams
        }

    def tell(self, params: Dict[str, float], value: float):
        self._insert(params, value, "COMPLETE")

    # ------------------------------------------------------------------ #
    @property
    def best_trial(self):
        complete = [(p, v) for p, v, s in self._all() if s == "COMPLETE"]
        if not complete:
            raise ValueError("no completed trials")
        key = min if self.direction == "minimize" else max
        return key(complete, key=lambda t: t[1])

    @property
    def best_value(self) -> float:
        return self.best_trial[1]

    @property
    def best_params(self) -> Dict[str, float]:
        return self.best_trial[0]


class Optimizer:
    """Tune pipeline hyper-parameters by repeated Benchmark runs
    (``optim.py:17-141``)."""

    def __init__(
        self,
        pipeline_class: type,
        speech_path: FilePath,
        reference_path: FilePath,
        study_or_path: Union[FilePath, Study],
        batch_size: int = 32,
        hparams: Optional[Sequence[blocks.HyperParameter]] = None,
        base_config: Optional[blocks.PipelineConfig] = None,
        do_kickstart_hparams: bool = True,
        metric: Optional[BaseMetric] = None,
        direction: str = "minimize",
        multi_stream: bool = False,
    ):
        self.pipeline_class = pipeline_class
        self.reference_path = Path(reference_path).expanduser()
        self.benchmark = Benchmark(
            speech_path,
            reference_path,
            show_progress=True,
            show_report=False,
            batch_size=batch_size,
            # multi_stream trials reuse ONE compiled engine across the whole
            # study (hyper-parameters are dynamic step inputs), so each trial
            # costs device steps only — no per-trial recompilation
            multi_stream=multi_stream,
        )
        self.metric = metric
        self.direction = direction
        self.base_config = base_config
        self.do_kickstart_hparams = do_kickstart_hparams
        if self.base_config is None:
            self.base_config = self.pipeline_class.get_config_class()()
            self.do_kickstart_hparams = False
        self.hparams = hparams or self.pipeline_class.hyper_parameters()

        possible = vars(self.base_config)
        for param in self.hparams:
            assert param.name in possible, (
                f"hyper-parameter {param.name} not found in "
                f"{self.base_config.__class__.__name__}"
            )

        if isinstance(study_or_path, Study):
            self.study = study_or_path
        elif self._is_optuna_study(study_or_path):
            self.study = study_or_path
        elif isinstance(study_or_path, (str, Path)):
            study_dir = Path(study_or_path)
            self.study = Study(
                study_dir / f"{study_dir.stem}.db",
                direction=direction,
            )
        else:
            raise ValueError(
                f"expected Study or path-like, got {type(study_or_path).__name__}"
            )

    @staticmethod
    def _is_optuna_study(obj) -> bool:
        try:
            import optuna

            return isinstance(obj, optuna.Study)
        except ImportError:
            return False

    @property
    def best_performance(self) -> float:
        return self.study.best_value

    @property
    def best_hparams(self) -> Dict[str, float]:
        return self.study.best_params

    def _evaluate(self, trial_params: Dict[str, float]) -> float:
        config_args = dict(vars(self.base_config))
        # strip private attrs of the config (duration/step/... are exposed
        # via properties named without the underscore)
        config_args = {k.lstrip("_"): v for k, v in config_args.items()}
        config_args.update(trial_params)
        config = self.base_config.__class__(**config_args)
        metric = self.metric or self.pipeline_class.suggest_metric()
        metric.reset()
        # the report's TOTAL, 100 * metric(summed components), without pandas
        for hyp in self.benchmark.predict(self.pipeline_class, config):
            metric(next(iter(load_rttm(self.reference_path / f"{hyp.uri}.rttm").values())), hyp)
        return 100.0 * abs(metric)

    def objective(self, trial) -> float:
        """Optuna-compatible objective (used when an optuna Study is given)."""
        trial_params = {
            hp.name: trial.suggest_float(hp.name, hp.low, hp.high)
            for hp in self.hparams
        }
        return self._evaluate(trial_params)

    def __call__(self, num_iter: int, show_progress: bool = True):
        if self.do_kickstart_hparams:
            # both study kinds expose the same enqueue_trial surface
            self.study.enqueue_trial(
                {hp.name: getattr(self.base_config, hp.name) for hp in self.hparams},
                skip_if_exists=True,
            )
        if self._is_optuna_study(self.study):
            self.study.optimize(self.objective, num_iter)
            return

        for i in range(num_iter):
            params = self.study.ask(self.hparams)
            value = self._evaluate(params)
            self.study.tell(params, value)
            if show_progress:
                best = self.study.best_value
                print(
                    f"Trial {i + 1}/{num_iter}: value={value:.3f} "
                    f"params={ {k: round(v, 4) for k, v in params.items()} } "
                    f"(best={best:.3f})"
                )
