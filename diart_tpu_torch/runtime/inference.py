"""Streaming inference engine, batch benchmark, and parallel benchmark
(port of ``diart_tpu/runtime/inference.py``).

Parity targets in diart's ``inference.py``:
``StreamingInference`` (``:26-231``) — assembles the
source -> re-chunk -> resample -> batch -> pipeline -> sinks graph and blocks
on the source; ``Benchmark`` (``:234-432``) — runs a pipeline over a
directory of files and scores against reference RTTMs; ``Parallelize``
(``:435-559``) — process-level fan-out.

``Benchmark(multi_stream=True)`` runs the files as one batched
:class:`diart_tpu_torch.parallel.MultiStreamEngine` session — files become
the stream-batch dimension on the card, replacing the reference's process
pool with parallelism on the device.

Everything runs where the pipeline's models live (the card unless they were
built with ``device="cpu"``). pandas is imported only where a report is
built: a :class:`Benchmark` without a reference path runs without it.
"""

from __future__ import annotations

import logging
from pathlib import Path
from traceback import print_exc
from typing import TYPE_CHECKING, Callable, List, Optional, Text, Tuple, Union

import numpy as np
import torch

from .. import blocks
from .. import precision as precision_policy
from .. import utils
from ..core.annotation import Annotation, load_rttm
from ..core.segment import SlidingWindowFeature
from ..metrics import BaseMetric
from ..progress import ProgressBar, RichProgressBar, TQDMProgressBar
from . import operators as dops
from . import sources as src
from .rx import Observer, ops
from .sinks import PredictionAccumulator, StreamingPlot, WindowClosedException

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["StreamingInference", "Benchmark", "Parallelize"]


class StreamingInference:
    """Drive one audio source through a pipeline in real time.

    Behavioral parity target: diart's streaming driver
    (its ``inference.py:26-231``) — sliding-window
    re-chunking, optional resampling, chunk batching, profiled pipeline
    application, prediction accumulation, progress reporting, hook/observer
    attachment, and error fan-out to attached observers. The chain here is
    assembled from three stage groups (ingest / process / report) built by
    dedicated helpers, so each concern can be read and changed in isolation.

    Sources push host audio; the pipeline copies each batch of chunks to its
    device and its fetch ends the call with one copy back, so the
    profiler's times (``utils.Chronometer`` around the pipeline call)
    include the card's work.
    """

    def __init__(
        self,
        pipeline: blocks.Pipeline,
        source: src.AudioSource,
        batch_size: int = 1,
        do_profile: bool = True,
        do_plot: bool = False,
        show_progress: bool = True,
        progress_bar: Optional[ProgressBar] = None,
    ):
        self.pipeline = pipeline
        self.source = source
        self.batch_size = batch_size
        self.do_profile = do_profile
        self.do_plot = do_plot
        self.show_progress = show_progress
        self.accumulator = PredictionAccumulator(source.uri)
        self.unit = "batch" if batch_size > 1 else "chunk"
        self._observers = []
        self.num_chunks = self._estimate_window_count()
        self._pbar = self._build_progress(progress_bar)
        self._chrono = utils.Chronometer(self.unit, self._pbar)
        self.stream = self.source.stream.pipe(
            *self._ingest_stages(),
            *self._process_stages(),
            *self._report_stages(),
        )

    # -------------------------------------------------------------- #
    # Chain assembly
    # -------------------------------------------------------------- #
    def _estimate_window_count(self) -> Optional[int]:
        """Sliding windows a finite source will yield: one when the first
        ``duration`` seconds complete, then one per ``step``-second hop over
        the remainder. None for unbounded sources (e.g. microphone)."""
        total = self.source.duration
        if total is None:
            return None
        cfg = self.pipeline.config
        return 1 + int(np.ceil((total - cfg.duration) / cfg.step))

    def _build_progress(self, pbar: Optional[ProgressBar]) -> Optional[ProgressBar]:
        if not self.show_progress:
            return pbar
        if pbar is None:
            pbar = RichProgressBar()
        pbar.create(
            total=self.num_chunks,
            description=f"Streaming {self.source.uri}",
            unit=self.unit,
        )
        return pbar

    def _ingest_stages(self) -> list:
        """Raw source samples -> batches of pipeline-ready chunks."""
        cfg = self.pipeline.config
        stages = [
            dops.rearrange_audio_stream(
                cfg.duration, cfg.step, self.source.sample_rate
            )
        ]
        if self.source.sample_rate != cfg.sample_rate:
            logging.warning(
                "Audio source has sample rate %s, but pipeline's is %s. "
                "Will resample.",
                self.source.sample_rate,
                cfg.sample_rate,
            )
            stages.append(
                ops.map(
                    blocks.Resample(
                        self.source.sample_rate,
                        cfg.sample_rate,
                        device=getattr(cfg, "device", None),
                    )
                )
            )
        stages.append(ops.buffer_with_count(self.batch_size))
        return stages

    def _process_stages(self) -> list:
        """Apply the pipeline to each batch, timed when profiling."""
        run = ops.map(self.pipeline)
        if not self.do_profile:
            return [run]
        return [
            ops.do_action(lambda _: self._chrono.start()),
            run,
            ops.do_action(lambda _: self._chrono.stop()),
        ]

    def _report_stages(self) -> list:
        """Unbatch results, accumulate them, advance the progress bar."""
        stages = [
            ops.flat_map(lambda results: results),
            ops.do(self.accumulator),
        ]
        if self.show_progress:
            stages.append(ops.do_action(lambda _: self._pbar.update()))
        return stages

    # -------------------------------------------------------------- #
    # Attachment + lifecycle
    # -------------------------------------------------------------- #
    def attach_hooks(
        self, *hooks: Callable[[Tuple[Annotation, SlidingWindowFeature]], None]
    ):
        """Run side-effect callbacks on each (prediction, audio) pair."""
        self.stream = self.stream.pipe(*[ops.do_action(hook) for hook in hooks])

    def attach_observers(self, *observers: Observer):
        """Attach full observers (on_next/on_error/on_completed)."""
        self.stream = self.stream.pipe(*[ops.do(sink) for sink in observers])
        self._observers.extend(observers)

    def _shutdown(self, error: Optional[BaseException] = None):
        """Tear down after completion or error: close the source and settle
        progress/profiling reporting. Observers are NOT re-notified here —
        every attached observer sits in the chain via ``ops.do``, whose
        on_error tees the error into the sink before passing it down to
        this terminal callback, so a second delivery would violate the
        once-only observer contract (e.g. RTTMWriter would patch its file
        twice)."""
        if error is not None:
            self.source.close()
            expected = (WindowClosedException, KeyboardInterrupt)
            if not isinstance(error, expected):
                print_exc()
        if self._pbar is not None:
            self._pbar.close()
        if self.do_profile:
            if self._chrono.is_running:
                self._chrono.stop(do_count=False)
            self._chrono.report()

    def __call__(self) -> Annotation:
        """Blocks until the source is exhausted; returns the accumulated
        prediction."""
        if self.show_progress:
            self._pbar.start()
        chain = self.stream
        if self.do_plot:
            cfg = self.pipeline.config
            chain = chain.pipe(
                dops.buffer_output(
                    duration=cfg.duration,
                    step=cfg.step,
                    latency=cfg.latency,
                    sample_rate=cfg.sample_rate,
                ),
                ops.do(StreamingPlot(cfg.duration, cfg.latency)),
            )
        chain.subscribe(on_error=self._shutdown, on_completed=self._shutdown)
        self.source.read()  # blocking
        return self.accumulator.get_prediction()


class Benchmark:
    """Run a pipeline over a directory of audio files; optionally score
    against reference RTTMs (``inference.py:234-432``)."""

    def __init__(
        self,
        speech_path: Union[Text, Path],
        reference_path: Optional[Union[Text, Path]] = None,
        output_path: Optional[Union[Text, Path]] = None,
        show_progress: bool = True,
        show_report: bool = True,
        batch_size: int = 32,
        multi_stream: bool = False,
    ):
        self.multi_stream = multi_stream
        self.speech_path = Path(speech_path).expanduser()
        assert self.speech_path.is_dir(), "Speech path must be a directory"
        msg = "Benchmark expected reference path, output path or both"
        assert reference_path is not None or output_path is not None, msg
        self.reference_path = reference_path
        if reference_path is not None:
            self.reference_path = Path(reference_path).expanduser()
            assert self.reference_path.is_dir(), "Reference path must be a directory"
        self.output_path = output_path
        if self.output_path is not None:
            self.output_path = Path(output_path).expanduser()
            self.output_path.mkdir(parents=True, exist_ok=True)
        self.show_progress = show_progress
        self.show_report = show_report
        self.batch_size = batch_size

    def get_file_paths(self) -> List[Path]:
        return sorted(p for p in self.speech_path.iterdir() if p.is_file())

    def __getstate__(self):
        # the cached engine stays in this process (Parallelize ships the
        # Benchmark to spawn workers); it rebuilds lazily on first
        # multi-stream run
        state = self.__dict__.copy()
        state.pop("_engine_cache", None)
        return state

    def run_single(
        self,
        pipeline: blocks.Pipeline,
        filepath: Path,
        progress_bar: Optional[ProgressBar],
    ) -> Annotation:
        """Run one file through the (already reset) pipeline."""
        padding = pipeline.config.get_file_padding(filepath)
        source = src.FileAudioSource(
            filepath, pipeline.config.sample_rate, padding, pipeline.config.step
        )
        pipeline.set_timestamp_shift(-padding[0])
        inference = StreamingInference(
            pipeline,
            source,
            self.batch_size,
            do_profile=False,
            do_plot=False,
            show_progress=self.show_progress,
            progress_bar=progress_bar,
        )
        pred = inference()
        pred.uri = source.uri
        if self.output_path is not None:
            with open(self.output_path / f"{source.uri}.rttm", "w") as out:
                pred.write_rttm(out)
        return pred

    def evaluate(
        self, predictions: List[Annotation], metric: BaseMetric
    ) -> Union["pd.DataFrame", List[Annotation]]:
        if self.reference_path is None:
            return predictions
        for hyp in predictions:
            refs = load_rttm(self.reference_path / f"{hyp.uri}.rttm")
            ref = next(iter(refs.values()))
            metric(ref, hyp)
        return metric.report(display=self.show_report)

    @staticmethod
    def _padded_block_stream(path, sample_rate, left, right, n):
        """Generator of n-sample float32 blocks of
        ``[left-pad zeros | file audio | right-pad zeros]``.

        WAV files at the target rate stream from disk block by block (a
        corpus of 90-minute meetings never fully materializes in host
        memory); other containers/rates fall back to one full decode.
        The final partial block is zero-padded to n.
        """
        from ..audio import AudioLoader, WavBlockReader

        def pieces():
            yield np.zeros(int(np.rint(left * sample_rate)), np.float32)
            reader = None
            if str(path).lower().endswith(".wav"):
                try:
                    candidate = WavBlockReader(path)
                    if candidate.sample_rate == sample_rate:
                        reader = candidate
                    else:
                        candidate.close()
                except ValueError:
                    reader = None
            if reader is not None:
                with reader:
                    while True:
                        piece = reader.read_block(max(n, 65536))
                        if piece.size == 0:
                            break
                        yield piece
            else:
                yield AudioLoader(sample_rate, mono=True).load(path)[0]
            yield np.zeros(int(np.rint(right * sample_rate)), np.float32)

        pending: List[np.ndarray] = []
        pending_len = 0
        for piece in pieces():
            pending.append(piece)
            pending_len += piece.shape[0]
            while pending_len >= n:
                flat = np.concatenate(pending) if len(pending) > 1 else pending[0]
                yield flat[:n]
                pending = [flat[n:]]
                pending_len = flat.shape[0] - n
        if pending_len > 0:
            tail = np.zeros(n, np.float32)
            flat = np.concatenate(pending) if len(pending) > 1 else pending[0]
            tail[:pending_len] = flat
            yield tail

    def run_multi_stream(
        self, pipeline_class: type, config: blocks.PipelineConfig
    ) -> List[Annotation]:
        """Run ALL files as one batched engine session: files become the
        stream dimension of a fused :class:`MultiStreamEngine` step — the
        on-device replacement for the reference's per-file loop and process
        pool (``inference.py:435-559``). Supports SpeakerDiarization and
        VoiceActivityDetection (the engine's VAD mode skips embedding and
        clustering entirely). The engine runs where the config's models
        live, under the precision policy active at this call."""
        from ..parallel.engine import MultiStreamEngine
        from ..parallel.session import MultiStreamSession
        from .sinks import PredictionAccumulator

        is_vad = pipeline_class is blocks.VoiceActivityDetection
        assert is_vad or pipeline_class is blocks.SpeakerDiarization, (
            "multi_stream benchmarking supports SpeakerDiarization and "
            "VoiceActivityDetection"
        )
        paths = self.get_file_paths()
        if not paths:
            # match the per-file path's graceful empty result instead of
            # building a batch_size=0 engine and crashing downstream
            return []
        b = len(paths)
        # The engine's tunable hyper-parameters (tau/rho/delta/gamma/beta)
        # are device tensors its step reads, so repeated calls with
        # different configs — a tuning sweep — reuse ONE engine (its
        # built kernels, device constants and staging).
        # Key by the model OBJECTS (identity comparison, and the strong refs
        # held by the cache keep them alive) — id() alone can be recycled
        # after garbage collection, silently pairing a new config with an
        # engine built around a dead model's weights. The cache is a
        # single slot, so at most ONE engine (and its models' params) stays
        # pinned: a sweep over distinct model configs replaces the slot each
        # time instead of accumulating every engine for the process
        # lifetime. The engine holds the precision policy it was built
        # under, and resolves some of its switches at construction (the
        # ``DIART_TPU_*`` variables included), so the policy and what it
        # resolves to are part of the key.
        cache_key = (
            config.segmentation,
            None if is_vad else config.embedding,
            config.duration,
            config.step,
            config.latency,
            config.sample_rate,
            getattr(config, "max_speakers", 20),
            getattr(config, "normalize_embedding_weights", False),
            b,
            precision_policy.active(),
            tuple(precision_policy.active().resolved(config.segmentation.device).items()),
        )
        engine = None
        if getattr(self, "_engine_cache", None) is not None:
            cached_key, cached_engine = self._engine_cache
            if cached_key == cache_key:
                engine = cached_engine
                engine.set_hyperparameters(
                    tau_active=config.tau_active,
                    rho_update=getattr(config, "rho_update", 0.3),
                    delta_new=getattr(config, "delta_new", 1.0),
                    gamma=getattr(config, "gamma", 3.0),
                    beta=getattr(config, "beta", 10.0),
                )
        if engine is None:
            engine = MultiStreamEngine(
                segmentation=config.segmentation,
                embedding=None if is_vad else config.embedding,
                duration=config.duration,
                step=config.step,
                latency=config.latency,
                sample_rate=config.sample_rate,
                tau_active=config.tau_active,
                rho_update=getattr(config, "rho_update", 0.3),
                delta_new=getattr(config, "delta_new", 1.0),
                gamma=getattr(config, "gamma", 3.0),
                beta=getattr(config, "beta", 10.0),
                max_speakers=getattr(config, "max_speakers", 20),
                normalize_embedding_weights=getattr(
                    config, "normalize_embedding_weights", False
                ),
                batch_size=b,
            )
            self._engine_cache = (cache_key, engine)
        sr = config.sample_rate
        n = engine.step_samples
        streams, shifts = [], []
        for path in paths:
            left, right = config.get_file_padding(path)
            streams.append(self._padded_block_stream(path, sr, left, right, n))
            shifts.append(-left)

        session = MultiStreamSession(
            engine,
            uris=[p.stem for p in paths],
            tau_active=config.tau_active,
            timestamp_shifts=shifts,
            collect_audio=False,
        )
        accumulators = [PredictionAccumulator(p.stem) for p in paths]
        # run until EVERY stream is exhausted (a duration-derived block
        # estimate can undercount by one when fractional paddings round
        # up, and the dropped final block is the right padding that
        # flushes the last latency window)
        while True:
            present = np.zeros(b, bool)
            batch = np.zeros((b, n), np.float32)
            for i, stream in enumerate(streams):
                block = next(stream, None)
                if block is not None:
                    batch[i] = block
                    present[i] = True
            if not present.any():
                break
            outputs = session.push(batch, present)
            for i, out in enumerate(outputs):
                if out is not None:
                    annotation = out[0]
                    if is_vad:
                        annotation = annotation.rename_labels(
                            {l: "speech" for l in annotation.labels()}
                        )
                    accumulators[i].on_next(annotation)

        predictions = []
        for i, path in enumerate(paths):
            pred = accumulators[i].get_prediction()
            pred.uri = path.stem
            predictions.append(pred)
            if self.output_path is not None:
                with open(self.output_path / f"{path.stem}.rttm", "w") as out:
                    pred.write_rttm(out)
        return predictions

    def predict(self, pipeline_class: type, config: blocks.PipelineConfig) -> List[Annotation]:
        """Every file's prediction (written to the output path, where there
        is one), unscored: the files as one engine session with
        ``multi_stream``, else one after another through a pipeline."""
        if self.multi_stream:
            return self.run_multi_stream(pipeline_class, config)

        audio_file_paths = self.get_file_paths()
        num_files = len(audio_file_paths)
        pipeline = pipeline_class(config)

        predictions = []
        for i, filepath in enumerate(audio_file_paths):
            pipeline.reset()
            desc = f"Streaming {filepath.stem} ({i + 1}/{num_files})"
            progress = TQDMProgressBar(desc, leave=False, do_close=True)
            predictions.append(self.run_single(pipeline, filepath, progress))
        return predictions

    def __call__(
        self,
        pipeline_class: type,
        config: blocks.PipelineConfig,
        metric: Optional[BaseMetric] = None,
    ) -> Union["pd.DataFrame", List[Annotation]]:
        predictions = self.predict(pipeline_class, config)
        metric = pipeline_class.suggest_metric() if metric is None else metric
        return self.evaluate(predictions, metric)


def _numerics() -> Tuple[precision_policy.Precision, bool, bool]:
    """What decides the caller's numbers besides the weights: its precision
    policy and torch's TF32 switches for matmuls and cuDNN."""
    return (
        precision_policy.active(),
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )


def _parallel_worker_init(
    policy: precision_policy.Precision, matmul_tf32: bool, cudnn_tf32: bool
) -> None:
    """Pool initializer: the caller's numerics (:func:`_numerics`) become the
    worker's; none of them crosses a process on its own."""
    precision_policy.set_default(policy)
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


class Parallelize:
    """Process-level fan-out of a Benchmark (``inference.py:435-559``).

    Workers start with ``spawn`` (CUDA does not survive a fork). The config
    is pickled to each worker with torch's multiprocessing reductions. A
    model crosses as its loader (``LazyModel``: a registry name and seed, a
    file), and each worker builds it on the caller's device at first use;
    a module or callable passed in (``from_apply``, the constructor)
    crosses as it is, as CUDA IPC handles of the caller's weights on the
    card and in shared memory on the CPU. The caller's precision policy and
    TF32 switches become each worker's (the ``DIART_TPU_*`` variables
    cross with the environment), so a worker gives the caller's numbers. On the
    card the preferred scale-out is ``MultiStreamEngine``
    batching (``Benchmark(multi_stream=True)``); this class is kept for API
    parity.
    """

    def __init__(self, benchmark: Benchmark, num_workers: int = 4):
        self.benchmark = benchmark
        self.num_workers = num_workers

    def run_single_job(
        self,
        pipeline_class: type,
        config: blocks.PipelineConfig,
        filepath: Path,
        description: Text,
    ) -> Annotation:
        from multiprocessing import current_process

        try:
            idx_process = int(current_process().name.split("-")[1]) - 1
        except (IndexError, ValueError):
            idx_process = 0
        pipeline = pipeline_class(config)
        progress = TQDMProgressBar(
            description, leave=False, position=idx_process, do_close=True
        )
        return self.benchmark.run_single(pipeline, filepath, progress)

    def __call__(
        self,
        pipeline_class: type,
        config: blocks.PipelineConfig,
        metric: Optional[BaseMetric] = None,
    ) -> Union["pd.DataFrame", List[Annotation]]:
        import multiprocessing as mp

        audio_file_paths = self.benchmark.get_file_paths()
        num_files = len(audio_file_paths)
        ctx = mp.get_context("spawn")
        with ctx.Pool(
            processes=self.num_workers,
            initializer=_parallel_worker_init,
            initargs=_numerics(),
        ) as pool:
            jobs = [
                pool.apply_async(
                    self.run_single_job,
                    args=(
                        pipeline_class,
                        config,
                        filepath,
                        f"Streaming {filepath.stem} ({i + 1}/{num_files})",
                    ),
                )
                for i, filepath in enumerate(audio_file_paths)
            ]
            predictions = [job.get() for job in jobs]
            # let the workers exit on their own (the pool's exit would kill
            # them) so they release the caller's CUDA tensors first, then
            # free what they held
            pool.close()
            pool.join()
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()
        metric = pipeline_class.suggest_metric() if metric is None else metric
        return self.benchmark.evaluate(predictions, metric)
