"""Fused multi-stream diarization engine (port of
``diart_tpu/parallel/engine.py``).

One ``step`` advances B independent audio streams by one hop:

  audio ring update (and, for a mel embedding, its log-mel frame ring) ->
  segmentation forward -> OSP weights -> embedding trunk (once) + fused
  per-speaker statistics head -> embedding normalization -> masked online
  clustering (batched over streams) -> score ring update -> Hamming
  overlap-add aggregation

Every tensor is fixed-shape and batched over streams, and the step never
synchronizes with the host: warm-up, pauses and resets are masks selected
with ``torch.where``, and the hyper-parameters are device tensors, so
retuning changes no code path. The host supplies one block of audio per
stream per hop (float32 or int16 PCM) and reads the latency-delayed
aggregated scores.

Mel frame ring (``fbank_ring``, as in the JAX engine): every log-mel stage
up to the window-level normalization is frame-local, so a mel embedding's
raw per-frame features of the unchanged samples live in a chronological
ring across hops; each step computes only the new block's frames and the
window-edge frames, and the model's ``trunk_from_raw_fbank`` takes the
assembled window. The ring advances by a static slice + concat, and a
paused stream's ring freezes by a masked select, like the waveform window.

Stream sharding (``mesh``, a :class:`~.mesh.StreamsMesh`): where JAX
shards one global array along a ``streams`` mesh axis, the port holds one
unsharded engine a shard slot, each with its own replica of the models
(copied once a distinct device; slots on one device share it) and its own
state. The state is the :class:`StreamState` of the whole axis with every
leaf a :class:`Sharded` tuple of the shards' tensors, in stream order; a
step cuts the host inputs by rows and queues every shard's step on its
device with no host wait. Streams are independent, so the step has no
collective, as XLA inserts none.

Stacked SincNet frontend (``stack_frontend``, off by default as in the JAX
engine): when the segmentation and the embedding carry distinct SincNet
filterbanks of one geometry (real checkpoint pairs; the registry's share
their mel init, and identical filterbanks do not stack), the engine folds
each model's waveform-norm affine into its filters and bias
(``conv(z s + b) = s conv(z) + b sum(filters)``) and runs one 160-channel
sinc first stage (``ops/sinc_frontend.py``: true f32 on the CPU, the
hand-written kernel on a card) on the shared standardized waveform; the
models take the pooled halves (``sinc_pooled``), as JAX's do.

Difference from the JAX engine: no phase-major audio ring (a TPU layout
trick — the window is the plain (B, samples) array it describes). A JAX
session file's phase-major window is laid out flat on restore
(``parallel/session.py``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import precision as precision_policy
from .. import tracing
from ..models.base import EmbeddingModel, SegmentationModel, same_device
from ..models.common import held_operands
from ..models.fbank import (
    FbankRingSpec,
    fbank_block_raw,
    fbank_edge_left,
    fbank_edge_right,
    fbank_ring_fill,
    fbank_ring_spec,
)
from ..models.sincnet import SincNet
from ..ops.aggregation import AggregationGeometry, aggregate, build_geometry
from ..ops.clustering import ClusteringParams, ClusteringState, cluster_step
from ..ops.functional import (
    min_max_normalize,
    normalize_embeddings,
    overlapped_speech_penalty,
)
from ..ops.sinc_frontend import prepare_sinc_operands, sinc_frontend

from .mesh import StreamsMesh

__all__ = ["MultiStreamEngine", "Sharded", "StepOutput", "StreamState", "to_device"]


def to_device(value, device: torch.device, dtype=None) -> torch.Tensor:
    """A host input (numpy array, CPU tensor) on ``device`` without a host
    wait: bound for the card, it is copied into pinned memory from the
    caching host allocator and from there with ``non_blocking=True`` (a copy
    from pageable memory waits for all the work queued so far). The
    allocator keeps the pinned block until its copy has run, so the caller
    may reuse its array at once. Non-integer numpy input becomes float32."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if dtype is None and not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32, copy=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        # a plain host copy into a pinned block, not Tensor.pin_memory(): that
        # first asks the driver whether the source is pinned, and took
        # milliseconds now and then while the card was busy
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        np.copyto(staged.numpy(), t.numpy())
        return staged.to(device, non_blocking=True)
    return t.to(device)


class StreamState(NamedTuple):
    """Batched per-stream state (leading axis = streams)."""

    # (B, chunk_samples) rolling waveform window; with the mel frame ring
    # the dict {"window": that window, "ring": (B, nb * fpb, mels) raw
    # log-mel frames, chronological, "head": (B, nb, head_len) each block's
    # first samples, "tail": (B, tail_len) newest samples}
    audio: Union[torch.Tensor, dict]
    ring: torch.Tensor  # (B, W, frames, M) permuted score ring, newest first
    centers: torch.Tensor  # (B, M, E) centroid sums
    center_active: torch.Tensor  # (B, M) bool
    initialized: torch.Tensor  # (B,) bool
    chunk_count: torch.Tensor  # (B,) int32 chunks emitted so far


class StepOutput(NamedTuple):
    aggregated: torch.Tensor  # (B, num_out, M) latency-delayed scores
    newest: torch.Tensor  # (B, frames, M) permuted scores of the new chunk
    chunk_index: torch.Tensor  # (B,) 0-based index of the chunk just emitted


class Sharded(tuple):
    """One array of the streams axis held as its shards' tensors, in stream
    order, each on its shard's device: a leaf of a sharded engine's state
    and outputs. ``shape`` and ``dtype`` are the whole array's; ``cpu()``
    assembles it on the host."""

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(t.shape[0] for t in self),) + tuple(self[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    def cpu(self) -> torch.Tensor:
        return torch.cat([t.cpu() for t in self])


def _map(tree, fn: Callable):
    """``fn`` on every tensor leaf of a state, an output or a dict of them."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _join(parts: list):
    """The shards' states (or outputs) as one whose leaves are
    :class:`Sharded`."""
    first = parts[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_join([p[i] for p in parts]) for i in range(len(first))))
    if isinstance(first, dict):
        return {k: _join([p[k] for p in parts]) for k in first}
    return Sharded(parts)


def _sincnet(model) -> Optional[SincNet]:
    """A model's SincNet frontend, or None."""
    sincnet = getattr(getattr(model, "module", None), "sincnet", None)
    return sincnet if isinstance(sincnet, SincNet) else None


def _sinc_geometry(sincnet: SincNet) -> tuple:
    """What one stacked convolution must share: (stride, kernel size,
    min low Hz, min band Hz, sample rate)."""
    sinc = sincnet.sinc
    return sinc.stride, sinc.kernel_size, sinc.min_low_hz, sinc.min_band_hz, sinc.sample_rate


def _stackable(seg: Optional[SincNet], emb: Optional[SincNet]) -> bool:
    """Whether two SincNets stack: both there, one geometry, distinct
    filterbanks or waveform norms (identical ones would double the work)."""
    if seg is None or emb is None or _sinc_geometry(seg) != _sinc_geometry(emb):
        return False
    names = ("sinc.low_hz", "sinc.band_hz", "wav_norm_scale", "wav_norm_bias")
    return not all(torch.equal(seg.get_parameter(n), emb.get_parameter(n)) for n in names)


def _rows(value, lo: int, hi: int):
    """Rows ``lo:hi`` of a host or device input (None stays None)."""
    return None if value is None else value[lo:hi]


class MultiStreamEngine:
    """Drives B concurrent streams through one batched step.

    segmentation / embedding: device models on one device (the engine
    runs where they live). ``embedding=None`` is VAD mode: segmentation +
    aggregation, no clustering. The remaining arguments mirror the JAX
    engine's.

    mesh: optional :class:`~.mesh.StreamsMesh`; ``batch_size`` is then the
    whole axis's (divisible by ``mesh.size``), and this engine drives
    ``mesh.local_slice(batch_size)`` of it: ``batch_size`` becomes this
    process's count (``global_batch_size`` keeps the axis's), and
    ``shard_bounds`` lists each local shard's rows. Its states and outputs
    have :class:`Sharded` leaves.
    """

    def __init__(
        self,
        segmentation: SegmentationModel,
        embedding: Optional[EmbeddingModel] = None,
        duration: float = 5.0,
        step: float = 0.5,
        latency: Optional[float] = None,
        sample_rate: int = 16000,
        tau_active: float = 0.6,
        rho_update: float = 0.3,
        delta_new: float = 1.0,
        gamma: float = 3.0,
        beta: float = 10.0,
        max_speakers: int = 20,
        normalize_embedding_weights: bool = False,
        batch_size: int = 1,
        precision: Optional[precision_policy.Precision] = None,
        mesh: Optional[StreamsMesh] = None,
    ):
        self.duration = duration
        self.step_duration = step
        self.latency = step if latency in (None, "min") else (
            duration if latency == "max" else float(latency)
        )
        assert step <= self.latency <= duration, f"latency must be within [{step}, {duration}]"
        for name, value in (("duration", duration), ("latency", self.latency)):
            ratio = value / step
            if abs(ratio - round(ratio)) > 1e-6:
                raise ValueError(
                    f"{name} ({value}) must be an integer multiple of step "
                    f"({step}); got ratio {ratio:.4f}"
                )
        self.sample_rate = sample_rate
        self.batch_size = batch_size
        self.max_speakers = max_speakers
        self.precision = precision if precision is not None else precision_policy.active()
        self.normalize_weights = normalize_embedding_weights
        self._shards: List["MultiStreamEngine"] = []  # one a shard slot, with a mesh
        self._shard: Optional[int] = None  # a shard slot's index, which its phase spans carry
        if segmentation.host_only or (embedding is not None and embedding.host_only):
            raise RuntimeError(
                "MultiStreamEngine requires device models; host-only (ONNX) models run "
                "through the SpeakerDiarization / VoiceActivityDetection pipeline path instead"
            )
        self.device = segmentation.device
        self._seg = segmentation
        self._emb = embedding
        self.is_vad = embedding is None
        if not self.is_vad and embedding.device != self.device:
            raise ValueError(
                f"segmentation is on {self.device} but embedding on {embedding.device}"
            )
        self.embedding_dim = 1 if self.is_vad else embedding.embedding_dim
        self.set_hyperparameters(
            tau_active=tau_active,
            rho_update=rho_update,
            delta_new=delta_new,
            gamma=gamma,
            beta=beta,
        )

        self.chunk_samples = int(round(duration * sample_rate))
        self.step_samples = int(round(step * sample_rate))
        # the mel frame ring engages for a mel embedding whose geometry the
        # incremental decomposition covers (fbank_ring_spec says which)
        self._fring: Optional[FbankRingSpec] = None
        with precision_policy.use(self.precision):
            fring_on = precision_policy.enabled("fbank_ring", self.device)
        if fring_on and not self.is_vad and embedding.fbank_ring_kind is not None:
            self._fring = fbank_ring_spec(
                embedding.fbank_ring_kind, int(embedding.num_mels),
                int(embedding.sample_rate), self.chunk_samples, self.step_samples,
            )
        # (segmentation's SincNet, embedding's SincNet) when the stacked
        # frontend runs (see the module docstring), else None
        self._stacked: Optional[Tuple[SincNet, SincNet]] = None
        with precision_policy.use(self.precision):
            stack_on = precision_policy.enabled("stack_frontend", self.device)
        if stack_on and not self.is_vad and _stackable(_sincnet(segmentation), _sincnet(embedding)):
            self._stacked = (_sincnet(segmentation), _sincnet(embedding))
        self._audio_row = None
        self.num_frames = segmentation.num_frames(self.chunk_samples)
        self.num_local = segmentation.num_speakers
        self._score_dims = 1 if self.is_vad else max_speakers
        self.geometry: AggregationGeometry = build_geometry(
            duration, step, self.latency, self.num_frames, strategy="hamming"
        )
        self._plan = (
            torch.as_tensor(self.geometry.indices, device=self.device).long(),
            torch.as_tensor(self.geometry.weights, device=self.device),
        )
        self._true_masks: dict = {}

        self.mesh = mesh
        self.global_batch_size = batch_size
        self.shard_bounds: List[Tuple[int, int]] = [(0, batch_size)]
        if mesh is not None:
            per = mesh.shard_size(batch_size)
            self.batch_size = per * len(mesh.devices)
            self.shard_bounds = [(i * per, (i + 1) * per) for i in range(len(mesh.devices))]
            self.device = mesh.devices[0]
            replicas: list = []
            for dev in mesh.devices:
                held = next((r for d, r in replicas if same_device(d, dev)), None)
                if held is None:
                    held = (segmentation.replicate(dev),
                            None if embedding is None else embedding.replicate(dev))
                    replicas.append((dev, held))
                self._shards.append(MultiStreamEngine(
                    held[0], held[1], duration=duration, step=step, latency=latency,
                    sample_rate=sample_rate, tau_active=tau_active, rho_update=rho_update,
                    delta_new=delta_new, gamma=gamma, beta=beta, max_speakers=max_speakers,
                    normalize_embedding_weights=normalize_embedding_weights, batch_size=per,
                    precision=self.precision,
                ))
                self._shards[-1]._shard = len(self._shards) - 1

    # ------------------------------------------------------------------ #
    def set_hyperparameters(
        self,
        tau_active: Optional[float] = None,
        rho_update: Optional[float] = None,
        delta_new: Optional[float] = None,
        gamma: Optional[float] = None,
        beta: Optional[float] = None,
    ) -> None:
        """Update tunable hyper-parameters; they are device tensors read by
        the step, so nothing is rebuilt, and the next step queued reads the
        new values. The values go through a pinned copy, so an update
        between hops does not wait for the card."""
        for shard in self._shards:
            shard.set_hyperparameters(tau_active, rho_update, delta_new, gamma, beta)
        old = getattr(self, "_hparams", None)
        get = lambda new, i: (
            to_device(np.asarray(float(new), np.float32), self.device)
            if new is not None
            else old[i]
        )
        self._hparams = (
            get(tau_active, 0),
            get(rho_update, 1),
            get(delta_new, 2),
            get(gamma, 3),
            get(beta, 4),
        )

    @property
    def cluster_params(self) -> ClusteringParams:
        """The clustering thresholds the next step reads (tau_active,
        rho_update, delta_new), as 0-d tensors on the engine's device."""
        return ClusteringParams(*self._hparams[:3])

    @property
    def gamma(self) -> float:
        return float(self._hparams[3])

    @property
    def beta(self) -> float:
        return float(self._hparams[4])

    # ------------------------------------------------------------------ #
    def _audio_init(self, b: int):
        """The initial audio state of ``b`` streams: a zero window and, with
        the frame ring, a ring holding the frames of an all-zero signal (a
        non-zero constant for log features) and zero head/tail samples."""
        window = torch.zeros(b, self.chunk_samples, device=self.device)
        if self._fring is None:
            return window
        s = self._fring
        fill = to_device(fbank_ring_fill(s), self.device)
        return {
            "window": window,
            "ring": fill.expand(b, s.nb * s.fpb, s.num_mels).clone(),
            # per-block window-start samples, chronological: head[:, 0] is
            # the oldest block's, which the left-edge frames read
            "head": torch.zeros(b, s.nb, max(s.head_len, 1), device=self.device),
            "tail": torch.zeros(b, max(s.tail_len, 1), device=self.device),
        }

    def init_state(self, batch_size: Optional[int] = None) -> StreamState:
        if self._shards:
            if batch_size not in (None, self.batch_size):
                raise ValueError(f"a sharded engine holds {self.batch_size} streams; got {batch_size}")
            return _join([shard.init_state() for shard in self._shards])
        b = batch_size or self.batch_size
        dev = self.device
        return StreamState(
            audio=self._audio_init(b),
            ring=torch.zeros(
                b, self.geometry.num_windows, self.num_frames, self._score_dims, device=dev
            ),
            centers=torch.zeros(b, self.max_speakers, self.embedding_dim, device=dev),
            center_active=torch.zeros(b, self.max_speakers, dtype=torch.bool, device=dev),
            initialized=torch.zeros(b, dtype=torch.bool, device=dev),
            chunk_count=torch.zeros(b, dtype=torch.int32, device=dev),
        )

    def reset_stream(self, state: StreamState, index: int) -> StreamState:
        """Reset one stream's slot to its initial value."""
        mask = np.zeros((state.initialized.shape[0],), bool)
        mask[index] = True
        return self.reset_streams(state, mask)

    def reset_streams(self, state: StreamState, mask) -> StreamState:
        """Reset every stream slot where ``mask`` (B,) is True to its initial
        value. The audio state takes :meth:`_audio_init`'s row, not zero: an
        empty slot of the mel frame ring holds the zero-signal constant."""
        if self._shards:
            mask = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask, bool)
            return self._per_shard(lambda shard, st, lo, hi: shard.reset_streams(st, mask[lo:hi]), state)
        mask = to_device(mask, self.device, torch.bool)
        if self._audio_row is None:
            init = self._audio_init(1)
            self._audio_row = (
                {k: v[0] for k, v in init.items()} if isinstance(init, dict) else init[0]
            )

        def reset(cur, init=None):
            m = mask.view((-1,) + (1,) * (cur.dim() - 1))
            if init is None:
                init = torch.zeros((), dtype=cur.dtype, device=cur.device)
            return torch.where(m, init.to(cur.dtype), cur)

        audio, row = state.audio, self._audio_row
        if isinstance(audio, dict):
            audio = {k: reset(v, row[k]) for k, v in audio.items()}
        else:
            audio = reset(audio, row)
        return StreamState(audio, *(reset(t) for t in state[1:]))

    # ------------------------------------------------------------------ #
    def _masks(self, b: int, audio_mask, run_mask):
        if audio_mask is None or run_mask is None:
            true_mask = self._true_masks.get(b)
            if true_mask is None:
                true_mask = torch.ones(b, dtype=torch.bool, device=self.device)
                self._true_masks[b] = true_mask
        audio_mask = true_mask if audio_mask is None else to_device(audio_mask, self.device, torch.bool)
        run_mask = true_mask if run_mask is None else to_device(run_mask, self.device, torch.bool)
        return audio_mask, run_mask

    def _fring_advance(self, st: dict, blocks: torch.Tensor, audio_mask):
        """Advance the mel frame ring by one hop and assemble the window's
        raw log-mel frames. st: the audio state dict; blocks: (B, step) f32.
        Returns ({"ring", "head", "tail"}, raw (B, frames, mels)). Static
        slices and concats with a per-stream masked select: a paused
        stream's ring, head and tail freeze wholesale."""
        spec = self._fring

        def keep(new, old):
            return torch.where(audio_mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)

        y = fbank_block_raw(spec, st["tail"], blocks)  # (B, fpb, mels)
        ring = keep(torch.cat([st["ring"][:, spec.fpb :], y], dim=1), st["ring"])
        head = st["head"]
        if spec.edge:
            head = keep(torch.cat([head[:, 1:], blocks[:, None, : spec.head_len]], dim=1), head)
        tail = keep(blocks[:, -st["tail"].shape[1] :], st["tail"])
        interior = ring[:, spec.trim : spec.trim + spec.interior]
        if spec.edge:
            left = fbank_edge_left(spec, head[:, 0, : spec.head_len])
            right = fbank_edge_right(spec, tail)
            raw = torch.cat([left, interior, right], dim=1)
        else:
            raw = interior
        return {"ring": ring, "head": head, "tail": tail}, raw

    def _advance_audio(self, audio_state, blocks: torch.Tensor, audio_mask):
        """Ingest one hop's blocks (B, step_samples) into the audio state of
        the streams in ``audio_mask``; int16 PCM is dequantized here.
        Returns ``(new_audio_state, window, emb_raw)``: the waveform window
        the models consume and, with the frame ring, the embedding's
        assembled raw log-mel frames (else None)."""
        if not blocks.is_floating_point():
            blocks = blocks.float() / 32768.0
        blocks = blocks.float()
        window = audio_state["window"] if self._fring is not None else audio_state
        rolled = torch.cat([window[:, self.step_samples :], blocks], dim=1)
        window = torch.where(audio_mask[:, None], rolled, window)
        if self._fring is None:
            return window, window, None
        fst, emb_raw = self._fring_advance(audio_state, blocks, audio_mask)
        return dict(fst, window=window), window, emb_raw

    def _segment(self, window: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """(B, samples) -> (segmentation (B, F, K), the embedding's keyword
        arguments: the stacked frontend's pooled half where it runs)."""
        wave = window[:, None, :]
        if self._stacked is None:
            return self._seg(wave), {}
        seg_pooled, emb_pooled = self._stacked_frontend(wave)
        return self._seg(wave, sinc_pooled=seg_pooled), {"sinc_pooled": emb_pooled}

    def _embed(
        self, window: torch.Tensor, seg: torch.Tensor, gamma, beta,
        emb_raw: Optional[torch.Tensor], emb_kw: dict, marks=tracing.NO_MARKS,
    ) -> torch.Tensor:
        """A window's L2-normalized embeddings (B, K, E), weighted by its
        segmentation's overlapped-speech penalty. ``emb_raw``: the frame
        ring's raw log-mel frames, which the trunk then takes instead of the
        waveform. ``marks`` (the step's device events) times the trunk's
        return."""
        weights = overlapped_speech_penalty(seg, gamma, beta)
        if self.normalize_weights:
            weights = min_max_normalize(weights, dim=-2)
        if emb_raw is not None:
            frames = self._emb.trunk_from_raw_fbank(emb_raw)
        else:
            frames = self._emb.trunk(window[:, None, :], **emb_kw)
        marks.mark_trunk()
        emb = self._emb.head(frames, weights.transpose(1, 2))
        return normalize_embeddings(emb, 1.0)

    def _stacked_frontend(self, wave: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both models' ``|sinc conv|`` max-pooled, from one convolution of
        the stacked filterbanks on the standardized waveform: wave (B, 1,
        samples) -> (segmentation's, embedding's), each (B, 80, pooled
        frames)."""
        seg, emb = self._stacked
        mean = wave.mean(dim=-1, keepdim=True)
        var = wave.var(dim=-1, keepdim=True, correction=0)
        z = (wave - mean) * torch.rsqrt(var + 1e-5)
        params = [m.get_parameter(n) for m in (seg, emb)
                  for n in ("sinc.low_hz", "sinc.band_hz", "wav_norm_scale", "wav_norm_bias")]

        def bank():  # the two filterbanks stacked, each with its waveform norm folded in
            fs, fe = seg.sinc.filters(), emb.sinc.filters()
            return (torch.cat([fs * seg.wav_norm_scale, fe * emb.wav_norm_scale]),
                    torch.cat([seg.wav_norm_bias * fs.sum(dim=1), emb.wav_norm_bias * fe.sum(dim=1)]))

        ops = held_operands(self, "stacked_frontend", params, lambda: prepare_sinc_operands(*bank(), banks=2))
        filters, bias = bank() if ops is None else (None, None)
        pooled = sinc_frontend(z, filters, seg.sinc.stride, bias, banks=2, operands=ops)
        half = pooled.shape[1] // 2
        return pooled[:, :half], pooled[:, half:]

    def _step_impl(
        self, state: StreamState, blocks, audio_mask, run_mask
    ) -> Tuple[StreamState, StepOutput]:
        """blocks, audio_mask, run_mask: as :meth:`step` takes them.
        audio_mask: streams that received a new block (ring advances);
        run_mask: streams whose window is full (chunk is processed). During
        the first duration/step - 1 hops a stream warms up with
        audio_mask=True, run_mask=False.

        Inside a recorded hop (``tracing``) the step's three phases are
        spans, ``step.segmentation``, ``step.embedding`` and
        ``step.clustering``, and on a card four events bound them on the
        device."""
        tau, rho, delta, gamma, beta = self._hparams
        marks = tracing.device_marks(self.device, self._shard)
        marks.mark()
        with tracing.span("step.segmentation", shard=self._shard):
            blocks = to_device(blocks, self.device)
            audio_mask, run_mask = self._masks(blocks.shape[0], audio_mask, run_mask)
            audio, window, emb_raw = self._advance_audio(state.audio, blocks, audio_mask)
            seg, emb_kw = self._segment(window)
            marks.mark()
        if not self.is_vad:
            with tracing.span("step.embedding", shard=self._shard):
                emb = self._embed(window, seg, gamma, beta, emb_raw, emb_kw, marks)
        marks.mark()

        def keep(new, old):
            return torch.where(run_mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)

        with tracing.span("step.clustering", shard=self._shard):
            if self.is_vad:
                permuted = seg.amax(dim=-1, keepdim=True)
                new_centers, new_active, new_init = (
                    state.centers, state.center_active, state.initialized
                )
            else:
                cstate = ClusteringState(state.centers, state.center_active, state.initialized)
                new_cstate, permuted, _ = cluster_step(
                    cstate, seg, emb, ClusteringParams(tau, rho, delta)
                )
                new_centers = keep(new_cstate.centers, state.centers)
                new_active = keep(new_cstate.active, state.center_active)
                new_init = keep(new_cstate.initialized, state.initialized)

            ring = torch.cat([permuted[:, None].to(state.ring.dtype), state.ring[:, :-1]], dim=1)
            count = state.chunk_count + run_mask.to(state.chunk_count.dtype)
            agg = aggregate(self.geometry, ring, count, self._plan)
            new_state = StreamState(
                audio=audio,
                ring=keep(ring, state.ring),
                centers=new_centers,
                center_active=new_active,
                initialized=new_init,
                chunk_count=count,
            )
            marks.mark()
        return new_state, StepOutput(aggregated=agg, newest=permuted, chunk_index=count - 1)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(
        self,
        state: StreamState,
        blocks,
        audio_mask=None,
        run_mask=None,
    ) -> Tuple[StreamState, StepOutput]:
        """Advance all streams by one hop.

        blocks: (B, step_samples) — float32 in [-1, 1] or int16 PCM, as a
            numpy array or a tensor (a tensor already on the device is used
            as it is).
        audio_mask: (B,) bool — streams that received a new block.
        run_mask: (B,) bool — streams whose window is full and should be
            processed (False while warming up or idle).
        """
        if self._shards:
            states, outs = zip(*self._per_shard(lambda shard, st, lo, hi: shard.step(
                st, _rows(blocks, lo, hi), _rows(audio_mask, lo, hi), _rows(run_mask, lo, hi)
            ), state, join=False))
            return _join(list(states)), _join(list(outs))
        with precision_policy.use(self.precision):
            return self._step_impl(state, blocks, audio_mask, run_mask)

    def _per_shard(self, fn: Callable, state: StreamState, join: bool = True):
        """``fn(shard, its state, lo, hi)`` for every local shard, in order;
        the results joined into :class:`Sharded` leaves unless ``join`` is
        False."""
        out = [
            fn(shard, _map(state, lambda leaf, k=k: leaf[k]), lo, hi)
            for k, (shard, (lo, hi)) in enumerate(zip(self._shards, self.shard_bounds))
        ]
        return _join(out) if join else out

    def place_state(self, state: StreamState) -> StreamState:
        """A state of this engine's streams with plain tensors (a restored
        checkpoint, on any device) laid out the way the engine holds it: on
        its device, or cut into its shards on theirs."""
        if not self._shards:
            return _map(state, lambda t: t.to(self.device))
        return _join([
            _map(state, lambda t, lo=lo, hi=hi, d=shard.device: t[lo:hi].to(d))
            for shard, (lo, hi) in zip(self._shards, self.shard_bounds)
        ])

    # ------------------------------------------------------------------ #
    # Output timestamps (host side)
    # ------------------------------------------------------------------ #
    @property
    def output_resolution(self) -> float:
        return self.geometry.out_resolution

    def output_start(self, chunk_index: int) -> float:
        """Start time of the aggregated region of chunk ``chunk_index``
        (the end of the chunk less the latency)."""
        return chunk_index * self.step_duration + self.duration - self.latency

    @torch.no_grad()
    def probe_frame_scores(
        self, state: StreamState, blocks, audio_mask=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (segmentation (B, F, K), embeddings (B, K, E)) the next step
        WOULD compute after ingesting ``blocks``, without changing
        ``state``; embeddings are L2-normalized, as the step uses them."""
        if self._shards:
            return tuple(_join(list(p)) for p in zip(*self._per_shard(
                lambda shard, st, lo, hi: shard.probe_frame_scores(
                    st, _rows(blocks, lo, hi), _rows(audio_mask, lo, hi)),
                state, join=False)))
        blocks = to_device(blocks, self.device)
        audio_mask, _ = self._masks(blocks.shape[0], audio_mask, None)
        with precision_policy.use(self.precision):
            _, _, _, gamma, beta = self._hparams
            _, window, emb_raw = self._advance_audio(state.audio, blocks, audio_mask)
            seg, emb_kw = self._segment(window)
            if self.is_vad:
                return seg, torch.zeros(seg.shape[0], 1, 1, dtype=seg.dtype, device=seg.device)
            return seg, self._embed(window, seg, gamma, beta, emb_raw, emb_kw)
