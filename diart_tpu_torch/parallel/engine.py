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

Differences from the JAX engine: no mesh (one device), no phase-major
audio ring (a TPU layout trick — the window is the plain (B, samples)
array it describes), no stacked SincNet frontend.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import precision as precision_policy
from ..models.base import EmbeddingModel, SegmentationModel
from ..models.fbank import (
    FbankRingSpec,
    fbank_block_raw,
    fbank_edge_left,
    fbank_edge_right,
    fbank_ring_fill,
    fbank_ring_spec,
)
from ..ops.aggregation import AggregationGeometry, aggregate, build_geometry
from ..ops.clustering import ClusteringParams, ClusteringState, cluster_step
from ..ops.functional import (
    min_max_normalize,
    normalize_embeddings,
    overlapped_speech_penalty,
)

__all__ = ["MultiStreamEngine", "StepOutput", "StreamState", "to_device"]


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


class MultiStreamEngine:
    """Drives B concurrent streams through one batched step.

    segmentation / embedding: registry models on one device (the engine
    runs where they live). ``embedding=None`` is VAD mode: segmentation +
    aggregation, no clustering. The remaining arguments mirror the JAX
    engine's.
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

    def _frame_scores(
        self, window: torch.Tensor, gamma, beta, emb_raw: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, samples) -> (segmentation (B, F, K), embeddings (B, K, E)).
        ``emb_raw``: the frame ring's raw log-mel frames, which the
        embedding then takes instead of the waveform."""
        wave = window[:, None, :]
        seg = self._seg(wave)
        if self.is_vad:
            return seg, torch.zeros(seg.shape[0], 1, 1, dtype=seg.dtype, device=seg.device)
        weights = overlapped_speech_penalty(seg, gamma, beta)
        if self.normalize_weights:
            weights = min_max_normalize(weights, dim=-2)
        if emb_raw is not None:
            frames = self._emb.trunk_from_raw_fbank(emb_raw)
        else:
            frames = self._emb.trunk(wave)
        emb = self._emb.head(frames, weights.transpose(1, 2))
        return seg, normalize_embeddings(emb, 1.0)

    def _step_impl(
        self, state: StreamState, blocks: torch.Tensor, audio_mask, run_mask
    ) -> Tuple[StreamState, StepOutput]:
        """audio_mask: streams that received a new block (ring advances);
        run_mask: streams whose window is full (chunk is processed). During
        the first duration/step - 1 hops a stream warms up with
        audio_mask=True, run_mask=False."""
        tau, rho, delta, gamma, beta = self._hparams
        audio, window, emb_raw = self._advance_audio(state.audio, blocks, audio_mask)
        seg, emb = self._frame_scores(window, gamma, beta, emb_raw)

        def keep(new, old):
            return torch.where(run_mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)

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
        blocks = to_device(blocks, self.device)
        audio_mask, run_mask = self._masks(blocks.shape[0], audio_mask, run_mask)
        with precision_policy.use(self.precision):
            return self._step_impl(state, blocks, audio_mask, run_mask)

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
        blocks = to_device(blocks, self.device)
        audio_mask, _ = self._masks(blocks.shape[0], audio_mask, None)
        with precision_policy.use(self.precision):
            _, _, _, gamma, beta = self._hparams
            _, window, emb_raw = self._advance_audio(state.audio, blocks, audio_mask)
            return self._frame_scores(window, gamma, beta, emb_raw)
