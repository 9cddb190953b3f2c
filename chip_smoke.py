#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

Run from the repository root with no arguments (``python3 chip_smoke.py``);
``--out DIR`` also writes the detailed results and a profile there.

Phases (any failure exits non-zero):

1. Build the hand-written kernels (``diart_tpu_torch/csrc/*.cu``, one
   ``nvcc`` each, in parallel) and print the card's name and power limit.
   Then, with torch's TF32 switches as a process gets them (no
   ``NVIDIA_TF32_OVERRIDE``; the script turns both off for every later
   phase): the f32 x-vector engine against the CPU (phase 3's f32 probe
   and its tolerances), the same probe on the card bitwise the one with
   both switches off, the stream CLI in a subprocess with the text of its
   run with TF32 off, and the sinc filterbank's time in true f32 and in
   TF32 (``drive_tf32_default``).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths with 64 streams: the LSTM sweep at T=293,
   H=128 (f32 and bf16 streams, raw and packed ``w_hh``, bitwise over two
   calls), with other batch sizes (1 to 600, one step) and hidden sizes on
   each of its three routes; in f32 the split route's plan (W in
   registers over a cluster of 2), ``-Xptxas -v`` of its instantiations
   (no spill, no stack frame), its device time, the clusters the card
   holds, and the FMA route (built under another name in ``build/smoke/``)
   against it in A B B A turns at B = 64 and 32; the stats head
   at X (64, 279, 512) (bf16 and f32), W (512, 1500), 4 speakers; the
   attention statistics at x (64, 501, 1536), hidden (64, 501, 128), 4
   speakers (bf16 and f32), both with prepared and raw operands, with
   streams run alone against their rows of the whole batch (bitwise),
   beside the cuBLAS product alone, and over a sweep of batch, length,
   width and speaker count (bitwise equal over repeated calls); the
   SE-Res2Block at (64, 501, 512), scale 8,
   dilations 2, 3, 4 (bf16 and f32), with every stage of its stage mode,
   other batch sizes, and other lengths and time tiles of its cascade
   (the result must not depend on the tile), bitwise over two calls, the
   kernels it launched those its plan names; SincNet's first stage
   (``sinc_frontend``) at 5 s windows, B = 64 and 256, one bank and the
   stacked pair, with ``bf16_frontend`` on and off, beside cuDNN's
   true-f32 convolution plus ``frontend_pool`` and the bounds, and over
   other batches and lengths; ResNet34's trunk convolutions
   (``resnet_conv``, bf16) at every distinct geometry of the trunk at
   B = 256 against the plain version (within the summation order's room,
   at most 0.1% of the outputs differing at all), timed beside cuDNN's
   convolution alone and the least, then the whole trunk against the
   composition it replaced, A B B A. Print each error beside its
   tolerance, the kernel / plain / library times (CUDA events) and bounds,
   the LSTM sweep at B=256 and the SE-Res2Block at B=8, and the device
   time of each of the block's launches by name. In f32 the SE-Res2Block
   and the stats head run on the TF32 tensor cores (3xTF32): ptxas' report
   of those kernels (no spill, no stack frame) and their SASS (TF32 HGMMA,
   the cascade's TF32 HMMA), both bounds (3xTF32, and the same work as
   f32 FMAs), the product alone in true f32, and the FMA routes (built
   under other names in ``build/smoke/``, held to the plain versions)
   against them in A B B A turns: the block at B = 64 and 8, the stats
   head at the x-vector's and XVector-SB's X; then the f32 policy's steps
   (``Precision.portable()``, f32 models) with each route, A B B A: the
   x-vector and ECAPA engines at B=64 (wall, device busy) and trainers at
   B=32 (step wall, device busy).
3. Drive each full-width engine for 64 streams over 14 hops of int16
   audio (warm-up, running hops, one paused stream, one slot reset):
   ``tpu/pyannet`` 4x128 + ``tpu/xvector`` 512/1500, then ``tpu/pyannet``
   + ``tpu/ecapa`` 512/1536/192 with its mel frame ring; bf16 embedding
   trunks, 20 global speakers, 5 s windows, 0.5 s hops. Check shapes,
   finiteness and that each kernel of the path ran on every hop (launch
   counters set to 0 just before and read just after). Compare each with
   the same engine on the CPU for 2 streams (``probe_frame_scores`` and
   12 f32 hops with clustering), and time and profile the step.
4. The serving path of each engine at B=64 (``tau_active`` 0.45): the
   step with numpy int16 blocks and numpy masks under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync allowed) and
   its dispatch time, wall and idle share; five sessions on one engine over
   24 hops with warm-up, a paused stream and a slot reset, every
   ``push_begin`` under the sync check: the card's packed bits equal the
   host's ``np.packbits`` of the same hop's scores byte for byte, and the
   native bits route, the scores route, the numpy routes called by name
   and the annotation route give identical RTTM text at every hop; two
   hops in flight with a reset between a dispatch and its harvest give the
   synchronous text; a checkpoint saved halfway and restored into a fresh
   session gives the uninterrupted text; each kernel of the path ran on
   every step (counts set to 0 before the hops). Print the per-hop
   dispatch / harvest split, the host ms of native and numpy RTTM assembly
   and the device-to-host bytes of both fetch routes. Then
   ``CohortScheduler`` with 4 cohorts of 64 streams, pipelined, 4 periods
   of real time: every hop harvested with text for every stream; dispatch
   lateness, reply latency and late hops are printed as a record.
5. The pipelines (``diart_tpu_torch.blocks``) at full width on one stream
   of 51 chunks (~30 s): ``SpeakerDiarization`` with ``tpu/xvector`` and
   with ``tpu/ecapa`` (its direct fbank path), and
   ``VoiceActivityDetection``, at the JAX package's defaults but the
   session phase's thresholds (tau 0.45, rho 0.05), in calls of 1
   chunk and then, after ``reset()``, in calls of 8: every dispatch under
   the sync check, each kernel of the path launched the expected number of
   times in every call, finite outputs, the same RTTM text from both call
   sizes; ms per chunk, device busy, idle share and launches per call.
   Each pipeline in f32 on the card against the same pipeline on the CPU
   over 6 chunks (scores, embeddings, active centres; the text a record).
   Then sessions
   fed CUDA tensor blocks with ``collect_audio`` and ``quantize_transfer``
   against the same sessions fed the numpy blocks.
6. The runtime and the console entry points (``diart_tpu_torch.runtime``,
   ``.console``) with the stream CLI's models (``from_pretrained``: f32,
   seeds from the names) at tau 0.45 / rho 0.05: ``python -m
   diart_tpu_torch.console.stream`` on a 20 s WAV in a subprocess (exit 0,
   a well-formed RTTM, the text of step 2's run at calls of 1);
   ``StreamingInference`` over ``FileAudioSource`` for x-vector, ECAPA and
   VAD in calls of 1 and 8 (every dispatch under the sync check, each
   call's launches, the same text from both call sizes and from the
   pipelines phase's direct loop over the same chunks and shift; ms a
   chunk from the ``Chronometer``, the bare wall and the direct loop);
   ``Benchmark(multi_stream=True)`` over 8 files of 10–30 s without a
   reference (no pandas): every file's RTTM, each kernel on every hop, the
   cached engine reused with ``set_hyperparameters`` under the sync check,
   audio seconds a wall second, each file's DER against the sequential
   ``Benchmark`` (a record); ``Parallelize`` with 2 spawn workers over 2
   files (the sequential text); ``StreamingServer`` at B=64 over 24 hops of
   stub clients in every slot, driven by ``_tick``: one cohort on the
   float32 wire, then two pipelined cohorts with ``quantize_transfer`` on
   the int16 and float32 wires, every dispatch on the server's thread under
   the sync check, each client's text equal to a session pushed the same
   blocks from the main thread; dispatch and harvest ms a hop.
7. The model layer (``drive_families``): seeded replicas of NeMo
   TitaNet-large (1024 channels), speechbrain's fbank x-vector, wespeaker's
   ResNet34 (base 32) and a powerset PyanNet (3 speakers, at most 2 at
   once, 4x128; its empty-set class suppressed) from
   ``tests/torch_replicas.py``, saved as torch checkpoints, converted by
   the port and written as native files; the attention statistics at
   TitaNet's head (x (64, 501, 3072)) and the stats head at XVector-SB's
   (X (64, 501, 512)) against their plain versions (bf16 and f32); each
   family's engine from its native file (bf16 embedding trunks; a mel
   family beside ``tpu/pyannet``, the powerset model beside
   ``tpu/xvector``) at B=64 over 16 hops with every step under the sync
   check and each kernel's launches a step held to the family's
   (TitaNet: 1 attention statistics, XVector-SB and the x-vector: 1 stats
   head, ResNet34: neither; the sweeps of the 4-layer PyanNet), its step
   wall, device busy, idle share and device launches; the same engine for
   2 streams against the CPU in f32 (the powerset decode where the margin
   allows); ``python -m diart_tpu_torch.console.convert`` in a subprocess
   (its file equal to the in-process conversion) and the stream CLI with
   ``--powerset 3 2`` (its text equal to the in-process run).
8. Training and tuning (``drive_training``): each kernel's
   ``autograd.Function`` (the kernel forward; the LSTM sweep's backward
   kernel, the others' autograd through their plain versions) against
   autograd through the plain version at the main paths' shapes with
   B=64, bf16 and f32: every input's gradient for a seeded cotangent, the
   forward's, the backward's and the plain backward's times. The sweep's
   backward (``lstm_sweep_backward``: two batched products around the
   kernel ``csrc/lstm_sweep_bwd.cu``) against its plain version on the card
   at (293, 64, 128) and the trainer's B=32, bf16 and f32, and at other
   sizes (one step, 600 streams, H = 20, 64, 256), each with its launch
   plan (route, cluster, where W lives): the kernel's ms (CUDA events) and
   device ms, the whole backward's ms and device launches, the plain
   backward's, autograd through the plain forward (the backward it
   replaces), cuDNN's LSTM backward (a yardstick), the bound and an argued
   latency floor (``LSTM_BWD_STEP_FLOOR_CYCLES``); ``-Xptxas -v``'s
   registers, shared memory and spill bytes of every instantiation (none
   may spill on the split route); phase A alone (the kernel's template
   that stops there) for the phase split; the column kernel (the route
   that takes the other widths, built under another name in the
   script's own scratch build, ``build/smoke/``) against the split route
   in A B B A turns: both kernels' ms at B=64 and 32, the whole backward
   with each at B=64, and the segmentation training step at B=32 with
   each (``seg_step_abba``); the same step with the FMA route and with the
   split route as the sweep's f32 forward (A B B A, each turn's forward /
   backward / update split). Then the trainers at
   full width on B=32 chunks of 5 s for 6 AdamW steps, with the sweep's
   plain forward and backward refused on CUDA tensors
   (``plain_sweep_refused``: no autograd through the plain step loop):
   ``tpu/pyannet`` with PIT-BCE (f32, lr 1e-3, random
   targets), ``tpu/xvector`` and ``tpu/ecapa`` with AAM-softmax (bf16
   trunks, lr 1e-5, 8 tone-plus-noise speakers): finite losses, the last
   below the first, every parameter's gradient finite and nonzero (SincNet
   and every LSTM layer's ``w_ih`` / ``w_hh``, every SE-Res2Block
   parameter), each kernel's launches a step (segmentation: 4 sweeps and
   4 backward kernels); the forward / backward /
   update split, device busy and idle share of a step; the trained model's
   engine equal to a fresh one loaded with its weights; one f32 step of
   each trainer on 2 samples against the CPU; 3 steps, a checkpoint and 3
   more bitwise equal to 6 straight; ``python -m
   diart_tpu_torch.console.tune --multi-stream`` in a subprocess over 4
   synthesized files with reference RTTMs (3 trials in the study) and an
   in-process ``Optimizer(multi_stream=True)``: one cached engine for every
   trial, every ``set_hyperparameters`` under the sync check, each trial's
   value 100 x |DER| of its RTTM files; ms a trial.
9. Scale-out and int8 (``drive_scaleout_int8``): ``int8_conv`` at every
   quantizable site (``check_int8``; in a whole run with phase 2's kernel
   checks) of the five embedding families at full width, B=64,
   bf16, on the inputs one forward hands each site (one check a distinct
   geometry): ``quantize_rows`` and the int32 sums bitwise against the
   plain version on the card, the dequantized output too; its ms beside
   its bound, the plain version's, cuDNN's bf16 convolution of the shape
   and ``torch._int_mm`` over the unfolded input where the shape allows,
   the device time of its three launches apart (``absmax_rows``,
   ``quantize_rows`` beside its byte bound, ``int8_conv_wgmma``) and the
   launch plan, and one geometry no family has (stride 2, padding 1,
   dilation 3, 7 output columns: the kernel's general epilogue); the built
   library's SASS (``cuobjdump``): every convolution kernel holds
   ``IGMMA`` and none ``IMMA``;
   each family's engine (``tpu/pyannet`` beside the seeded registry model)
   at B=64 with ``Precision(int8_trunk=True)``: 12 hops under the sync
   check with every kernel's launches a step held (``int8_conv``: the
   family's sites on the card's route), utterance embeddings against the
   switch off (cosine >= 0.999), the same engine for 2 streams in f32
   against the CPU (the CPU's sites handed the card's inputs), step wall,
   device busy and idle share with the switch on and off (a record); the
   x-vector and ECAPA engines at B=64 cut into 2 shards of one card
   (``streams_mesh(devices=["cuda:0"] * 2)``) against the unsharded ones
   (every sharded step under the sync check, each kernel on every shard,
   scores within 1e-5, the same session text; the gap to the 64-stream
   engine hop by hop, segmentation and embeddings apart, a record) and
   the server of
   ``serve --mesh 2`` driven by ``_tick`` with stub clients (the unsharded
   session's text); two processes in a gloo group with CUDA tensors (each
   owning half the streams: their rows equal one process's engine; one
   data-parallel AAM step of 32 as 2 x 16: every gradient within 1e-5 of
   one process's) and a one-process NCCL group that all-reduces once
   (NCCL cannot put two ranks on one GPU).
10. What diart_tpu writes, and the stacked SincNet frontend
   (``drive_jax_files``): the six committed model files of
   ``tests/golden/jax_files/`` (flax msgpack, read by ``from_pretrained``)
   on the card in f32 against diart_tpu's stored outputs, each with the
   kernels it launches (PyanNet: the LSTM sweep; the x-vector and
   XVector-SB: the stats head; ECAPA: attention statistics and the
   SE-Res2Block; TitaNet: attention statistics); diart_tpu's session file
   restored onto the engine of two of them and 4 more hops against its
   stored scores and RTTM text; its trainer directory restored and 2 more
   AdamW steps against its stored parameters; the registry PyanNet (4 x
   128) and x-vector (512 x 4 / 1500) written in diart_tpu's format
   (``flaxio.dumps``) and read back, their B=64 engine over 12 hops bitwise
   the engine of the modules; then ``stack_frontend``: one 160-channel sinc
   convolution against two 80-channel ones at (64, 1, 80000) in true f32,
   the x-vector engine with distinct filterbanks with the switch off and
   on (wall, device busy, idle share; (off on on off) x 2) and the stacked
   engine against the unstacked one in f32.
11. The rest of diart_tpu's surface (``drive_surface``): ``tpu/pyannet``
   and ``tpu/xvector`` (bf16 trunk) through ``from_pretrained`` are not in
   memory and place nothing on the card before first use; their B=64
   engine over 12 hops bitwise the engine of models loaded beforehand,
   with its sweeps' and stats head's launches; ``with_dtype("f32")`` after
   the load gives the f32 engine's probe bitwise. Then the ``DIART_TPU_*``
   variables, each case in a child process with the default policy
   (started together): ``DIART_TPU_INT8_TRUNK=1`` (x-vector),
   ``DIART_TPU_FBANK_RING=0`` (ECAPA), ``DIART_TPU_BF16_LSTM=0`` and
   ``DIART_TPU_PALLAS_LSTM=0`` (x-vector), each bitwise the engine of the
   matching ``Precision`` run here with no variable, every kernel of the
   path launched on every hop (``int8_conv`` too; the JAX-only variable
   keeps nothing from launching), and ``use(Precision(), force=True)``
   giving the default forward under ``DIART_TPU_BF16_LSTM=0``. Then
   ``log_mel_filterbank`` at (64, 80000) f32 on the card against the CPU
   under torch's TF32 switches as the process got them (tolerance 1e-4),
   timed with CUDA events beside ``speechbrain_log_mel``. Every phase
   before this one runs with no policy variable in the environment (the
   script removes them and prints the resolved policy first).
12. Print ``{"kernels": [...]}`` (with each kernel's launches on the
   pipelines', the runtime's, the families', the training, phase 10's and
   phase 11's runs, and its gradient's error and times; ``lstm_sweep``'s
   f32 stream (the split route) beside its bf16 one; ``int8_conv``'s at
   every site; ``lstm_sweep_bwd``'s launches a segmentation training step
   and on phase 10's training steps, its error, times and bound) and,
   last, ``{"ok": true, "device": ...}``.

``--kernels NAMES`` runs only the build and phase 2's checks of NAMES
(comma-separated of lstm, stats, attn, res2, sinc, resnet), each in bf16
and f32 (resnet in bf16);
``--f32-steps`` only the build and phase 2's f32 steps (after those
checks when both are given).
``--families`` runs only the build and phase 7; ``--training`` only the
build and phase 8; ``--scaleout`` only the build and phase 9
(``--rank-child`` is phase 9's own way to start its processes);
``--jax-files`` only the build and phase 10; ``--surface`` only the
build and phase 11 (``--env-child`` is its own way to start its
processes);
``--tf32-default [--root TREE]`` only the build and phase 1's TF32
checks (with ``TREE``'s ``diart_tpu_torch``, its subprocess too).
``--step-timing [--root TREE]`` runs only the step timing of phase 4 (its
sync check recorded, not fatal), importing ``diart_tpu_torch`` from
``TREE``: run it on two trees in the order A B B A to compare commits.
``--engine-outputs NPZ [--root TREE]`` writes only the x-vector and ECAPA
engines' outputs over phase 3's hops (B=64) with ``TREE``'s package, and
``--compare-outputs A B`` holds two such files bitwise: the serving path
of two commits, compared.

The script imports only the port and the benchmark's peaks
(``portbench.work``; never jax or diart_tpu) and exits non-zero without a
GPU.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# the card's peaks and the bounds held against them, the benchmark's own
from portbench.work import HBM_BYTES_PER_S, PEAK_FLOPS, bound_ms, tf32_bounds

# the tree whose diart_tpu_torch the subprocesses import (``--root``)
PKG_ROOT = os.path.dirname(os.path.abspath(__file__))
T_LSTM, B, H = 293, 64, 128
T_EMB, C_IN, C_OUT, S = 279, 512, 1500, 4
T_ECAPA, C_ECAPA, C_MFA, H_ATT, RES2_SCALE, SE_HIDDEN = 501, 512, 1536, 128, 8, 128
HOPS, WARMUP_HOPS = 14, 10


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except Exception as exc:  # the line is informative only
        return f"nvidia-smi unavailable ({exc})"


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi gives it (for the LSTM's
    latency floor). Raises where it cannot be read."""
    text = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    return float(text) * 1e6


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------- #
# The shortest dependent chain of one step of the tensor-core sweep that the
# instruction latencies allow, in cycles: the barrier (~30), ldmatrix of h
# (~33), one mma (~33; with every k tile in a chain of its own), the add tree
# and the gate-stream add (~16), sigmoid/tanh of the gates side by side (~50:
# two special-function calls and a few FMAs), the c update (8), tanh(c) (~50),
# the scale and the bf16 rounding (8), the shared-memory store until the
# barrier sees it (~30).
LSTM_STEP_FLOOR_CYCLES = 258
# bf16 stream: the kernel and the plain version round h to bf16 at the same
# point; a last-bit difference in an f32 gate sum flips a bf16 rounding of an
# output in [-1, 1] now and then (one ulp there is <= 2**-8) and feeds the
# later steps: two ulps. f32: summation order only.
LSTM_TOL = {"f32": 1e-4, "bf16": 2.0**-7}


# the f32 stream's A B B A, the FMA route (built in build/smoke/) against the
# split route at H = 128: the kernel checks' 64 streams and the segmentation
# trainer's 32 chunks
SWEEP_ABBA_BATCHES = (64, 32)


def check_lstm(dtype, gen):
    import torch
    from diart_tpu_torch.ops import lstm_sweep

    dev = "cuda"
    kind = "f32" if dtype == torch.float32 else "bf16"
    tol = LSTM_TOL[kind]

    def inputs(time, batch, hidden):
        proj = torch.randn(time, 2, batch, 4 * hidden, generator=gen).to(dev, dtype)
        q = torch.linalg.qr(torch.randn(2, 4 * hidden, hidden, generator=gen))[0]  # orthonormal columns
        return proj, q.to(dev)

    def held(time_, batch, hidden, p=None, w=None):
        """The kernel against the plain version (raw w_hh), and two calls bitwise."""
        if p is None:
            p, w = inputs(time_, batch, hidden)
        got = lstm_sweep.lstm_sweep_tm(p, w)
        e = (got.float() - lstm_sweep.lstm_sweep_reference(p, w).float()).abs().max().item()
        same = torch.equal(got, lstm_sweep.lstm_sweep_tm(p, w))
        plan = lstm_sweep.launch_plan(batch, hidden, dtype, dev)
        log(f"  lstm_sweep[{kind}] T={time_} B={batch} H={hidden} plan={plan}: max_abs_err={e:.3e} "
            f"(tol {tol:.1e}); bitwise over two calls: {same}")
        if not (e <= tol and same):
            raise AssertionError(f"lstm_sweep[{kind}] T={time_} B={batch} H={hidden} disagrees with its plain "
                                 f"version or with itself")
        if hidden in (64, 128) and plan["route"] != ("mma" if kind == "bf16" else "split"):
            raise AssertionError(f"lstm_sweep[{kind}] H={hidden}: route {plan['route']}")
        return dict(T=time_, B=batch, H=hidden, max_abs_err=e, route=plan["route"], rows_per_block=plan["rows_per_block"])

    proj, w_hh = inputs(T_LSTM, B, H)
    packed = lstm_sweep.pack_w_hh(w_hh, dtype)  # laid out once, as the model does
    got = lstm_sweep.lstm_sweep_tm(proj, operands=packed)
    want = lstm_sweep.lstm_sweep_reference(proj, w_hh)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, lstm_sweep.lstm_sweep_tm(proj, w_hh)):
        raise AssertionError(f"lstm_sweep[{kind}]: the raw and the packed w_hh give different results")
    if not torch.equal(got, lstm_sweep.lstm_sweep_tm(proj, operands=packed)):
        raise AssertionError(f"lstm_sweep[{kind}]: two calls differ")
    ms = time_ms(lambda: lstm_sweep.lstm_sweep_tm(proj, operands=packed), 20)
    raw_ms = time_ms(lambda: lstm_sweep.lstm_sweep_tm(proj, w_hh), 20)
    plain_ms = time_ms(lambda: lstm_sweep.lstm_sweep_reference(proj, w_hh), 3, warmup=1)
    # yardstick only: cuDNN's LSTM over the same (T, B) includes the input
    # projection (input width 2H, as layers 2-4 of PyanNet), so the time of
    # that projection alone (one product and the bias, both directions) is
    # taken off it
    lstm = torch.nn.LSTM(2 * H, H, bidirectional=True).to(dev, dtype)
    lstm.flatten_parameters()
    xin = torch.randn(T_LSTM, B, 2 * H, generator=gen).to(dev, dtype)
    w_ih = torch.randn(8 * H, 2 * H, generator=gen).to(dev, dtype)
    b_ih = torch.randn(8 * H, generator=gen).to(dev, dtype)
    with torch.no_grad():
        cudnn_ms = time_ms(lambda: lstm(xin), 20)
        proj_ms = time_ms(lambda: torch.addmm(b_ih, xin.view(-1, 2 * H), w_ih.t()), 20)
    lib_ms = cudnn_ms - proj_ms
    del lstm, xin
    elt = proj.element_size()
    nbytes = proj.numel() * elt + w_hh.numel() * 4 + got.numel() * elt
    flops = 2.0 * T_LSTM * 2 * B * 4 * H * H
    bms, by = bound_ms(nbytes, flops, kind)
    plan = lstm_sweep.launch_plan(B, H, dtype, proj.device)
    floor_ms = T_LSTM * LSTM_STEP_FLOOR_CYCLES / sm_clock_hz() * 1e3 if plan["route"] == "mma" else None
    # off B=64: 256 streams (the same plan on more blocks) and 528 (one wave of
    # 8-row blocks on the tensor-core route; several waves of 4-row clusters
    # on the split route), each held to the plain version
    p256, p528 = inputs(T_LSTM, 256, H)[0], inputs(T_LSTM, 528, H)[0]
    ms_256 = time_ms(lambda: lstm_sweep.lstm_sweep_tm(p256, operands=packed), 20)
    ms_528 = time_ms(lambda: lstm_sweep.lstm_sweep_tm(p528, operands=packed), 20)
    case_errs = [held(T_LSTM, 256, H, p256, w_hh), held(T_LSTM, 528, H, p528, w_hh)]
    del p256, p528
    log(
        f"lstm_sweep[{kind}] T={T_LSTM} B={B} H={H}: max_abs_err={err:.3e} (tol {tol:.1e}) "
        f"kernel_ms={ms:.4f} (raw w_hh, packed per call: {raw_ms:.4f}) plain_ms={plain_ms:.3f} "
        f"cudnn_lstm_ms={cudnn_ms:.4f} less its input projection {proj_ms:.4f} = {lib_ms:.4f} "
        f"bound_ms={bms:.5f} ({by}) argued latency_floor_ms={floor_ms} "
        f"({LSTM_STEP_FLOOR_CYCLES} cycles a step at the card's highest clock; not a measurement) plan={plan}; "
        f"B=256: kernel_ms={ms_256:.4f} plan={lstm_sweep.launch_plan(256, H, dtype, dev)}; "
        f"B=528: kernel_ms={ms_528:.4f} plan={lstm_sweep.launch_plan(528, H, dtype, dev)}"
    )
    if not err <= tol:
        raise AssertionError(f"lstm_sweep[{kind}] disagrees with its plain version: {err} > {tol}")
    rec = dict(max_abs_err=err, tol=tol, ms=ms, raw_w_hh_ms=raw_ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms, cudnn_lstm_ms=cudnn_ms, input_projection_ms=proj_ms,
               argued_latency_floor_ms=floor_ms, ms_b256=ms_256, ms_b528=ms_528, plan=plan)
    if kind == "f32":
        rec.update(split_route(proj, w_hh, packed, want, inputs, plan))
    # the other plans: the pipelines' calls (1 and 8 chunks at the full
    # length), batch tiles and the one-wave edge on short sequences, one step,
    # and other hidden sizes (64 takes the tensor-core route in bf16 and the
    # split route in f32; 16, 40 and 136 the FMA route)
    cases = [(T_LSTM, 1, H), (T_LSTM, 8, H), (1, 3, H), (1, 2, 64)]
    cases += [(37, batch, H) for batch in (3, 8, 100, 200, 528, 529, 600)]
    cases += [(37, 5, 64), (21, 3, 64), (37, 9, 16), (21, 3, 40), (21, 3, 136)]
    case_errs += [held(*c) for c in cases]
    return dict(rec, cases=case_errs)


def split_route(proj, w_hh, packed, want, inputs, plan):
    """The f32 stream at H = 128: W held on chip (the plan, ptxas' report of
    every split instantiation: no spill), the kernel's device time
    (profiler), the clusters the card holds, and the FMA route (built in
    build/smoke/) against the split route in A B B A turns at
    SWEEP_ABBA_BATCHES, both held to the plain version."""
    import torch
    from diart_tpu_torch.ops import lstm_sweep

    if plan["route"] != "split" or plan["w_hh_in"] != "registers" or plan["cluster"] != 2:
        raise AssertionError(f"lstm_sweep[f32] H={H}: W is not held on chip over a cluster of 2 ({plan})")
    build = check_split_build("lstm_sweep")
    rows = device_times(lambda: lstm_sweep.lstm_sweep_tm(proj, operands=packed), "lstm_sweep[f32]")
    dev_ms = next((r[1] for r in rows if r[0].startswith("lstm_sweep_split")), None)
    clusters = {b: lstm_sweep.max_clusters(b, proj.device) for b in (B, TRAIN_B, 528)}
    turns = {}
    for batch in SWEEP_ABBA_BATCHES:
        p, ref = (proj, want) if batch == B else (inputs(T_LSTM, batch, H)[0], None)
        if ref is None:
            ref = lstm_sweep.lstm_sweep_reference(p, w_hh)
        wf = lstm_sweep._pack_fma(w_hh, torch.float32)
        fma_err = (fma_launch(p, wf) - ref).abs().max().item()
        if not fma_err <= LSTM_TOL["f32"]:
            raise AssertionError(f"the FMA route [f32] B={batch} disagrees with the plain version: {fma_err}")
        a, b = abba(lambda: time_ms(lambda: fma_launch(p, wf), 20), lambda: time_ms(lambda: lstm_sweep.lstm_sweep_tm(p, operands=packed), 20))
        turns[f"B{batch}"] = dict(ms=float(np.mean(b)), ms_turns=b, ms_fma=float(np.mean(a)), ms_fma_turns=a,
                                  fma_max_abs_err=fma_err,
                                  plan=lstm_sweep.launch_plan(batch, H, torch.float32, proj.device))
        log(f"lstm_sweep[f32] B={batch} A B B A (A: the FMA route, B: the split route), ms: "
            f"{a[0]:.4f} {b[0]:.4f} {b[1]:.4f} {a[1]:.4f}; the FMA route's max_abs_err {fma_err:.3e}")
    log(f"lstm_sweep[f32] split route: device ms {dev_ms} a launch ({rows}); clusters the card holds at once "
        f"{clusters} (B=64 launches {plan['blocks'] // plan['cluster']})")
    return dict(device_ms=dev_ms, device_rows=[list(r) for r in rows], max_clusters=clusters, abba=turns,
                build=build)


def fma_launch(proj, wp):
    """The FMA route (built in build/smoke/) on f32 CUDA tensors, ``wp`` in
    its layout (``lstm_sweep._pack_fma``). Not counted: a comparison, not
    the path."""
    import torch
    from diart_tpu_torch.ops import _build

    time_, _, batch, gates4 = proj.shape
    out = torch.empty(time_, 2, batch, gates4 // 4, dtype=torch.float32, device=proj.device)
    err = scratch_library("lstm_sweep_fma")(
        proj.data_ptr(), wp.data_ptr(), out.data_ptr(), time_, batch, gates4 // 4, _build.num_sms(proj.device),
        _build.stream_handle(proj.device))
    if err != 0:
        raise AssertionError(f"the FMA route failed to launch: cudaError {err}")
    return out


def res2_fma_block(x, k, dilation):
    """The SE-Res2Block with every product on the FMA kernels (``tdnn_fma``,
    ``res2_cascade_fma``; built in build/smoke/) on f32 CUDA tensors, ``k``
    its ``Res2Operands``. Not counted: a comparison, not the path."""
    import torch
    from diart_tpu_torch.ops import _build, se_res2

    batch, time_, chans = x.shape
    groups, taps = k.wg.shape[:2]
    out, cat = torch.empty_like(x), torch.empty_like(x)
    part = torch.empty(batch, -(-time_ // 64), chans, device=x.device)
    gate = torch.empty(batch, chans, device=x.device)
    tile = se_res2.cascade_tile(batch, time_, x.dtype, _build.num_sms(x.device))
    err = scratch_library("se_res2_fma")(
        x.data_ptr(), out.data_ptr(), cat.data_ptr(), part.data_ptr(), gate.data_ptr(), *(t.data_ptr() for t in k),
        batch, time_, chans, groups, taps, k.ws1.shape[1], dilation, tile, 0, _build.stream_handle(x.device))
    if err != 0:
        raise AssertionError(f"the SE-Res2Block's FMA route failed to launch: cudaError {err}")
    return out


def stats_fma(x, ops, wt, slope=0.01):
    """``linear_stats_fma`` (built in build/smoke/) on f32 CUDA tensors with
    the prepared ``ops``. Not counted: a comparison, not the path."""
    import torch
    from diart_tpu_torch.ops import _build

    batch, time_, c_in = x.shape
    s1 = torch.empty(batch, wt.shape[1], ops.channels, device=x.device)
    s2 = torch.empty_like(s1)
    err = scratch_library("linear_stats_fma")(
        x.data_ptr(), ops.w.data_ptr(), ops.bias.data_ptr(), ops.scale.data_ptr(), ops.shift.data_ptr(),
        wt.data_ptr(), s1.data_ptr(), s2.data_ptr(), batch, time_, c_in, ops.channels, ops.w.shape[1],
        wt.shape[1], slope, _build.stream_handle(x.device))
    if err != 0:
        raise AssertionError(f"linear_stats_fma failed to launch: cudaError {err}")
    return s1, s2


def bitwise_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def held_to(got, want, rel, floor=0.0):
    """(max abs error, tolerance = rel x max(floor, max|want|)) over tuples."""
    err = max((g - r).abs().max().item() for g, r in zip(got, want))
    return err, rel * max(floor, max(r.abs().max().item() for r in want))


# linear_stats: both versions round W to X's dtype and multiply exactly in
# f32; only the order of the f32 sums differs — relative to the outputs' scale
STATS_TOL = 1e-5
# (B, T, C_in, C, S) held on the card beside the main shape: every batch in
# {1, 2, 3, 8, 64, 256}, length in {1, 37, 279, 600}, width in {100, 1500,
# 1536} and speaker count in {1, 4, 8}; C_in = 200 has a partial k slice,
# C_in = 60 takes the FMA route; B = 1 and 8 at 279 frames are the x-vector
# pipeline's calls
STATS_SWEEP = [
    (1, 279, 512, 1500, 4), (2, 37, 512, 1500, 1), (3, 1, 512, 1500, 8), (64, 600, 512, 1500, 4),
    (256, 279, 512, 1500, 4), (3, 279, 512, 100, 4), (2, 600, 512, 1536, 8), (1, 37, 512, 100, 1),
    (256, 1, 512, 1536, 8), (3, 279, 200, 1500, 4), (2, 37, 60, 100, 4), (8, 279, 512, 1500, 4),
]


# streams run alone against their rows of the B=64 call: one stream (one a
# block there, six a block at B=64) and the last four (the last, partial
# block at B=64)
PART_STREAMS = ((37, 38), (60, 64))


def stats_inputs(batch, time_, c_in, channels, speakers, dtype, gen):
    import torch

    dev = gen.device
    n = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    x = n(batch, time_, c_in).to(dtype)
    w = n(c_in, channels) * c_in**-0.5
    return (x, w, n(channels) * 0.1, 1.0 + 0.1 * n(channels), 0.1 * n(channels),
            torch.sigmoid(n(batch, speakers, time_)))


def check_stats(dtype, gen, shape=(B, T_EMB, C_IN, C_OUT, S), sweep=True, tag=""):
    """The stats head at X (64, 279, 512), W (512, 1500), 4 speakers (or
    ``shape`` = (B, T, C_in, C, S)), with prepared (the model's call) and
    raw operands; streams run alone (one a block) give the bits of their
    rows in the whole batch (six a block); then, with ``sweep``, the shape
    sweep, each case held to the same tolerance and bitwise equal over
    repeated calls."""
    import torch
    from diart_tpu_torch.ops import linear_stats as ls

    from diart_tpu_torch.ops import _numerics

    kind = "f32" if dtype == torch.float32 else "bf16"
    B, T_EMB, C_IN, C_OUT, S = shape
    x, w, b, scale, shift, wt = stats_inputs(B, T_EMB, C_IN, C_OUT, S, dtype, gen)
    ops = ls.prepare_stats_operands(w, b, scale, shift, dtype)  # once, as the model does
    want = ls.linear_stats_reference(x, w, b, scale, shift, wt)
    got = ls.fused_linear_stats(x, weights=wt, operands=ops)
    torch.cuda.synchronize()
    err, tol = held_to(got, want, STATS_TOL)
    if not bitwise_equal(got, ls.fused_linear_stats(x, w, b, scale, shift, wt)):
        raise AssertionError(f"linear_stats[{kind}]: raw and prepared operands give different results")
    plan = ls._plan(x, ops, S)
    for lo, hi in PART_STREAMS:
        part = ls.fused_linear_stats(x[lo:hi], weights=wt[lo:hi], operands=ops)
        if not bitwise_equal([g[lo:hi] for g in got], part):
            raise AssertionError(f"linear_stats[{kind}]: streams {lo}..{hi - 1} alone "
                                 f"({ls._plan(x[lo:hi], ops, S)}) differ from their rows at B={B}")
    ms = time_ms(lambda: ls.fused_linear_stats(x, weights=wt, operands=ops), 20)
    device_ms = device_times(lambda: ls.fused_linear_stats(x, weights=wt, operands=ops), "linear_stats")[0][1]
    raw_ms = time_ms(lambda: ls.fused_linear_stats(x, w, b, scale, shift, wt), 20)
    plain_ms = time_ms(lambda: ls.linear_stats_reference(x, w, b, scale, shift, wt), 20)
    wl = w.to(dtype)
    with _numerics.true_f32(x.device):  # yardstick: the product alone (f32: true f32)
        product_ms = time_ms(lambda: torch.matmul(x, wl), 20)
    nbytes = x.numel() * x.element_size() + sum(t.numel() * 4 for t in (w, b, scale, shift, wt))
    nbytes += 2 * B * S * C_OUT * 4
    gemm = 2.0 * B * T_EMB * C_IN * C_OUT
    flops = gemm + 6.0 * B * T_EMB * C_OUT + 4.0 * B * S * T_EMB * C_OUT
    bms, by = bound_ms(nbytes, flops, kind)
    if plan["route"] != ("wgmma" if kind == "bf16" else "wgmma_tf32"):
        raise AssertionError(f"linear_stats[{kind}{tag}] takes the {plan['route']} route")
    if kind == "f32":  # three TF32 products beside the epilogue's f32 work; the same work as f32 FMAs
        (bms, by), (fma_bms, fma_by) = tf32_bounds(nbytes, gemm, flops - gemm)
    log(
        f"linear_stats[{kind}{tag}] X=({B},{T_EMB},{C_IN}) W=({C_IN},{C_OUT}) S={S}: "
        f"max_abs_err={err:.3e} (tol {tol:.3e} = {STATS_TOL:g} x max|ref|) "
        f"kernel_ms={ms:.4f} (device {device_ms:.4f}; product {gemm / ms / 1e9:.1f} TFLOP/s; "
        f"raw operands, prepared per call: {raw_ms:.4f}; streams alone bitwise equal) "
        f"plain_ms={plain_ms:.4f} product_library_ms={product_ms:.4f} (torch.matmul of X and W alone) "
        f"bound_ms={bms:.5f} ({by}) plan={plan}"
    )
    if not err <= tol:
        raise AssertionError(f"linear_stats[{kind}{tag}] disagrees with its plain version: {err} > {tol}")
    main = dict(max_abs_err=err, tol=tol, ms=ms, device_ms=device_ms, raw_operands_ms=raw_ms,
                plain_ms=plain_ms, product_library_ms=product_ms, bound_ms=bms, bound_by=by,
                library_ms=None, plan=plan, product_tflops=gemm / ms / 1e9, shape=shape)
    if kind == "f32":
        main.update(bound_ms_f32_fma=fma_bms, **stats_fma_turns(x, ops, wt, want, tol, tag))
        log(f"  linear_stats[f32{tag}] bounds: 3xTF32 {bms:.5f} ms ({by}), the same work as f32 FMAs "
            f"{fma_bms:.5f} ms ({fma_by})")
        if sweep:
            main["build"] = check_tf32_build("linear_stats")
            args = stats_inputs(B, T_ECAPA, C_IN, C_OUT, S, dtype, gen)  # XVector-SB's head
            xops = ls.prepare_stats_operands(*args[1:5], dtype)
            ref = ls.linear_stats_reference(*args)
            e, t = held_to(ls.fused_linear_stats(args[0], weights=args[5], operands=xops), ref, STATS_TOL)
            if not e <= t:
                raise AssertionError(f"linear_stats[f32] at XVector-SB's head disagrees: {e} > {t}")
            main["xvect_sb"] = dict(max_abs_err=e, tol=t,
                                    **stats_fma_turns(args[0], xops, args[5], ref, t, ", xvect-sb"))
    if not sweep:
        return main
    sweep_worst = 0.0
    sweep = []
    for case in STATS_SWEEP:
        args = stats_inputs(*case, dtype, gen)
        batch, time_, c_in, channels, speakers = case
        cops = ls.prepare_stats_operands(*args[1:5], dtype)
        got = ls.fused_linear_stats(args[0], weights=args[5], operands=cops)
        e, t = held_to(got, ls.linear_stats_reference(*args), STATS_TOL)
        p = ls._plan(args[0], cops, speakers)
        same = bitwise_equal(got, ls.fused_linear_stats(args[0], weights=args[5], operands=cops))
        if c_in % 8 and p["route"] != "fma" or not c_in % 8 and p["route"] not in ("wgmma", "wgmma_tf32"):
            raise AssertionError(f"linear_stats[{kind}] at {case} takes the {p['route']} route")
        log(f"  linear_stats[{kind}] B={batch} T={time_} C_in={c_in} C={channels} S={speakers} "
            f"{p['route']} grid {p['grid']} x{p['streams_per_block']} smem {p['smem']}: "
            f"max_abs_err={e:.3e} (tol {t:.3e}), repeat bitwise {same}")
        if not (e <= t and same):
            raise AssertionError(f"linear_stats[{kind}] fails at {case}")
        sweep_worst = max(sweep_worst, e / t)
        sweep.append(dict(case=case, max_abs_err=e, tol=t))
    return dict(main, sweep_cases=len(STATS_SWEEP), sweep_worst_err_over_tol=sweep_worst, sweep=sweep)


def stats_fma_turns(x, ops, wt, want, tol, tag=""):
    """The stats head's FMA route (built in build/smoke/) on f32 X, held to
    ``want`` within ``tol``, against the port (the TF32 tensor cores) in A B
    B A turns, with each one's device time."""
    from diart_tpu_torch.ops import linear_stats as ls

    fma_err = max((g - r).abs().max().item() for g, r in zip(stats_fma(x, ops, wt), want))
    if not fma_err <= tol:
        raise AssertionError(f"linear_stats_fma[f32{tag}] disagrees with the plain version: {fma_err} > {tol}")
    a, b = abba(lambda: time_ms(lambda: stats_fma(x, ops, wt), 20),
                lambda: time_ms(lambda: ls.fused_linear_stats(x, weights=wt, operands=ops), 20))
    fma_dev = device_times(lambda: stats_fma(x, ops, wt), "linear_stats_fma")[0][1]
    log(f"linear_stats[f32{tag}] X={tuple(x.shape)} A B B A (A: linear_stats_fma, B: the TF32 tensor cores), ms: "
        f"{a[0]:.4f} {b[0]:.4f} {b[1]:.4f} {a[1]:.4f}; the FMA route's device ms {fma_dev:.4f}, "
        f"max_abs_err {fma_err:.3e}")
    return dict(abba=dict(ms_turns=b, ms_fma_turns=a, ms=float(np.mean(b)), ms_fma=float(np.mean(a)),
                          device_ms_fma=fma_dev, fma_max_abs_err=fma_err))


# attn_stats: the logits are f32-accurate (3xTF32), the rest is the same f32
# arithmetic (bf16 x is read exactly); the order of the f32 sums and the
# online softmax's rescaling differ — relative to max(1, the outputs' scale)
ATTN_TOL = 1e-5
# (B, T, C, H, S) held on the card beside the main shape (see STATS_SWEEP;
# B = 1 and 8 at 501 frames are the ECAPA pipeline's calls)
ATTN_SWEEP = [
    (1, 501, 1536, 128, 4), (2, 37, 100, 64, 1), (3, 1, 1536, 128, 8), (64, 600, 1536, 64, 4),
    (256, 501, 1536, 128, 4), (3, 501, 1500, 128, 8), (2, 600, 100, 128, 4), (256, 37, 1500, 64, 1),
    (1, 279, 1500, 64, 8), (8, 501, 1536, 128, 4),
]


def attn_inputs(batch, time_, channels, hdim, speakers, dtype, gen):
    import torch

    dev = gen.device
    n = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    return (n(batch, time_, channels).to(dtype), torch.tanh(n(batch, time_, hdim)),
            n(hdim, channels) * hdim**-0.5, n(channels) * 0.1, torch.sigmoid(n(batch, speakers, time_)))


def check_attn(dtype, gen, shape=(B, T_ECAPA, C_MFA, H_ATT, S), sweep=True, tag=""):
    """Attention statistics at the ECAPA head: x (B, 501, 1536), hidden
    (B, 501, 128), 4 speakers (or ``shape`` = (B, T, C, H, S)), with
    prepared and raw operands and streams run alone; then, with ``sweep``,
    the shape sweep (see check_stats)."""
    import torch
    from diart_tpu_torch.ops import attn_stats as at

    kind = "f32" if dtype == torch.float32 else "bf16"
    B, T_ECAPA, C_MFA, H_ATT, S = shape
    x, hidden, w2, b2, wt = attn_inputs(B, T_ECAPA, C_MFA, H_ATT, S, dtype, gen)
    ops = at.prepare_attn_operands(w2, b2)  # once, as the model does
    want = at.attentive_stats_reference(x, hidden, w2, b2, wt)
    got = at.fused_attentive_stats(x, hidden, weights=wt, operands=ops)
    torch.cuda.synchronize()
    err, tol = held_to(got, want, ATTN_TOL, floor=1.0)
    if not bitwise_equal(got, at.fused_attentive_stats(x, hidden, w2, b2, wt)):
        raise AssertionError(f"attn_stats[{kind}]: raw and prepared operands give different results")
    plan = at._plan(x, hidden, S)
    for lo, hi in PART_STREAMS:
        part = at.fused_attentive_stats(x[lo:hi], hidden[lo:hi], weights=wt[lo:hi], operands=ops)
        if not bitwise_equal([g[lo:hi] for g in got], part):
            raise AssertionError(f"attn_stats[{kind}]: streams {lo}..{hi - 1} alone "
                                 f"({at._plan(x[lo:hi], hidden, S)}) differ from their rows at B={B}")
    ms = time_ms(lambda: at.fused_attentive_stats(x, hidden, weights=wt, operands=ops), 20)
    device_ms = device_times(lambda: at.fused_attentive_stats(x, hidden, weights=wt, operands=ops), "attn_stats")[0][1]
    raw_ms = time_ms(lambda: at.fused_attentive_stats(x, hidden, w2, b2, wt), 20)
    plain_ms = time_ms(lambda: at.attentive_stats_reference(x, hidden, w2, b2, wt), 5)
    product_ms = time_ms(lambda: torch.matmul(hidden, w2), 20)  # yardstick: f32 logits alone
    nbytes = x.numel() * x.element_size() + sum(t.numel() * 4 for t in (hidden, w2, b2, wt))
    nbytes += 3 * B * S * C_MFA * 4
    logits = 2.0 * B * T_ECAPA * H_ATT * C_MFA
    rest = 6.0 * B * S * T_ECAPA * C_MFA
    # f32-accurate logits on this card are three TF32 products (3xTF32); the
    # softmax and the sums run on the f32 units beside them
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(3 * logits / PEAK_FLOPS["tf32"], rest / PEAK_FLOPS["f32"])
    bms, by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    fma_bms, fma_by = bound_ms(nbytes, logits + rest, "f32")  # the logits as f32 FMAs
    log(
        f"attn_stats[{kind}{tag}] x=({B},{T_ECAPA},{C_MFA}) hidden=({B},{T_ECAPA},{H_ATT}) S={S}: "
        f"max_abs_err={err:.3e} (tol {tol:.3e} = {ATTN_TOL:g} x max(1, max|ref|)) "
        f"kernel_ms={ms:.4f} (device {device_ms:.4f}; 3xTF32 logits {3 * logits / ms / 1e9:.1f} TFLOP/s; "
        f"raw operands, prepared per call: {raw_ms:.4f}; streams alone bitwise equal) "
        f"plain_ms={plain_ms:.4f} product_library_ms={product_ms:.4f} (torch.matmul of hidden and w2 alone, f32) "
        f"bound_ms={bms:.5f} ({by}; 3xTF32 logits at {PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s) "
        f"f32_fma_bound_ms={fma_bms:.5f} ({fma_by}; the logits as f32 FMAs) plan={plan}"
    )
    if not err <= tol:
        raise AssertionError(f"attn_stats[{kind}{tag}] disagrees with its plain version: {err} > {tol}")
    main = dict(max_abs_err=err, tol=tol, ms=ms, device_ms=device_ms, raw_operands_ms=raw_ms,
                plain_ms=plain_ms, product_library_ms=product_ms, bound_ms=bms, bound_by=by,
                bound_ms_f32_fma=fma_bms, library_ms=None, plan=plan,
                logits_tflops=3 * logits / ms / 1e9, shape=shape)
    if not sweep:
        return main
    sweep_worst = 0.0
    sweep = []
    for case in ATTN_SWEEP if dtype == torch.bfloat16 else ATTN_SWEEP[::2]:
        x_, h_, w_, b_, wt_ = attn_inputs(*case, dtype, gen)
        batch, time_, channels, hdim, speakers = case
        cops = at.prepare_attn_operands(w_, b_)
        got = at.fused_attentive_stats(x_, h_, weights=wt_, operands=cops)
        e, t = held_to(got, at.attentive_stats_reference(x_, h_, w_, b_, wt_), ATTN_TOL, floor=1.0)
        p = at._plan(x_, h_, speakers)
        same = bitwise_equal(got, at.fused_attentive_stats(x_, h_, weights=wt_, operands=cops))
        log(f"  attn_stats[{kind}] B={batch} T={time_} C={channels} H={hdim} S={speakers} "
            f"grid {p['grid']} x{p['streams_per_block']} smem {p['smem']}: "
            f"max_abs_err={e:.3e} (tol {t:.3e}), repeat bitwise {same}")
        if not (e <= t and same):
            raise AssertionError(f"attn_stats[{kind}] fails at {case}")
        sweep_worst = max(sweep_worst, e / t)
        sweep.append(dict(case=case, max_abs_err=e, tol=t))
        del x_, h_, w_, b_, wt_, got
    return dict(main, sweep_cases=len(ATTN_SWEEP), sweep_worst_err_over_tol=sweep_worst, sweep=sweep)


# sinc_frontend: the kernel folds each filter about its centre tap and sums
# in its own order (one fused multiply-add a pair step), so only the order
# and the pairing of the f32 sums differ from cuDNN's true-f32 convolution:
# relative to the outputs' scale. Under bf16_frontend both round each pooled
# value to bf16 once; a last-bit difference of the f32 value flips such a
# rounding now and then: one bf16 step, at most 2^-7 of the value.
SINC_TOL = 1e-5
SINC_BF16_STEP = 2.0**-7
# (B, F) at 5 s windows: chip_smoke's B=64 and the benchmark's B=256, one
# bank (PyanNet's and the x-vector's) and the stacked pair of the engine
SINC_CASES = ((64, 80), (256, 80), (64, 160), (256, 160))
# (B, S, F) beside them: the pipelines' B=1, the widest batch the plan
# takes, a single pooled frame, partial last tiles, a length of no whole tile
SINC_SWEEP = ((1, 80000, 80), (528, 80000, 80), (3, 271, 80), (2, 16007, 160), (5, 300, 160),
              (1, 80000, 160), (7, 24011, 80))


def sinc_case(batch, samples, filters, gen):
    """A standardized waveform (B, 1, S) on the card and the prepared bank:
    at F=80 the perturbed mel bank (the benchmark's x-vector), at F=160
    the engine's stacked pair, the waveform norms folded in (a bias)."""
    import torch
    from diart_tpu_torch.models.sincnet import SincNet
    from diart_tpu_torch.ops import sinc_frontend as sf

    x = torch.randn(batch, 1, samples, device="cuda", generator=gen)
    x = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(x.var(-1, keepdim=True, correction=0) + 1e-5)
    seg, emb = SincNet().cuda(), SincNet().cuda()
    perturb_sincnet(emb)
    with torch.no_grad():
        if filters == 80:
            return x, sf.prepare_sinc_operands(emb.sinc.filters())
        fs, fe = seg.sinc.filters(), emb.sinc.filters()
        bank = torch.cat([fs * seg.wav_norm_scale, fe * emb.wav_norm_scale])
        bias = torch.cat([seg.wav_norm_bias * fs.sum(dim=1), emb.wav_norm_bias * fe.sum(dim=1)])
        return x, sf.prepare_sinc_operands(bank, bias, banks=2)


def sinc_held(got, want, bf16):
    """(max abs error, its allowance, the worst ratio of an element's error
    to its own allowance): SINC_TOL x max|want|, and under bf16 one bf16
    step of each value beside it."""
    scale = want.abs().max().item()
    room = SINC_TOL * scale + (SINC_BF16_STEP * want.abs() if bf16 else 0.0)
    diff = (got - want).abs()
    worst = (diff / room).max().item() if bf16 else diff.max().item() / room
    return diff.max().item(), SINC_TOL * scale, worst


def sinc_sass():
    """Instruction counts of the kernel's SASS (``cuobjdump``): its FMAs
    against the rest of the loop, a record."""
    from diart_tpu_torch.ops import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "--dump-sass", str(_build.BUILD_DIR / "libsinc_frontend.so")],
                          capture_output=True, text=True, timeout=120).stdout
    ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", text, re.M)
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    top = dict(sorted(counts.items(), key=lambda kv: -kv[1])[:12])
    log(f"  [sinc_frontend] SASS: {len(ops)} instructions, by opcode {top}")
    return dict(instructions=len(ops), by_opcode=top)


def check_sinc(dtype, gen):
    """SincNet's first stage (``sinc_frontend``) at 5 s windows, B = 64
    and 256, F = 80 (one bank) and 160 (the stacked pair, with a bias), with
    ``bf16_frontend`` on (``dtype`` bf16) or off (f32): against the plain
    version (cuDNN's true-f32 convolution, then ``frontend_pool``) within
    SINC_TOL, bitwise over two calls, a stream alone bitwise its row of the
    batch; its time (CUDA events and the profiler's device time) beside the
    plain version's, cuDNN's convolution alone and the bounds; then the
    sweep of SINC_SWEEP. In f32 also ptxas' report of the kernel (no spill
    or stack frame) and its SASS's instruction counts."""
    import torch
    import torch.nn.functional as F
    from diart_tpu_torch import precision
    from diart_tpu_torch.ops import _build, _numerics
    from diart_tpu_torch.ops import sinc_frontend as sf

    bf16 = dtype == torch.bfloat16
    kind = "bf16" if bf16 else "f32"
    lib = _build.library("sinc_frontend", sf._signature)
    rec, failures = {}, []
    with precision.use(precision.Precision(bf16_frontend=bf16), force=True):
        for batch, filters in SINC_CASES:
            x, ops = sinc_case(batch, 80000, filters, gen)
            run = lambda: sf.sinc_frontend(x, None, sf.STRIDE, operands=ops)
            plain = lambda: sf.sinc_frontend_reference(x, ops.filters, sf.STRIDE, ops.bias)
            before = sf.sinc_frontend.launches
            got = run()
            want = plain()
            torch.cuda.synchronize()
            err, tol, worst = sinc_held(got, want, bf16)
            same = torch.equal(got, run())
            alone = torch.equal(sf.sinc_frontend(x[37:38], None, sf.STRIDE, operands=ops), got[37:38])
            launched = sf.sinc_frontend.launches - before
            plan = sf.launch_plan(batch, 80000, filters, _build.num_sms(x.device))
            ms = time_ms(run, 20)
            device = device_times(run, "sinc_frontend")
            plain_ms = time_ms(plain, 10)
            with _numerics.true_f32(x.device):
                library_ms = time_ms(lambda: F.conv1d(x, ops.filters[:, None, :], ops.bias, stride=sf.STRIDE), 10)
            flops = 2.0 * (filters // 2 * 126 + filters // 2 * 125) * sf.POOL * plan["pooled"] * batch
            nbytes = 4.0 * batch * 80000 + 4.0 * batch * filters * plan["pooled"]
            (bms, by), (fma_ms, fma_by) = tf32_bounds(nbytes, flops)
            smem = lib.sinc_frontend_smem(filters)
            tag = f"B{batch}_F{filters}"
            log(f"sinc_frontend[{kind}] wave ({batch}, 1, 80000) F={filters}: max_abs_err={err:.3e} (tol {tol:.3e} = "
                f"{SINC_TOL:g} x max|ref|{' + one bf16 step of each value' if bf16 else ''}; worst element "
                f"{worst:.3f} of its room) bitwise over two calls {same}, stream 37 alone bitwise {alone}; "
                f"kernel_ms={ms:.4f} (device {device[0][1]:.4f} as {device[0][0]}; {flops / ms / 1e9:.1f} "
                f"TFLOP/s folded) plain_ms={plain_ms:.4f} (cuDNN true f32 + frontend_pool) "
                f"library_ms={library_ms:.4f} (cuDNN's convolution alone) bound_ms={bms:.4f} ({by}, the f32 "
                f"product peak 165 TFLOP/s) fma_bound_ms={fma_ms:.4f} ({fma_by}, 67 TFLOP/s) plan={plan} "
                f"library smem {smem}")
            if not (worst <= 1.0 and same and alone and launched == 3 and smem == plan["smem"]
                    and device[0][0].startswith("sinc_frontend")):
                failures.append(f"{tag}: worst {worst}, repeat {same}, alone {alone}, launches {launched}, "
                                f"smem {smem} / {plan['smem']}, device {device[0][0]}")
            rec[tag] = dict(max_abs_err=err, tol=tol, worst=worst, ms=ms, device_ms=device[0][1],
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
                            bound_ms_f32_fma=fma_ms, plan=plan, tflops=flops / ms / 1e9)
            del x, ops, got, want
        sweep = []
        for batch, samples, filters in SINC_SWEEP:
            x, ops = sinc_case(batch, samples, filters, gen)
            got = sf.sinc_frontend(x, None, sf.STRIDE, operands=ops)
            want = sf.sinc_frontend_reference(x, ops.filters, sf.STRIDE, ops.bias)
            err, tol, worst = sinc_held(got, want, bf16)
            same = torch.equal(got, sf.sinc_frontend(x, None, sf.STRIDE, operands=ops))
            plan = sf.launch_plan(batch, samples, filters, _build.num_sms(x.device))
            log(f"  sinc_frontend[{kind}] B={batch} S={samples} F={filters} -> {tuple(got.shape)}: "
                f"max_abs_err={err:.3e} (tol {tol:.3e}; worst {worst:.3f}) repeat bitwise {same}; "
                f"grid {plan['grid']}, {plan['items']} items of {plan['tile']} pooled frames")
            if not (worst <= 1.0 and same and got.shape == want.shape):
                failures.append(f"sweep {(batch, samples, filters)}: worst {worst}, repeat {same}")
            sweep.append(dict(case=(batch, samples, filters), max_abs_err=err, tol=tol, worst=worst))
            del x, ops, got, want
    main = dict(rec["B64_F80"], at_b256=rec["B256_F80"], cases=rec, sweep=sweep)
    if not bf16:
        recs = [r for r in ptxas_entries(BUILD_LOGS.get("sinc_frontend", "")) if "sinc_frontend" in r["entry"]]
        for r in recs:
            log(f"  [sinc_frontend] {r['entry']}: {r.get('registers')} registers, {r.get('smem')} bytes smem, "
                f"stack frame {r.get('stack_frame')} bytes, spill stores {r.get('spill_stores')} / loads "
                f"{r.get('spill_loads')}")
        if not recs or any(r.get("spill_stores") or r.get("spill_loads") or r.get("stack_frame") for r in recs):
            failures.append(f"ptxas: no record, or a spill or stack frame: {recs}")
        main.update(ptxas=recs, sass=sinc_sass())
    if failures:
        raise AssertionError(f"sinc_frontend[{kind}]: " + "; ".join(failures))
    return main


# ResNet34's trunk convolutions (``ops/resnet_conv.py``, ``csrc/
# resnet_conv.cu``) at the benchmark's B = 256 and 5 s windows (498 kaldi
# frames x 80 mels), published widths: each distinct geometry of the trunk
# as (name, C_in, C_out, window, stride, (T, F) in, residual, ReLU); the
# padding is 1 for a 3x3 window and 0 for the 1x1 downsamples
RESNET_B = 256
RESNET_CASES = (
    ("stem", 1, 32, 3, 1, (498, 80), False, True),
    ("s1.conv1", 32, 32, 3, 1, (498, 80), False, True),
    ("s1.conv2", 32, 32, 3, 1, (498, 80), True, True),
    ("s2.conv1", 32, 64, 3, 2, (498, 80), False, True),
    ("s2.down", 32, 64, 1, 2, (498, 80), False, False),
    ("s2.conv2", 64, 64, 3, 1, (249, 40), True, True),
    ("s3.conv1", 64, 128, 3, 2, (249, 40), False, True),
    ("s3.down", 64, 128, 1, 2, (249, 40), False, False),
    ("s3.conv2", 128, 128, 3, 1, (125, 20), True, True),
    ("s4.conv1", 128, 256, 3, 2, (125, 20), False, True),
    ("s4.down", 128, 256, 1, 2, (125, 20), False, False),
    ("s4.conv2", 256, 256, 3, 1, (63, 10), True, True),
)
# beside them, (case, batch): the test family's 8 and 16 channels (a K slice
# of 16 that reads channels past C_in as the tensor map's zeros), 24 in /
# 40 out (C_pad 32, a tile wider than C_out) over 77 mels (ragged boxes),
# two 256-wide channel tiles of 320 outputs at stride 2, one stream alone
RESNET_SWEEP = (
    (("c8.stem", 1, 8, 3, 1, (37, 20), False, True), 3),
    (("c8.s1", 8, 8, 3, 1, (37, 20), True, True), 3),
    (("c8.s2", 8, 16, 3, 2, (37, 20), False, True), 3),
    (("c8.down", 8, 16, 1, 2, (37, 20), False, False), 3),
    (("c24.s1", 24, 40, 3, 1, (29, 77), True, True), 2),
    (("c256.s2", 256, 320, 3, 2, (31, 13), False, True), 2),
    (("b1.s1", 32, 32, 3, 1, (498, 80), True, True), 1),
)
RESNET_ROUNDING = 2.0**-7  # a bf16 rounding flip: one step, at most 2^-7 of the value
# the share of outputs that may differ from the plain version at all: the
# summation order alone flips the convolution's bf16 rounding of at most
# 0.015% of them at any geometry (an H100, `resnet_held`), while a rounding
# step out of place (a product and a sum fused into one rounding) moves
# 8-28% of them, within the room of each
RESNET_DIFFER_MAX = 1e-3


def resnet_case(case, batch, gen, dev="cuda"):
    """The inputs of one convolution: x (B, T, F, C_in) bf16 channels-last
    (the stem: the f32 features), the weight (C_out, C_in, k, k) at a
    1 / sqrt(fan in) scale, a batch norm's folded (a, b) from random
    statistics, the residual (B, T', F', C_out) bf16 or None."""
    import torch
    from diart_tpu_torch.models.common import InferenceBatchNorm

    _, c_in, c_out, k, stride, (t, f), has_res, _ = case
    n = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = n(batch, t, f, c_in)
    x = x if c_in == 1 else x.to(torch.bfloat16)
    weight = n(c_out, c_in, k, k) / (c_in * k * k) ** 0.5
    bn = InferenceBatchNorm(c_out).to(dev)
    with torch.no_grad():
        bn.scale.copy_(1 + 0.1 * n(c_out))
        bn.bias.copy_(0.1 * n(c_out))
        bn.mean.copy_(0.1 * n(c_out))
        bn.var.copy_(0.5 + torch.rand(c_out, generator=gen, device=dev))
        a, b = bn.folded()
    pad = k // 2
    o1, o2 = (t + 2 * pad - k) // stride + 1, (f + 2 * pad - k) // stride + 1
    res = n(batch, o1, o2, c_out).to(torch.bfloat16) if has_res else None
    return x, weight, a, b, res, stride, pad


def resnet_allowance(x, weight, a, b, res, stride, pad):
    """Each output's room for the summation order alone. The kernel's f32
    sum and the plain version's, taken in other orders, each lie within
    (K - 1) 2^-24 of the sum of |products| of the exact sum, so they differ
    by up to 2 (K - 1) 2^-24 sum |x w| (|a| times that after the scale);
    the plain version's convolution c then rounds to bf16 one step either
    way of the kernel's where they straddle a rounding boundary (|a c| 2^-7
    after the scale), and that can flip each later rounding (x a, + b, +
    residual) by one step of its own value. So 2 (K - 1) 2^-24 |a| sum |x
    w| + 2^-7 (2 |a c| + |bf16(a c) + b| + |out before ReLU|)."""
    import torch
    import torch.nn.functional as F

    dt = torch.bfloat16
    k = weight.shape[1] * weight.shape[2] * weight.shape[3]
    xc = x.to(dt).permute(0, 3, 1, 2)
    c = F.conv2d(xc, weight.to(dt), stride=stride, padding=pad).float()
    mags = F.conv2d(xc.float().abs(), weight.to(dt).float().abs(), stride=stride, padding=pad)
    av, bv = a.to(dt).float().view(1, -1, 1, 1), b.to(dt).float().view(1, -1, 1, 1)
    y1 = (c * av).to(dt).float()
    y2 = (y1 + bv).to(dt).float()
    y3 = y2 if res is None else (y2 + res.permute(0, 3, 1, 2).float()).to(dt).float()
    room = 2.0 * (k - 1) * 2.0**-24 * mags * av.abs() + RESNET_ROUNDING * (2 * (av * c).abs() + y2.abs() + y3.abs())
    return room.permute(0, 2, 3, 1)


def resnet_held(got, want, room):
    """(worst ratio of an element's error to its room, max abs error, the
    share of elements that differ at all, mean error over mean |want|)."""
    diff = (got.float() - want.float()).abs()
    worst = (diff / room.clamp_min(1e-30)).max().item() if diff.max().item() > 0 else 0.0
    differ = (diff > 0).float().mean().item()
    mean_rel = diff.mean().item() / max(want.float().abs().mean().item(), 1e-30)
    return worst, diff.max().item(), differ, mean_rel


def resnet_least_ms(case, batch):
    """``portbench/work/resnet34.py``'s least of one convolution: the larger
    of its bf16 products at 989 TFLOP/s and its input read, output written
    and weights read once over HBM (the residual read not counted)."""
    _, c_in, c_out, k, stride, (t, f), _, _ = case
    pad = k // 2
    p_in = t * f
    p_out = ((t + 2 * pad - k) // stride + 1) * ((f + 2 * pad - k) // stride + 1)
    ops = 2.0 * batch * c_in * c_out * k * k * p_out / PEAK_FLOPS["bf16"]
    nbytes = 2.0 * (batch * (c_in * p_in + c_out * p_out) + c_in * c_out * k * k) / HBM_BYTES_PER_S
    return max(ops, nbytes) * 1e3, "operations" if ops > nbytes else "bytes"


def resnet_sass():
    """The built library's SASS (``cuobjdump --dump-sass``): every
    convolution kernel (``resnet_conv_taps``, ``resnet_conv_halo``) holds a
    warpgroup MMA (``HGMMA``)."""
    from diart_tpu_torch.ops import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "--dump-sass", str(_build.BUILD_DIR / "libresnet_conv.so")],
                          capture_output=True, text=True, timeout=120).stdout
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    conv = [fn for fn in funcs if re.search(r"resnet_conv_(taps|halo)", fn.split("\n", 1)[0])]
    rec = dict(functions=len(funcs), conv_kernels=len(conv),
               with_hgmma=sum(bool(re.search(r"\bHGMMA", fn)) for fn in conv),
               hgmma_instructions=sum(len(re.findall(r"\bHGMMA\S*", fn)) for fn in conv))
    log(f"  [resnet_conv] SASS: {rec['conv_kernels']} convolution kernels, {rec['with_hgmma']} with HGMMA "
        f"({rec['hgmma_instructions']} instructions)")
    return rec


def resnet_refusals(gen):
    """The kernel's wrapper raises on CUDA calls it does not take: f32
    activations, channels not a multiple of 8, activations not
    channels-last, a gradient."""
    import torch
    from diart_tpu_torch.ops.resnet_conv import resnet_conv

    x, weight, a, b, _, _, _ = resnet_case(("r", 16, 16, 3, 1, (9, 8), False, True), 2, gen)
    odd_x, odd_w, oa, ob, _, _, _ = resnet_case(("r", 12, 16, 3, 1, (9, 8), False, True), 2, gen)
    calls = dict(
        float32=lambda: resnet_conv(x.float(), weight, a, b, padding=1),
        channels=lambda: resnet_conv(odd_x, odd_w, oa, ob, padding=1),
        channels_first=lambda: resnet_conv(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), weight, a, b,
                                           padding=1),
        gradient=lambda: resnet_conv(x, weight.requires_grad_(), a, b, padding=1),
    )
    refused = {}
    for what, call in calls.items():
        try:
            call()
            refused[what] = False
        except ValueError:
            refused[what] = True
    weight.requires_grad_(False)
    log(f"  [resnet_conv] refuses on the card: {refused}")
    return refused


def check_resnet(dtype, gen):
    """ResNet34's trunk convolutions (``resnet_conv``) at every distinct
    geometry of the trunk at B = 256 and published widths, in bf16: against
    the plain version on the card (cuDNN's bf16 convolution on the NCHW
    view, then the norm, the add and ReLU as PyTorch's ops) within the room
    of the summation order (``resnet_allowance``), bitwise over two calls;
    its time (CUDA events, the profiler's device time) beside its least
    (``portbench/work/resnet34.py``), the plain version's and cuDNN's
    convolution alone on channels-last tensors; then RESNET_SWEEP, the
    refusals, ptxas' report and the SASS, and the whole trunk at B = 256
    through the kernel and through the composition it replaced, A B B A."""
    import torch
    import torch.nn.functional as F
    from diart_tpu_torch.ops import _build
    from diart_tpu_torch.ops import resnet_conv as rc

    if dtype != torch.bfloat16:
        raise ValueError("the ResNet34 kernel computes in bf16 only")
    rec, failures, sweep = {}, [], []

    def one(case, batch, timed):
        name, c_in, c_out, k, _, _, _, relu = case
        x, weight, a, b, res, stride, pad = resnet_case(case, batch, gen)
        ops = rc.prepare_conv_operands(weight, a, b)
        run = lambda: rc.resnet_conv(x, weight, a, b, stride, pad, res, relu, torch.bfloat16, operands=ops)
        plain = lambda: rc.resnet_conv_reference(x, weight, a, b, stride, pad, res, relu, torch.bfloat16)
        before = rc.resnet_conv.launches
        got = run()
        want = plain()
        torch.cuda.synchronize()
        launched = rc.resnet_conv.launches - before
        worst, err, differ, mean_rel = resnet_held(got, want, resnet_allowance(x, weight, a, b, res, stride, pad))
        same = torch.equal(got, run())
        alone = torch.equal(rc.resnet_conv(x[-1:], weight, a, b, stride, pad, None if res is None else res[-1:],
                                           relu, torch.bfloat16, operands=ops), got[-1:])
        entry = dict(shape=tuple(got.shape), max_abs_err=err, worst=worst, differ_share=differ,
                     mean_rel_err=mean_rel, bitwise_repeat=same, stream_alone=alone)
        ok = worst <= 1.0 and differ <= RESNET_DIFFER_MAX and same and alone and launched == 1 and got.shape == want.shape
        plan = None if c_in == 1 else rc.conv_plan(c_out, got.shape[1], got.shape[2], c_in, (k, k), (stride,) * 2,
                                                   (pad,) * 2)
        if timed:
            least, by = resnet_least_ms(case, batch)
            ms = time_ms(run, 10)
            device = device_times(run, f"resnet_conv {name}")
            plain_ms = time_ms(plain, 5)
            xl = x.permute(0, 3, 1, 2)  # cuDNN on the same memory: NHWC tensors, no transposes
            wl = weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            library_ms = time_ms(lambda: F.conv2d(xl.to(torch.bfloat16), wl, stride=stride, padding=pad), 10)
            entry.update(ms=ms, device_ms=device[0][1], device_kernel=device[0][0], plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=least, bound_by=by, roofline=100.0 * least / ms)
        log(f"resnet_conv[{name}] x {tuple(x.shape)} -> {tuple(got.shape)}: worst {worst:.3f} of the room, "
            f"max_abs_err={err:.3e}, {100 * differ:.3f}% of elements differ, mean err {mean_rel:.2e} of "
            f"mean|want|; repeat bitwise {same}, last stream alone bitwise {alone}; plan {plan}"
            + (f"; kernel_ms={entry['ms']:.4f} (device {entry['device_ms']:.4f} as {entry['device_kernel']}) "
               f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']}; {entry['roofline']:.1f}%) "
               f"plain_ms={entry['plain_ms']:.4f} library_ms={entry['library_ms']:.4f} (cuDNN's convolution "
               f"alone, channels-last)" if timed else ""))
        if not ok:
            failures.append(f"{name}: worst {worst}, differing share {differ}, repeat {same}, alone {alone}, "
                            f"launches {launched}")
        return entry

    for case in RESNET_CASES:
        rec[case[0]] = one(case, RESNET_B, True)
        torch.cuda.empty_cache()
    for case, batch in RESNET_SWEEP:
        sweep.append(dict(one(case, batch, False), case=case[0], batch=batch))
    refused = resnet_refusals(gen)
    if not all(refused.values()):
        failures.append(f"refusals {refused}")
    ptx = [r for r in ptxas_entries(BUILD_LOGS.get("resnet_conv", "")) if "resnet_" in r["entry"]]
    for r in ptx:
        log(f"  [resnet_conv] {r['entry']}: {r.get('registers')} registers, {r.get('smem')} bytes smem, "
            f"stack frame {r.get('stack_frame')} bytes, spill stores {r.get('spill_stores')} / loads "
            f"{r.get('spill_loads')}")
    if not ptx or any(r.get("spill_stores") or r.get("spill_loads") for r in ptx):
        failures.append(f"ptxas: no record, or a spill: {ptx}")
    sass = resnet_sass()
    if not (sass["conv_kernels"] and sass["with_hgmma"] == sass["conv_kernels"]):
        failures.append(f"SASS: every convolution kernel must use HGMMA: {sass}")
    trunk = resnet_trunk_abba(gen)
    total = dict(ms=sum(r["ms"] for r in rec.values()), bound_ms=sum(r["bound_ms"] for r in rec.values()))
    log(f"resnet_conv: the {len(rec)} geometries' kernel ms sum to {total['ms']:.3f} against a least of "
        f"{total['bound_ms']:.3f}")
    if failures:
        raise AssertionError("resnet_conv: " + "; ".join(failures))
    main = dict(rec["s1.conv2"], cases=rec, sweep=sweep, refused=refused, ptxas=ptx, sass=sass, trunk=trunk)
    return main


def resnet_trunk_abba(gen):
    """The seeded full-width ResNet34 trunk (bf16) at B = 256 from 498
    frames of 80 mels: through the kernel (36 launches) and through the
    composition it replaced (the model's NCHW route, forced), A B B A with
    CUDA events; the two outputs' gap (36 layers of bf16 apart) as a
    record."""
    import torch
    from diart_tpu_torch import EmbeddingModel
    from diart_tpu_torch.ops import resnet_conv as rc

    module = EmbeddingModel.from_registry("tpu/resnet34", device="cuda", seed=1, dtype="bf16").module
    feats = torch.randn(RESNET_B, 498, 80, generator=gen, device="cuda")
    feats = feats - feats.mean(dim=1, keepdim=True)
    kernel = lambda: module.trunk_from_features(feats)

    def composition():
        module.channels_last = lambda f: False
        try:
            return module.trunk_from_features(feats)
        finally:
            del module.channels_last

    with torch.no_grad():
        before = rc.resnet_conv.launches
        new = kernel()
        launched = rc.resnet_conv.launches - before
        old = composition()
        torch.cuda.synchronize()
        gap = (new.float() - old.float()).abs()
        scale = old.float().abs().max().item()
        turns = [time_ms(f, 5) for f in (composition, kernel, kernel, composition)]
    rec = dict(launches=launched, max_gap=gap.max().item(), max_gap_rel=gap.max().item() / scale,
               mean_gap_rel=gap.mean().item() / old.float().abs().mean().item(), ms_turns=turns,
               ms=(turns[1] + turns[2]) / 2, ms_composition=(turns[0] + turns[3]) / 2)
    log(f"resnet34 trunk at B={RESNET_B} (498 x 80): {launched} kernel launches; A B B A ms (A: the composition "
        f"it replaced, B: the kernel) {' '.join(f'{t:.3f}' for t in turns)}; outputs apart by "
        f"{rec['max_gap_rel']:.3e} of the largest at most, {rec['mean_gap_rel']:.3e} in the mean")
    if launched != 36:
        raise AssertionError(f"resnet34 trunk: expected 36 kernel launches; got {launched}")
    return rec


def res2_params(gen, dev):
    """Unit-gain SE-Res2Block parameters at the ECAPA geometry (0.5/sqrt(fan_in)
    weight scales, as tests/test_pallas_res2.py: larger random weights make
    the 7-group cascade amplify rounding noise and read as a kernel fault)."""
    import torch

    n = lambda *s: torch.randn(*s, generator=gen)
    mk = lambda *s: n(*s) * (0.5 / s[-2] ** 0.5)
    c, width, groups = C_ECAPA, C_ECAPA // RES2_SCALE, RES2_SCALE - 1
    params = (
        mk(c, c), 0.1 * n(c), 1 + 0.1 * n(c), 0.1 * n(c),
        n(groups, 3, width, width) * (0.5 / (3 * width) ** 0.5),
        0.1 * n(groups, width), 1 + 0.1 * n(groups, width), 0.1 * n(groups, width),
        mk(c, c), 0.1 * n(c), 1 + 0.1 * n(c), 0.1 * n(c),
        mk(c, SE_HIDDEN), 0.1 * n(SE_HIDDEN), mk(SE_HIDDEN, c), 0.1 * n(c),
    )
    return tuple(p.to(dev) for p in params)


# bf16: the kernel and the plain version round at the same points, but an
# f32 sum in another order now and then flips one bf16 rounding, one ulp
# (<= 2**-7 of the value): max error within 2**-6 of the output's largest
# magnitude. Such flips are rare, so the mean error stays far below 2**-12
# of the mean magnitude of what the block computes (the output less the
# residual x; for a stage, its output). A kernel that skips one of the
# oracle's rounding points (z1, chunk + y, y, z2, the gate, z2 * gate)
# moves a few percent of the outputs by an ulp, and its mean error exceeds
# that limit: check_res2 holds a plain block with z2 * gate unrounded to
# it and requires it to fail. f32: summation order only, max error within
# 1e-4 of the output's scale.
RES2_TOL = {"bf16": (2.0**-6, 2.0**-12), "f32": (1e-4, None)}


def res2_unrounded_gate(x, params, dilation):
    """The plain block with one rounding point skipped (``z2 * gate`` kept
    in f32 before the residual sum): a kernel fault the bf16 check must
    catch."""
    import torch
    from diart_tpu_torch.ops import se_res2

    dt = x.dtype
    w2, b2, a2, c2, ws1, bs1, ws2, bs2 = params[8:]
    cat = se_res2.se_res2_stage_reference(x, params, dilation, RES2_SCALE - 1)
    z2 = (torch.relu(cat.float() @ w2.to(dt).float() + b2) * a2 + c2).to(dt)
    s = torch.relu(z2.float().mean(dim=1) @ ws1 + bs1)
    gate = torch.sigmoid(s @ ws2 + bs2).to(dt)
    return (x.float() + z2.float() * gate.float()[:, None, :]).to(dt)


# profiles a device_times call may take: late in a long process the
# profiler has now and then returned no device event at all for a call
# that ran (a failed session of the tracer, not of the kernel)
PROFILE_ATTEMPTS = 3


def device_times(call, what: str, calls: int = 10):
    """Device time of each kernel that ``call`` launches, from a profile of
    ``calls`` calls, longest first: (name, ms per call, launches per call).
    A profile with no device event is taken again, up to PROFILE_ATTEMPTS
    profiles in all, each logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    call()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            m = re.search(r"([A-Za-z_]\w*)\s*(<[^(]*>)?\s*\(", e.key.replace("(anonymous namespace)::", ""))
            name = m.group(1) + (m.group(2) or "") if m else e.key[:40]
            rows.append((name, us / 1e3 / calls, e.count / calls))
        if rows:
            return sorted(rows, key=lambda r: -r[1])
        log(f"  the profiler saw no device time for {what} (profile {attempt} of {PROFILE_ATTEMPTS})")
    raise AssertionError(f"the profiler saw no device time for {what} in {PROFILE_ATTEMPTS} profiles")


def check_res2(dtype, gen):
    """The SE-Res2Block at (B, 501, 512), dilations 2, 3, 4; every stage of
    the stage mode; the full block and the concat at batch 1, 2, 3, 8."""
    import torch
    from diart_tpu_torch.ops import se_res2

    dev = "cuda"
    kind = "f32" if dtype == torch.float32 else "bf16"
    rel_max, rel_mean = RES2_TOL[kind]
    params = res2_params(gen, dev)
    ops = se_res2.kernel_operands(params, dtype)  # laid out once, as the model does
    x = torch.randn(B, T_ECAPA, C_ECAPA, generator=gen).to(dev, dtype)

    failures, means = [], []

    def held(got, want, what, residual=None):
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        tol = rel_max * max(want.float().abs().max().item(), 1.0)
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        if not ok:
            failures.append(f"{what}: max {err:.3e} > {tol:.3e}")
        if rel_mean is not None:
            computed = want.float() if residual is None else want.float() - residual.float()
            mean, mean_tol = diff.mean().item(), rel_mean * computed.abs().mean().item()
            means.append((mean, mean_tol))
            if not mean <= mean_tol:
                failures.append(f"{what}: mean {mean:.3e} > {mean_tol:.3e}")
        return err, tol

    errs, stage_errs = {}, []
    for d in (2, 3, 4):
        got = se_res2.fused_se_res2_block(x, None, d, operands=ops)
        want = se_res2.se_res2_block_reference(x, *params, d)
        torch.cuda.synchronize()
        errs[d] = held(got, want, f"block d={d}", residual=x)
        if not torch.equal(got, se_res2.fused_se_res2_block(x, None, d, operands=ops)):
            failures.append(f"block d={d}: two calls differ")
        for stage in range(RES2_SCALE):
            got = se_res2.se_res2_staged(x, None, d, stage, operands=ops)
            want = se_res2.se_res2_stage_reference(x, params, d, stage)
            stage_errs.append(held(got, want, f"stage {stage} d={d}")[0])
    for batch in (1, 2, 3, 8):
        xb = x[:batch].contiguous()
        held(se_res2.fused_se_res2_block(xb, params, 3), se_res2.se_res2_block_reference(xb, *params, 3),
             f"block B={batch}", residual=xb)
        held(se_res2.se_res2_staged(xb, params, 3, RES2_SCALE - 1),
             se_res2.se_res2_stage_reference(xb, params, 3, RES2_SCALE - 1), f"concat B={batch}")
    # the cascade's time split, at d = 4, under the tiles the wrapper plans:
    # a length that is not a multiple of the tile (333 frames, 3 streams: 5
    # tiles of 67); the shortest length d = 4 takes (pad < T) and 40 frames,
    # where both reflected ends fall inside one tile; 7 tiles a stream; 100
    # streams, whose windows have more than 256 rows (the 16-warp kernel).
    # The same streams in a smaller batch run under another tile, and the
    # kernel's result must not depend on the tile at all.
    last = RES2_SCALE - 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for time_, batch in ((333, 3), (5, 2), (40, 2), (T_ECAPA, 2), (T_ECAPA, 100)):
        xb = (x if batch <= B else torch.cat([x, x[:batch - B]]))[:batch, :time_].contiguous()
        got_c = se_res2.se_res2_staged(xb, None, 4, last, operands=ops)
        got_b = se_res2.fused_se_res2_block(xb, None, 4, operands=ops)
        tile = se_res2.cascade_tile(batch, time_, dtype, sms)
        held(got_c, se_res2.se_res2_stage_reference(xb, params, 4, last), f"concat T={time_} tile={tile}")
        held(got_b, se_res2.se_res2_block_reference(xb, *params, 4), f"block T={time_} tile={tile}",
             residual=xb)
        if batch > 1 and se_res2.cascade_tile(1, time_, dtype, sms) != tile:
            one_c = se_res2.se_res2_staged(xb[:1], None, 4, last, operands=ops)
            one_b = se_res2.fused_se_res2_block(xb[:1], None, 4, operands=ops)
            if not (torch.equal(one_c, got_c[:1]) and torch.equal(one_b, got_b[:1])):
                failures.append(f"T={time_}: the result depends on the time tile ({tile})")
    if failures:
        raise AssertionError(f"se_res2[{kind}] disagrees with its plain version: " + "; ".join(failures))
    mutant = None
    if rel_mean is not None:  # the mean-error limit must catch a skipped rounding point
        want = se_res2.se_res2_block_reference(x, *params, 2).float()
        bad = res2_unrounded_gate(x, params, 2).float()
        mutant = ((bad - want).abs().mean().item(), rel_mean * (want - x.float()).abs().mean().item())
        log(f"  se_res2[{kind}] a plain block with z2 * gate unrounded: mean abs err {mutant[0]:.3e} "
            f"(tol {mutant[1]:.3e})")
        if not mutant[0] > mutant[1]:
            raise AssertionError(f"se_res2[{kind}]: the mean-error check does not catch a skipped rounding")
    err = max(e for e, _ in errs.values())
    tol = max(t for _, t in errs.values())
    worst_mean = max(means, key=lambda m: m[0] / m[1]) if means else None
    ms = time_ms(lambda: se_res2.fused_se_res2_block(x, None, 2, operands=ops), 20)
    plain_ms = time_ms(lambda: se_res2.se_res2_block_reference(x, *params, 2), 5)
    elt = x.element_size()
    groups, width = RES2_SCALE - 1, C_ECAPA // RES2_SCALE
    nbytes = 2 * x.numel() * elt + (2 * C_ECAPA * C_ECAPA + groups * 3 * width * width) * elt
    nbytes += 4 * (9 * C_ECAPA + 3 * groups * width + 2 * C_ECAPA * SE_HIDDEN + SE_HIDDEN)
    flops = 2.0 * B * T_ECAPA * (2 * C_ECAPA * C_ECAPA + groups * 3 * width * width)
    flops += 2.0 * B * 2 * C_ECAPA * SE_HIDDEN
    bms, by = bound_ms(nbytes, flops, kind)
    x8 = x[:8].contiguous()
    ms_b8 = time_ms(lambda: se_res2.fused_se_res2_block(x8, None, 2, operands=ops), 20)
    by_launch = device_times(lambda: se_res2.fused_se_res2_block(x, None, 2, operands=ops), "the SE-Res2Block")
    # the stage mode's longest run: z1 and the whole cascade (the concat)
    stage_ms = time_ms(lambda: se_res2.se_res2_staged(x, None, 2, last, operands=ops), 20)
    stage_plain_ms = time_ms(lambda: se_res2.se_res2_stage_reference(x, params, 2, last), 5)
    stage_bytes = 2 * x.numel() * elt + (C_ECAPA * C_ECAPA + groups * 3 * width * width) * elt
    stage_bytes += 4 * (3 * C_ECAPA + 3 * groups * width)
    stage_flops = 2.0 * B * T_ECAPA * (C_ECAPA * C_ECAPA + groups * 3 * width * width)
    stage_bms, stage_by = bound_ms(stage_bytes, stage_flops, kind)
    log(
        f"se_res2[{kind}] x=({B},{T_ECAPA},{C_ECAPA}) scale {RES2_SCALE}: block max_abs_err "
        + ", ".join(f"d={d} {e:.3e} (tol {t:.3e})" for d, (e, t) in errs.items())
        + f"; bitwise over two calls; {len(stage_errs)} stages max_abs_err={max(stage_errs):.3e}; batch 1/2/3/8 ok; "
        + "time tiles ok (T=333, 5, 40, 501; the result does not depend on the tile); "
        + (f"mean abs err, worst against its tol: {worst_mean[0]:.3e} (tol {worst_mean[1]:.3e} = "
           f"2^-12 x mean|computed|); " if worst_mean else "")
        + f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by}); "
        f"stage {last} kernel_ms={stage_ms:.4f} plain_ms={stage_plain_ms:.4f} "
        f"bound_ms={stage_bms:.5f} ({stage_by}); B=8: kernel_ms={ms_b8:.4f} "
        f"(time tile {se_res2.cascade_tile(8, T_ECAPA, dtype, torch.cuda.get_device_properties(0).multi_processor_count)}, "
        f"B={B}: {se_res2.cascade_tile(B, T_ECAPA, dtype, torch.cuda.get_device_properties(0).multi_processor_count)})"
    )
    device_ms = sum(ms_ for _, ms_, _ in by_launch)
    log(f"  se_res2[{kind}] device ms of each launch of one block (profile of 10 calls): "
        + ", ".join(f"{name} {ms_:.4f} x{n:g}" for name, ms_, n in by_launch)
        + f"; sum {device_ms:.4f} (kernel_ms above is CUDA events around 20 calls: it also holds the "
        "gaps between the five launches when the host enqueues slower than the card runs)")
    # the kernels the plan names are the ones that ran
    plan = se_res2.launch_plan(B, T_ECAPA, C_ECAPA, 3, 2, dtype, sms)
    ran = sorted(n.split("<")[0] for n, _, _ in by_launch)
    if ran != sorted([plan["tdnn"], plan["cascade"], "se_gate", "se_residual"]):
        raise AssertionError(f"se_res2[{kind}]: the block launched {ran}; its plan names {plan}")
    stage = dict(max_abs_err=max(stage_errs), stages_checked=len(stage_errs), ms=stage_ms,
                 plain_ms=stage_plain_ms, bound_ms=stage_bms, bound_by=stage_by)
    rec = dict(max_abs_err=err, tol=tol, worst_mean_err=worst_mean, unrounded_gate_mean_err=mutant,
               ms=ms, plain_ms=plain_ms, ms_b8=ms_b8, device_ms=device_ms,
               by_launch=[dict(name=n, ms=m, per_block=c) for n, m, c in by_launch],
               bound_ms=bms, bound_by=by, library_ms=None, stage=stage, plan=plan)
    if kind == "f32":
        rec.update(res2_tf32_route(x, ops, params, flops, nbytes, rel_max))
    return rec


def res2_tf32_route(x, ops, params, flops, nbytes, rel_max):
    """The f32 block on the TF32 tensor cores (3xTF32): the built kernels
    (ptxas: no spill or stack frame; SASS: TF32 HGMMA / HMMA), both bounds
    (3xTF32, and the same work as f32 FMAs), the two 1x1 products alone in
    true f32 (a yardstick), and the FMA route (built in build/smoke/), held
    to the plain version, against the port in A B B A turns at B = 64 and
    8 with each route's device time by launch."""
    import torch
    from diart_tpu_torch.ops import _numerics, se_res2

    build = check_tf32_build("se_res2")
    (bms, by), (fma_bms, fma_by) = tf32_bounds(nbytes, flops)
    w1, w2 = params[0], params[8]
    with _numerics.true_f32(x.device):
        product_ms = time_ms(lambda: (torch.matmul(x, w1), torch.matmul(x, w2)), 20)
    want = se_res2.se_res2_block_reference(x, *params, 2)
    fma_err = (res2_fma_block(x, ops, 2) - want).abs().max().item()
    fma_tol = rel_max * max(want.abs().max().item(), 1.0)
    if not fma_err <= fma_tol:
        raise AssertionError(f"se_res2's FMA route [f32] disagrees with the plain version: {fma_err} > {fma_tol}")
    turns = {}
    for batch in (B, 8):
        xb = x[:batch].contiguous()
        a, b = abba(lambda: time_ms(lambda: res2_fma_block(xb, ops, 2), 20),
                    lambda: time_ms(lambda: se_res2.fused_se_res2_block(xb, None, 2, operands=ops), 20))
        turns[f"B{batch}"] = dict(ms=float(np.mean(b)), ms_turns=b, ms_fma=float(np.mean(a)), ms_fma_turns=a)
        log(f"se_res2[f32] B={batch} A B B A (A: the FMA route, B: the TF32 tensor cores), ms: "
            f"{a[0]:.4f} {b[0]:.4f} {b[1]:.4f} {a[1]:.4f}")
    fma_rows = device_times(lambda: res2_fma_block(x, ops, 2), "the SE-Res2Block's FMA route")
    log(f"  se_res2[f32] the FMA route's device ms by launch: "
        + ", ".join(f"{name} {ms_:.4f} x{n:g}" for name, ms_, n in fma_rows)
        + f"; its max_abs_err {fma_err:.3e}. Bounds: 3xTF32 {bms:.5f} ms ({by}), the same work as f32 FMAs "
        f"{fma_bms:.5f} ms ({fma_by}); the two 1x1 products alone (torch.matmul, true f32) {product_ms:.4f} ms")
    return dict(bound_ms=bms, bound_by=by, bound_ms_f32_fma=fma_bms, product_library_ms=product_ms, abba=turns,
                fma_max_abs_err=fma_err, fma_by_launch=[dict(name=n, ms=m, per_block=c) for n, m, c in fma_rows],
                build=build)


# --------------------------------------------------------------------- #
def make_audio(rng, hops, batch, step):
    """int16 PCM: noise bursts of per-stream loudness, so windows differ."""
    t = np.arange(hops * step) / 16000.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (0.2 + 0.05 * np.arange(batch))[:, None] * t[None, :])
    sig = rng.normal(size=(batch, hops * step)) * env * 4000
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    return pcm.reshape(batch, hops, step).transpose(1, 0, 2).copy()  # (hops, B, step)


EMBEDDINGS = {"xvector": "tpu/xvector", "ecapa": "tpu/ecapa"}


def build_engine(device, batch, emb="xvector", seg_dtype="f32", emb_dtype="bf16", precision=None, mesh=None):
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    seg = SegmentationModel.from_registry("tpu/pyannet", device=device, seed=0, dtype=seg_dtype)
    model = EmbeddingModel.from_registry(EMBEDDINGS[emb], device=device, seed=1, dtype=emb_dtype)
    return MultiStreamEngine(
        seg, model, duration=5.0, step=0.5, latency=0.5, sample_rate=16000,
        max_speakers=20, batch_size=batch, precision=precision, mesh=mesh,
    )


def launch_counters() -> dict:
    """Each kernel's wrapper, which counts its launches."""
    from diart_tpu_torch.ops import attn_stats, linear_stats, lstm_sweep, resnet_conv, se_res2

    return {
        "lstm_sweep": lstm_sweep.lstm_sweep_tm,
        "lstm_sweep_bwd": lstm_sweep.lstm_sweep_backward,
        "linear_stats": linear_stats.fused_linear_stats,
        "attn_stats": attn_stats.fused_attentive_stats,
        "se_res2": se_res2.fused_se_res2_block,
        "se_res2_staged": se_res2.se_res2_staged,
        "resnet_conv": resnet_conv.resnet_conv,
    }


def path_launches(kind, lstm_layers: int) -> dict:
    """Each counted kernel's launches in one step or pipeline call of the
    path ``kind`` (``xvector``, ``ecapa`` or ``vad``)."""
    return {"lstm_sweep": lstm_layers, "lstm_sweep_bwd": 0, "linear_stats": int(kind == "xvector"),
            "attn_stats": int(kind == "ecapa"), "se_res2": 3 * int(kind == "ecapa"),
            "se_res2_staged": 0, "resnet_conv": 0}


def device_summary(prof, steps: int, top: int = 12) -> dict:
    """Device busy ms, device launches (kernels, copies, fills) per step and
    the ``top`` device items by time per step, from a profile."""
    import torch

    items = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        items.append((us / 1e3 / steps, e.count / steps, e.key))
    items.sort(reverse=True)
    return dict(device_busy_ms=sum(ms for ms, _, _ in items),
                kernels_per_step=sum(n for _, n, _ in items),
                top_device_items=[dict(ms_per_step=ms, per_step=n, name=k[:90]) for ms, n, k in items[:top]])


def drive_engine(emb, audio, out_dir):
    """The full-width engine with embedding ``emb`` for B streams: 14 hops
    with warm-up, a paused stream and a slot reset, the launch counts of
    every kernel over them, then the steady-state step time and a profile."""
    import torch

    engine = build_engine("cuda", B, emb)
    blocks = torch.from_numpy(audio).cuda()  # staged on the device, as a server would
    state = engine.init_state()
    paused, reset_slot = 3, 5

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = []
    for i in range(HOPS):
        audio_mask = np.ones(B, bool)
        run_mask = np.full(B, i + 1 >= WARMUP_HOPS)
        if i == HOPS - 2:
            audio_mask[paused] = run_mask[paused] = False
        if i == HOPS - 1:
            run_mask[reset_slot] = False  # the reset slot warms up again
        state, out = engine.step(state, blocks[i], audio_mask=audio_mask, run_mask=run_mask)
        outs.append(out)
        if i == HOPS - 2:
            state = engine.reset_stream(state, reset_slot)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    per_hop = path_launches(emb, engine._seg.module.lstm.num_layers)
    log(f"engine[{emb}]: {HOPS} hops x {B} streams, launches {launches}"
        f"{', frame ring' if engine._fring is not None else ''}")
    if launches != {k: v * HOPS for k, v in per_hop.items()}:
        raise AssertionError(f"engine[{emb}]: expected {per_hop} launches per hop; got {launches}")
    if (engine._fring is None) != (emb == "xvector"):
        raise AssertionError(f"engine[{emb}]: the mel frame ring is engaged only for mel models")

    last = outs[-1]
    num_out = engine.geometry.num_out
    assert last.aggregated.shape == (B, num_out, 20), last.aggregated.shape
    assert last.newest.shape == (B, engine.num_frames, 20), last.newest.shape
    for o in outs:
        assert torch.isfinite(o.aggregated).all() and torch.isfinite(o.newest).all()
    idx = last.chunk_index.cpu().numpy()
    running = HOPS - WARMUP_HOPS + 1
    assert idx[0] == running - 1 and idx[paused] == running - 2 and idx[reset_slot] == -1, idx
    assert not bool(state.initialized[reset_slot]) and int(state.chunk_count[reset_slot]) == 0
    active = state.center_active.sum(dim=1).float().mean().item()
    log(f"engine[{emb}] outputs ok: aggregated {tuple(last.aggregated.shape)}, chunk_index[0..6]="
        f"{idx[:7].tolist()}, mean active centres per stream {active:.2f}")

    # steady-state step time (all streams running), host clock + synchronize
    times = []
    for i in range(20):
        t0 = time.perf_counter()
        state, out = engine.step(state, blocks[HOPS + i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times[5:]))
    log(f"engine[{emb}] step at B={B}: median {step_ms:.3f} ms over {len(times) - 5} steps "
        f"(min {min(times[5:]):.3f}, max {max(times[5:]):.3f})")

    run = dict(launches=launches, step_ms=step_ms, step_ms_all=times, active_centres=active)
    profile = None
    try:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(5):
                state, out = engine.step(state, blocks[HOPS + i])
            torch.cuda.synchronize()
        profile = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
        run.update(device_summary(prof, 5))
        log(f"engine[{emb}] profile of 5 steps: device busy {run['device_busy_ms']:.3f} ms/step, "
            f"{run['kernels_per_step']:.0f} device launches/step; top device items per step:")
        for item in run["top_device_items"]:
            log(f"  {item['ms_per_step']:8.3f} ms  x{item['per_step']:6.1f}  {item['name']}")
        if out_dir:
            prof.export_chrome_trace(os.path.join(out_dir, f"engine_step_trace_{emb}.json"))
            with open(os.path.join(out_dir, f"engine_step_profile_{emb}.txt"), "w") as f:
                f.write(profile)
    except Exception as exc:  # diagnostic only
        log(f"profiler unavailable: {type(exc).__name__}: {exc}")
    return run


def engine_outputs(path):
    """Each engine's aggregated and newest scores over HOPS hops of phase 3's
    seeded audio at B=64 (f32 on the host), written to ``path`` (npz)."""
    import torch

    arrays = {}
    for emb in ("xvector", "ecapa"):
        engine = build_engine("cuda", B, emb)
        audio = make_audio(np.random.default_rng(0), HOPS, B, 8000)
        state = engine.init_state()
        for i in range(HOPS):
            state, out = engine.step(state, audio[i], run_mask=np.full(B, i + 1 >= WARMUP_HOPS))
            arrays[f"{emb}_aggregated_{i}"] = out.aggregated.float().cpu().numpy()
            arrays[f"{emb}_newest_{i}"] = out.newest.float().cpu().numpy()
        del engine
        torch.cuda.empty_cache()
    np.savez(path, **arrays)
    log(f"wrote {len(arrays)} arrays to {path}")


def compare_outputs(a, b) -> bool:
    """Two ``engine_outputs`` files bitwise: the same arrays, equal bits."""
    x, y = np.load(a), np.load(b)
    differ = {k: float(np.abs(x[k] - y[k]).max()) if k in y.files else "missing" for k in x.files
              if k not in y.files or not np.array_equal(x[k], y[k])}
    same = sorted(x.files) == sorted(y.files) and not differ
    log(f"engine outputs {a} against {b}: {len(x.files) - len(differ)} of {len(x.files)} arrays bitwise equal "
        f"({len(y.files)} in the second); differing: {differ or 'none'}")
    return same


def compare_cpu(emb, audio, which=("f32", "serving"), strict=True):
    """The engine with embedding ``emb`` for 2 streams on the card against
    the same engine on the CPU (the kernels' plain versions): the frame
    scores that ``probe_frame_scores`` gives after 10 hops, in f32 and in
    the serving configuration, and 12 f32 hops with clustering active.
    ``which``: the cases to run. With ``strict`` off a disagreement is
    recorded (``failures``) instead of raised."""
    import torch
    from diart_tpu_torch.precision import Precision

    results, failures = {}, []
    cases = [
        # f32 everywhere: the kernels' f32 paths against plain f32 on the CPU
        ("f32", dict(seg_dtype="f32", emb_dtype="f32",
                     precision=Precision(bf16_lstm=False, bf16_frontend=False)), 1e-4, 1e-3),
        # the serving configuration: bf16 LSTM stream, bf16 pre-pool frontend
        # and bf16 embedding trunk on the card; the CPU runs f32 LSTM and
        # frontend (the bf16 switches are CUDA-only) with the bf16 trunk.
        # Both limits sit ~5-10x above the readings on an H100 (seg 9.3e-5,
        # embeddings 1.5e-4 ECAPA / 2.1e-4 x-vector), far below the ~0.07
        # of one element of a unit-norm 192-d embedding
        ("serving", dict(), 1e-3, 1e-3),
    ]
    hops, agg_tol = 12, 1e-3
    cases = [c for c in cases if c[0] in which]
    for name, kw, seg_tol, emb_tol in cases:
        probes, aggs, centres = [], [], []
        steps = hops if name == "f32" else WARMUP_HOPS
        for device in ("cuda", "cpu"):
            engine = build_engine(device, 2, emb, **kw)
            # thresholds low enough that the random models' ~0.5 activations
            # map speakers, so assignment and centroid updates run
            engine.set_hyperparameters(tau_active=0.45, rho_update=0.05)
            state, seq = engine.init_state(), []
            for i in range(steps + 1):
                if i == WARMUP_HOPS:
                    seg, e = engine.probe_frame_scores(state, audio[i, :2])
                    probes.append((seg.float().cpu(), e.float().cpu()))
                if i == steps:
                    break
                state, out = engine.step(state, audio[i, :2], run_mask=np.full(2, i + 1 >= WARMUP_HOPS))
                seq.append(out.aggregated.float().cpu())
            aggs.append(torch.stack(seq))
            centres.append(state.center_active.sum().item())
        (sg, eg), (sc, ec) = probes
        seg_err = (sg - sc).abs().max().item()
        emb_err = (eg - ec).abs().max().item()
        log(f"probe vs CPU [{emb}, {name}]: seg {tuple(sg.shape)} max_abs_err={seg_err:.3e} "
            f"(tol {seg_tol:.0e}), emb {tuple(eg.shape)} max_abs_err={emb_err:.3e} (tol {emb_tol:.0e})")
        if not (torch.isfinite(sg).all() and torch.isfinite(eg).all()):
            raise AssertionError(f"probe [{emb}, {name}] produced non-finite values")
        if not (seg_err <= seg_tol and emb_err <= emb_tol):
            failures.append(f"probe [{emb}, {name}] disagrees with the CPU engine")
        results[name] = dict(seg_err=seg_err, seg_tol=seg_tol, emb_err=emb_err, emb_tol=emb_tol)
        if name != "f32":
            continue
        agg_err = (aggs[0] - aggs[1]).abs().max().item()
        log(f"steps vs CPU [{emb}, f32, {hops} hops, 2 streams]: aggregated max_abs_err={agg_err:.3e} "
            f"(tol {agg_tol:.0e}); active centres card/CPU {centres[0]}/{centres[1]}")
        if not (agg_err <= agg_tol and centres[0] == centres[1] and centres[0] > 0):
            failures.append(f"engine[{emb}] steps on the card disagree with the CPU engine")
        results["steps_f32"] = dict(agg_err=agg_err, tol=agg_tol, active_centres=centres[0],
                                    active_centres_cpu=centres[1])
    if failures and strict:
        raise AssertionError("; ".join(failures))
    return dict(results, failures=failures) if failures else results


# --------------------------------------------------------------------- #
SESSION_TAU = 0.45  # the random models' ~0.5 activations then make turns
SESSION_HOPS, SESSION_PAUSED, SESSION_RESET = 24, 3, 5
COHORTS, COHORT_PERIODS = 4, 4


def counting_steps(engine):
    """Wrap ``engine.step`` to count its calls; returns the counter."""
    calls = [0]
    step = engine.step

    def counted(*args, **kwargs):
        calls[0] += 1
        return step(*args, **kwargs)

    engine.step = counted
    return calls


class no_host_sync:
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block: any
    call that waits for the card raises there."""

    def __enter__(self):
        import torch

        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        return False


def copy_timing(engine, state, blocks, reps=25):
    """Host ms of one hop's numpy int16 blocks copied to the card (median
    and largest of ``reps``), with the card idle and right after a step was
    queued (a pageable copy then waits for that step's tail on the card):
    ``pageable`` ``.to(device)``; ``pin_memory`` ``Tensor.pin_memory()``
    then ``.to(device, non_blocking=True)``; ``staged`` the engine's route
    (a host copy into ``torch.empty(pin_memory=True)``, then the same)."""
    import torch

    dev = engine.device

    def staged():
        t = torch.empty(blocks.shape, dtype=torch.int16, pin_memory=True)
        np.copyto(t.numpy(), blocks)
        return t.to(dev, non_blocking=True)

    ways = {"pageable": lambda: torch.from_numpy(blocks).to(dev),
            "pin_memory": lambda: torch.from_numpy(blocks).pin_memory().to(dev, non_blocking=True),
            "staged": staged}
    res = {}
    for name, copy in ways.items():
        for queue in ("idle", "after_step"):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                if queue == "after_step":
                    state, _ = engine.step(state, blocks)
                t0 = time.perf_counter()
                copy()
                times.append((time.perf_counter() - t0) * 1e3)
            res[f"{name}_{queue}_ms"] = float(np.median(times))
            res[f"{name}_{queue}_max_ms"] = max(times)
    torch.cuda.synchronize()
    return res


def input_variants(engine, state, audio, rounds=2, steps=30):
    """The step's dispatch (host ms of the call) and wall per step, back to
    back, by how its inputs arrive, the variants taking turns in each round:
    ``host`` numpy blocks and masks (the engine's own copies); ``drained``
    the same after ``torch.cuda.synchronize()`` (outside the dispatch time;
    the card is idle when the step is queued); ``pageable`` tensors copied
    by ``.to(device)`` in the call (they wait for the card, as the engine's
    copies once did); ``device`` blocks and masks already on the card (no
    copies at all)."""
    import torch

    b, hops, dev = audio.shape[1], audio.shape[0], engine.device
    ones = np.ones(b, bool)
    staged = torch.from_numpy(audio).to(dev)
    dones = torch.ones(b, dtype=torch.bool, device=dev)
    inputs = {
        "host": lambda i: (audio[i % hops], ones, ones),
        "drained": lambda i: (audio[i % hops], ones, ones),
        "pageable": lambda i: tuple(torch.from_numpy(a).to(dev) for a in (audio[i % hops], ones, ones)),
        "device": lambda i: (staged[i % hops], dones, dones),
    }
    dispatch = {k: [] for k in inputs}
    wall = {k: [] for k in inputs}
    for r in range(rounds):
        for name, make in inputs.items():
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            for i in range(steps):
                if name == "drained":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = engine.step(state, *make(r + i))
                dispatch[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            wall[name].append((time.perf_counter() - t_start) * 1e3 / steps)
    return {k: dict(dispatch_ms=float(np.median(dispatch[k])), wall_ms=float(np.median(wall[k])),
                    wall_rounds_ms=wall[k]) for k in inputs}


def step_timing(engine, audio, tag="", light=False):
    """The step with host inputs, as a server feeds it (numpy int16 blocks
    and numpy masks): first one step under the sync check (it raises on a
    tree whose step waits for the card; recorded, not fatal here); then 3
    rounds of 30 steps back to back: the host time of each call (dispatch,
    median of the calls) and the wall per step to each round's last step's
    end (median of the rounds); 20 steps each waited for; the device busy
    time of 5 back-to-back steps from a profile; and the copy of one hop's
    blocks, pageable against pinned (:func:`copy_timing`). ``light`` leaves
    out the copies and the input routes."""
    import torch

    b = audio.shape[1]
    ones = np.ones(b, bool)
    state = engine.init_state()
    for i in range(WARMUP_HOPS + 1):
        state, _ = engine.step(state, audio[i], ones, np.full(b, i + 1 >= WARMUP_HOPS))
    torch.cuda.synchronize()
    sync_check = "no host sync"
    try:
        with no_host_sync():
            state, _ = engine.step(state, audio[WARMUP_HOPS + 1], ones, ones)
            state = engine.reset_streams(state, np.zeros(b, bool))
        torch.cuda.synchronize()
    except RuntimeError as exc:
        import traceback

        frames = [f for f in traceback.extract_tb(exc.__traceback__) if "diart_tpu_torch" in f.filename]
        where = f"{frames[-1].filename.split('diart_tpu_torch/')[-1]}:{frames[-1].lineno}" if frames else "?"
        sync_check = f"raised {type(exc).__name__}: {exc} (at diart_tpu_torch/{where})"
        torch.cuda.synchronize()
    hops = audio.shape[0]
    dispatch, rounds = [], []
    for r in range(3):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i in range(30):
            t0 = time.perf_counter()
            state, out = engine.step(state, audio[(r + i) % hops], ones, ones)
            dispatch.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t_start) * 1e3 / 30)
    back_to_back_ms = float(np.median(rounds))
    waited = []
    for i in range(20):
        t0 = time.perf_counter()
        state, out = engine.step(state, audio[i % hops], ones, ones)
        torch.cuda.synchronize()
        waited.append((time.perf_counter() - t0) * 1e3)
    res = dict(sync_check=sync_check, dispatch_ms=float(np.median(dispatch)),
               back_to_back_wall_ms=back_to_back_ms, back_to_back_rounds_ms=rounds,
               waited_wall_ms=float(np.median(waited[5:])), dispatch_ms_all=dispatch,
               waited_ms_all=waited)
    try:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(5):
                state, out = engine.step(state, audio[i % hops], ones, ones)
            torch.cuda.synchronize()
        res.update(device_summary(prof, 5))
        res["idle_share"] = 1.0 - res["device_busy_ms"] / back_to_back_ms
    except Exception as exc:  # diagnostic only
        log(f"profiler unavailable: {type(exc).__name__}: {exc}")
    if light:
        return res
    res["copy"] = copy_timing(engine, state, audio[0])
    res["inputs"] = input_variants(engine, state, audio)
    log(f"step timing[{tag}] B={b}, numpy int16 blocks and numpy masks: sync check: {sync_check}; "
        f"dispatch {res['dispatch_ms']:.3f} ms/step (host time of the call, median of 90), "
        f"back-to-back wall {back_to_back_ms:.3f} ms/step (median of 3 rounds of 30: "
        + ", ".join(f"{x:.3f}" for x in rounds) + f"), waited-for wall "
        f"{res['waited_wall_ms']:.3f} ms/step (median of 15); device busy "
        f"{res.get('device_busy_ms', float('nan')):.3f} ms/step, "
        f"{res.get('kernels_per_step', float('nan')):.0f} device launches/step, idle share of the "
        f"back-to-back wall {res.get('idle_share', float('nan')):.3f}; host ms of one hop's blocks "
        f"to the card (median, max of 25): " + ", ".join(
            f"{k[:-3]} {v:.3f}, {res['copy'][k[:-3] + '_max_ms']:.3f}"
            for k, v in res["copy"].items() if not k.endswith("_max_ms")))
    log(f"step timing[{tag}] by input route, dispatch / wall ms a step (2 rounds of 30, taking turns): "
        + "; ".join(f"{k} {v['dispatch_ms']:.3f} / {v['wall_ms']:.3f}" for k, v in res["inputs"].items()))
    return res


def drive_session(emb, audio, out_dir):
    """The serving path at B streams on the full-width engine: five
    sessions on one engine over SESSION_HOPS hops of numpy int16 blocks, with
    warm-up, a paused stream and a slot reset. Every push_begin (and the
    steps it queues) runs under the sync check. At every hop the card's
    packed bits equal the host's packbits of the same hop's scores, and the
    native bits route, the scores route, the numpy routes called by name and
    the annotation route give identical text; two hops in flight with a
    reset between a dispatch and its harvest give the synchronous text; a
    checkpoint saved halfway and restored into a fresh session continues
    with the uninterrupted text."""
    import tempfile

    import torch
    from diart_tpu_torch import MultiStreamSession, native
    from diart_tpu_torch.ops.binarize import batch_binarize_rttm, batch_bits_rttm

    engine = build_engine("cuda", B, emb)
    engine.set_hyperparameters(tau_active=SESSION_TAU, rho_update=0.05)
    steps = counting_steps(engine)
    kw = dict(tau_active=SESSION_TAU, collect_audio=False)
    bits_s = MultiStreamSession(engine, **kw)
    scores_s = MultiStreamSession(engine, binarize_on_device=False, **kw)
    ann_s = MultiStreamSession(engine, **kw)
    pipe_s = MultiStreamSession(engine, **kw)
    ckpt_s = MultiStreamSession(engine, **kw)
    bits_s.warm()
    torch.cuda.synchronize()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    steps[0] = 0
    geo, half = engine.geometry, SESSION_HOPS // 2
    res, speakers = geo.out_resolution, 20
    timings = {k: [] for k in ("dispatch", "harvest", "scores_dispatch", "scores_harvest",
                               "native_bits", "numpy_bits", "native_scores", "numpy_scores")}
    fetch_bytes = {}
    sync_texts, pipe_texts, ckpt_texts, inflight, lines, first_rows_seen = [], [], [], [], 0, 0
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=scratch)  # inside the checkout
    for i in range(SESSION_HOPS):
        present = np.ones(B, bool)
        if i == half + 3:
            present[SESSION_PAUSED] = False
        blk = audio[i]
        # the bits route, synchronous: dispatch and harvest timed apart
        with no_host_sync():
            t0 = time.perf_counter()
            pending = bits_s.push_begin(blk, present)
            t1 = time.perf_counter()
            s_pending = scores_s.push_begin(blk, present)
            t2 = time.perf_counter()
            a_pending = ann_s.push_begin(blk, present, rttm=False)
            p_pending = pipe_s.push_begin(blk, present)
            c_pending = ckpt_s.push_begin(blk, present)
        if pending is None:
            assert s_pending is None and a_pending is None and p_pending is None and c_pending is None
            texts = [None] * B
        else:
            t3 = time.perf_counter()
            texts = bits_s.push_finish_rttm(pending)
            t4 = time.perf_counter()
            s_texts = scores_s.push_finish_rttm(s_pending)
            t5 = time.perf_counter()
            a_texts = [None if o is None else o[0].to_rttm() for o in ann_s.push_finish(a_pending)]
            run, chunk = pending.run_mask, pending.chunk_index
            steady = np.flatnonzero(run & (chunk > 0))
            first_rows_seen += int((run & (chunk == 0)).sum())
            bits = np.concatenate([t.numpy() for t in pending.fetch[0]])  # one piece a shard
            scores = pending.device_aggregated.cpu().numpy()
            host = np.packbits((scores > np.float32(SESSION_TAU)).reshape(B, -1), axis=1)
            if not np.array_equal(bits, host):
                raise AssertionError(f"session[{emb}] hop {i}: the card's packed bits differ from "
                                     f"the host's packbits of the same scores")
            if s_texts != texts or a_texts != texts:
                raise AssertionError(f"session[{emb}] hop {i}: the scores route or the annotation "
                                     "route differs from the native bits route")
            if any(texts[k] is None for k in np.flatnonzero(run)) or any(
                    texts[k] is not None for k in np.flatnonzero(~run)):
                raise AssertionError(f"session[{emb}] hop {i}: text missing for a running stream")
            if steady.size:
                starts = (chunk * engine.step_duration + engine.duration - engine.latency
                          + np.asarray(pending.shifts))
                uris = [pending.uris[k] for k in steady]
                t6 = time.perf_counter()
                native_bits = native.rttm_from_bits(bits, geo.num_out, speakers, starts, res,
                                                    pending.uris, emit=run & (chunk > 0))
                t7 = time.perf_counter()
                numpy_bits = batch_bits_rttm(bits[steady], geo.num_out, speakers, starts[steady], res, uris)
                t8 = time.perf_counter()
                native_scores = native.rttm_from_scores(scores, starts, res, SESSION_TAU, pending.uris,
                                                        emit=run & (chunk > 0))
                t9 = time.perf_counter()
                numpy_scores = batch_binarize_rttm(scores[steady], starts[steady], res, SESSION_TAU, uris)
                t10 = time.perf_counter()
                want = [texts[k] for k in steady]
                for name, got in (("native bits", [native_bits[k] for k in steady]), ("numpy bits", numpy_bits),
                                  ("native scores", [native_scores[k] for k in steady]),
                                  ("numpy scores", numpy_scores)):
                    if got != want:
                        raise AssertionError(f"session[{emb}] hop {i}: the {name} route differs")
                if not (run & (chunk == 0)).any():
                    for key, dt in (("dispatch", t1 - t0), ("harvest", t4 - t3),
                                    ("scores_dispatch", t2 - t1), ("scores_harvest", t5 - t4),
                                    ("native_bits", t7 - t6), ("numpy_bits", t8 - t7),
                                    ("native_scores", t9 - t8), ("numpy_scores", t10 - t9)):
                        timings[key].append(dt * 1e3)
                    fetch_bytes = dict(
                        bits=sum(t.numel() * t.element_size() for g in pending.fetch for t in g),
                        scores=sum(t.numel() * t.element_size() for g in s_pending.fetch for t in g))
            lines += sum(t.count("\n") for t in texts if t)
        sync_texts.append(texts)
        # two hops in flight; the reset lands between a dispatch and its harvest
        if p_pending is not None:
            inflight.append(p_pending)
        if i == half - 1:
            for s in (bits_s, scores_s, ann_s, pipe_s, ckpt_s):
                s.reset_slot(SESSION_RESET, uri="fresh", shift=1.5)
        while len(inflight) > 2:
            pipe_texts.append(pipe_s.push_finish_rttm(inflight.pop(0)))
        if c_pending is not None:
            ckpt_texts.append(ckpt_s.push_finish_rttm(c_pending))
        if i == half - 1:
            path = os.path.join(tmp.name, "session.pt")
            ckpt_s.save(path)
            ckpt_s = MultiStreamSession(engine, **kw)
            ckpt_s.restore(path)
    while inflight:
        pipe_texts.append(pipe_s.push_finish_rttm(inflight.pop(0)))
    torch.cuda.synchronize()
    tmp.cleanup()
    launches = {k: fn.launches for k, fn in counters.items()}
    emitted = [t for t in sync_texts if any(x is not None for x in t)]
    if pipe_texts != emitted:
        raise AssertionError(f"session[{emb}]: the pipelined run differs from the synchronous one")
    if ckpt_texts != emitted:
        raise AssertionError(f"session[{emb}]: the restored checkpoint's text differs")
    if not lines or not first_rows_seen or not any("fresh" in (t[SESSION_RESET] or "") for t in emitted):
        raise AssertionError(f"session[{emb}]: no turns, no first-chunk rows or no text after the reset")
    per_step = path_launches(emb, engine._seg.module.lstm.num_layers)
    if launches != {k: v * steps[0] for k, v in per_step.items()}:
        raise AssertionError(f"session[{emb}]: {steps[0]} steps, expected {per_step} launches a step; "
                             f"got {launches}")
    med = {k: float(np.median(v)) for k, v in timings.items()}
    log(f"session[{emb}] B={B}, {SESSION_HOPS} hops x 5 sessions ({steps[0]} steps): no host sync in "
        f"push_begin; bits equal the host's packbits at every hop; native bits / scores / numpy / "
        f"annotation routes identical; pipelined (2 in flight, reset between) == synchronous; checkpoint "
        f"round trip == uninterrupted; {lines} RTTM lines, {first_rows_seen} first-chunk rows; "
        f"launches {launches}")
    log(f"session[{emb}] per steady hop (median of {len(timings['dispatch'])}): push_rttm bits route "
        f"{med['dispatch'] + med['harvest']:.3f} ms = dispatch {med['dispatch']:.3f} + harvest "
        f"{med['harvest']:.3f}; scores route dispatch {med['scores_dispatch']:.3f} + harvest "
        f"{med['scores_harvest']:.3f}; RTTM assembly host ms: native bits {med['native_bits']:.3f} vs "
        f"numpy {med['numpy_bits']:.3f}, native scores {med['native_scores']:.3f} vs numpy "
        f"{med['numpy_scores']:.3f}; device-to-host bytes per hop: bits {fetch_bytes['bits']} vs "
        f"scores {fetch_bytes['scores']}")
    return dict(steps=steps[0], launches=launches, rttm_lines=lines, first_chunk_rows=first_rows_seen,
                median_ms=med, all_ms=timings, fetch_bytes_per_hop=fetch_bytes)


def drive_cohorts(emb, audio):
    """CohortScheduler: K cohorts of B streams on one engine, pipelined, for
    COHORT_PERIODS periods of real time after ``prime``. Every (cohort,
    period) hop must be harvested with text for every stream; lateness,
    reply latency and late hops are a record, not a gate."""
    from diart_tpu_torch import CohortScheduler

    engine = build_engine("cuda", B, emb)
    engine.set_hyperparameters(tau_active=SESSION_TAU, rho_update=0.05)
    present = np.ones(B, bool)
    hops = audio.shape[0]

    def get_blocks(j, k):
        return audio[(k + 3 * j) % hops], present

    scheduler = CohortScheduler(engine, cohorts=COHORTS, tau_active=SESSION_TAU)
    scheduler.warm()
    scheduler.prime(get_blocks)
    warm = scheduler.sessions[0].warmup_blocks
    seen = {}

    def on_outputs(j, p, outs):
        seen[(j, p)] = all(isinstance(o, str) for o in outs)

    t0 = time.perf_counter()
    timings = scheduler.run(lambda j, p: get_blocks(j, p + warm), periods=COHORT_PERIODS,
                            pipelined=True, on_outputs=on_outputs)
    wall = time.perf_counter() - t0
    want = {(j, p) for j in range(COHORTS) for p in range(COHORT_PERIODS)}
    if set(seen) != want or not all(seen.values()) or len(timings) != len(want):
        raise AssertionError(f"cohorts[{emb}]: {len(seen)} of {len(want)} hops harvested with text "
                             f"for every stream")
    step = engine.step_duration
    late = [(t.dispatched - t.due) * 1e3 for t in timings]
    reply = [(t.done - t.due) * 1e3 for t in timings]
    pct = lambda v, q: float(np.percentile(v, q))
    rec = dict(cohorts=COHORTS, batch=B, periods=COHORT_PERIODS, wall_s=wall,
               dispatch_lateness_ms=dict(p50=pct(late, 50), p99=pct(late, 99), max=max(late)),
               reply_latency_ms=dict(p50=pct(reply, 50), p99=pct(reply, 99), max=max(reply)),
               late_hops=sum(r > step * 1e3 for r in reply), hops=len(timings))
    log(f"cohorts[{emb}] K={COHORTS} x B={B} = {scheduler.capacity} streams, pipelined, "
        f"{COHORT_PERIODS} periods ({wall:.2f} s): all {len(timings)} hops harvested with text for every "
        f"stream; dispatch lateness p50 {rec['dispatch_lateness_ms']['p50']:.3f} ms p99 "
        f"{rec['dispatch_lateness_ms']['p99']:.3f} ms; reply latency (done - due) p50 "
        f"{rec['reply_latency_ms']['p50']:.3f} ms p99 {rec['reply_latency_ms']['p99']:.3f} ms; "
        f"late hops (reply after a step) {rec['late_hops']}")
    return rec


# --------------------------------------------------------------------- #
PIPELINES = ("xvector", "ecapa", "vad")
PIPE_CHUNKS, PIPE_BATCH, PIPE_CPU_CHUNKS = 51, 8, 6  # ~30 s of one stream


def pipeline_chunks(pcm: np.ndarray, sample_rate: int = 16000, duration: float = 5.0,
                    step: float = 0.5):
    """One stream's int16 PCM -> the chunks diart's runtime feeds a
    pipeline: (samples, 1) float32 on a 1 / sample_rate sliding window."""
    from diart_tpu_torch.core.segment import SlidingWindow, SlidingWindowFeature

    wave = pcm.astype(np.float32) / 32768.0
    win, hop = int(duration * sample_rate), int(step * sample_rate)
    res = 1.0 / sample_rate
    return [SlidingWindowFeature(wave[k * hop : k * hop + win, None].copy(),
                                 SlidingWindow(start=k * hop / sample_rate, duration=res, step=res))
            for k in range((len(wave) - win) // hop + 1)]


def build_pipeline(kind, device, seg_dtype="f32", emb_dtype="bf16", **kw):
    """The full-width pipeline ``kind`` (x-vector or ECAPA diarization, or
    VAD) at the JAX package's defaults (5 s / 0.5 s, latency 0.5 s, delta 1,
    20 speakers) but the session phase's thresholds (tau 0.45, and rho 0.05
    for diarization), low enough that the random models' ~0.5 activations
    make turns (``drive_pipeline`` logs the largest score of its run).
    ``kw`` adds to or overrides the configuration."""
    from diart_tpu_torch import EmbeddingModel, SegmentationModel
    from diart_tpu_torch.blocks import (SpeakerDiarization, SpeakerDiarizationConfig,
                                        VoiceActivityDetection, VoiceActivityDetectionConfig)

    seg = SegmentationModel.from_registry("tpu/pyannet", device=device, seed=0, dtype=seg_dtype)
    kw = {"tau_active": SESSION_TAU, **({} if kind == "vad" else {"rho_update": 0.05}), **kw}
    if kind == "vad":
        return VoiceActivityDetection(VoiceActivityDetectionConfig(segmentation=seg, **kw))
    emb = EmbeddingModel.from_registry(EMBEDDINGS[kind], device=device, seed=1, dtype=emb_dtype)
    return SpeakerDiarization(SpeakerDiarizationConfig(segmentation=seg, embedding=emb, **kw))


def drive_pipeline(kind, chunks, out_dir):
    """One stream's chunks through the full-width pipeline on the card, in
    calls of 1 chunk and then, after ``reset()``, in calls of PIPE_BATCH:
    each call's dispatch under the sync check, each kernel of the path
    launched the expected number of times in every call (counts set to 0
    before the call and read after it), finite outputs, the same RTTM text
    from both runs. Then the ms per chunk of both call sizes and, from a
    profile, device busy and launches per call."""
    import torch

    pipe = build_pipeline(kind, "cuda")
    pipe(chunks[:1])  # builds the kernels and the device constants
    torch.cuda.synchronize()
    counters = launch_counters()
    per_call = path_launches(kind, pipe.config.segmentation.module.lstm.num_layers)
    totals = {k: 0 for k in counters}
    runs, walls, dispatches, top_score = {}, {}, {}, 0.0
    for batch in (1, PIPE_BATCH):
        pipe.reset()
        texts, wall, disp = [], [], []
        for i in range(0, len(chunks), batch):
            call = chunks[i : i + batch]
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with no_host_sync():
                scores = pipe.dispatch(call)
            t1 = time.perf_counter()
            outs = pipe.fetch(call, scores)
            t2 = time.perf_counter()
            launches = {k: fn.launches for k, fn in counters.items()}
            if launches != per_call:
                raise AssertionError(f"pipeline[{kind}] call at chunk {i} ({len(call)} chunks): expected "
                                     f"{per_call} launches; got {launches}")
            for k, n in launches.items():
                totals[k] += n
            if not bool(torch.isfinite(scores).all()):
                raise AssertionError(f"pipeline[{kind}] call at chunk {i}: non-finite scores")
            top_score = max(top_score, float(scores.max()))
            for ann, audio in outs:
                if not np.isfinite(audio.data).all():
                    raise AssertionError(f"pipeline[{kind}] call at chunk {i}: non-finite audio")
                texts.append(ann.to_rttm())
            if len(call) == batch:
                wall.append((t2 - t0) * 1e3)
                disp.append((t1 - t0) * 1e3)
        runs[batch], walls[batch], dispatches[batch] = texts, wall, disp
    if runs[1] != runs[PIPE_BATCH]:
        bad = next(k for k, (a, b) in enumerate(zip(runs[1], runs[PIPE_BATCH])) if a != b)
        raise AssertionError(f"pipeline[{kind}]: calls of {PIPE_BATCH} differ from calls of 1 at chunk {bad}")
    lines = sum(t.count("\n") for t in runs[1])
    if not lines:
        raise AssertionError(f"pipeline[{kind}]: no turns in {len(chunks)} chunks")
    rec = dict(chunks=len(chunks), rttm_lines=lines, launches_per_call=per_call, launches=totals,
               max_score=top_score)
    for batch in (1, PIPE_BATCH):
        steady = walls[batch][2:] if len(walls[batch]) > 4 else walls[batch]
        rec[f"b{batch}"] = dict(call_ms=float(np.median(steady)), ms_per_chunk=float(np.median(steady)) / batch,
                               dispatch_ms=float(np.median(dispatches[batch][-len(steady):])),
                               steady_calls=len(steady), call_ms_all=walls[batch])
    # device busy and launches per call from a profile of steady calls (after
    # a reset and two calls), and the idle share from the wall of those same
    # calls (the profiler's host work included, so the share is an upper one)
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for batch, calls in ((1, 5), (PIPE_BATCH, 2)):
        pipe.reset()
        for i in range(2):
            pipe(chunks[i * batch : (i + 1) * batch])
        prof_walls = []
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(2, 2 + calls):
                t0 = time.perf_counter()
                pipe(chunks[i * batch : (i + 1) * batch])  # fetch waits for the call's work
                prof_walls.append((time.perf_counter() - t0) * 1e3)
        summary = device_summary(prof, calls)
        profiled_ms = float(np.mean(prof_walls))
        rec[f"b{batch}"].update(
            device_busy_ms=summary["device_busy_ms"], device_launches=summary["kernels_per_step"],
            profiled_call_ms=profiled_ms, profiled_calls=calls,
            idle_share=1.0 - summary["device_busy_ms"] / profiled_ms,
            top_device_items=summary["top_device_items"][:6])
        if out_dir and batch == 1:  # the traces of 8-chunk calls run to ~17 MB each
            prof.export_chrome_trace(os.path.join(out_dir, f"pipeline_trace_{kind}_b{batch}.json"))
    log(f"pipeline[{kind}] {len(chunks)} chunks of one stream in calls of 1 and of {PIPE_BATCH}: identical "
        f"RTTM text ({lines} lines, largest score {top_score:.4f}), finite outputs, no host sync in any "
        f"dispatch, launches per call "
        f"{per_call} in every call (totals {totals})")
    for batch in (1, PIPE_BATCH):
        r = rec[f"b{batch}"]
        log(f"pipeline[{kind}] {batch} chunk(s) a call: {r['ms_per_chunk']:.3f} ms per chunk (call "
            f"{r['call_ms']:.3f} ms, dispatch {r['dispatch_ms']:.3f} ms, median of {r['steady_calls']}); "
            f"device busy {r['device_busy_ms']:.3f} ms a call and idle share {r['idle_share']:.3f} over "
            f"{r['profiled_calls']} profiled calls of {r['profiled_call_ms']:.3f} ms, "
            f"{r['device_launches']:.0f} device launches a call")
    return rec


def compare_pipeline_cpu(kind, chunks):
    """The pipeline on the card with f32 models and the bf16 switches off
    against the same pipeline on the CPU (the kernels' plain versions), over
    PIPE_CPU_CHUNKS chunks in one call, at thresholds that make the random
    models' ~0.5 activations map speakers: the permuted scores and the
    embeddings that the dispatch computed within compare_cpu's f32 limits,
    the same active centres.
    Whether the RTTM text is equal is a record: a score within the scores'
    limit of tau may flip a frame."""
    import torch
    from diart_tpu_torch import precision as precision_policy

    seg_tol, emb_tol = 1e-4, 1e-3
    call = chunks[:PIPE_CPU_CHUNKS]
    got = {}
    for device in ("cuda", "cpu"):
        pipe = build_pipeline(kind, device, emb_dtype="f32")
        seen = []  # the forward's (segmentation, embeddings) inside the dispatch
        if kind != "vad":
            forward = pipe._forward
            pipe._forward = lambda batch, forward=forward: seen.append(forward(batch)) or seen[-1]
        with precision_policy.use(precision_policy.Precision(bf16_lstm=False, bf16_frontend=False)):
            scores = pipe.dispatch(call)
            texts = [ann.to_rttm() for ann, _ in pipe.fetch(call, scores)]
        emb, active = None, None
        if kind != "vad":
            emb = seen[0][1].float().cpu()
            active = int(pipe.clustering_state.active.sum())
        got[device] = (scores.float().cpu(), emb, active, texts)
    (sg, eg, ag, tg), (sc, ec, ac, tc) = got["cuda"], got["cpu"]
    score_err = (sg - sc).abs().max().item()
    rec = dict(score_err=score_err, score_tol=seg_tol)
    msg = f"pipeline vs CPU [{kind}, f32, {PIPE_CPU_CHUNKS} chunks]: scores {tuple(sg.shape)} " \
          f"max_abs_err={score_err:.3e} (tol {seg_tol:.0e})"
    ok = score_err <= seg_tol
    if kind != "vad":
        emb_err = (eg - ec).abs().max().item()
        msg += f", embeddings {tuple(eg.shape)} max_abs_err={emb_err:.3e} (tol {emb_tol:.0e}), " \
               f"active centres card/CPU {ag}/{ac}"
        rec.update(emb_err=emb_err, emb_tol=emb_tol, active_centres=ag)
        ok = ok and emb_err <= emb_tol and ag == ac and ag > 0
    rec["rttm_equal"] = tg == tc
    log(msg + f", RTTM text {'equal' if tg == tc else 'different'} (a record)")
    if not (torch.isfinite(sg).all() and ok):
        raise AssertionError(f"pipeline[{kind}] on the card disagrees with the CPU pipeline")
    return rec


def check_session_tensor_blocks(audio):
    """The session repairs on the card: sessions fed CUDA tensor blocks, with
    ``collect_audio`` and ``quantize_transfer`` on, against the same
    sessions fed the numpy blocks: the same aggregated scores bit for bit
    (the float blocks are quantized on the card as numpy quantizes them on
    the host), RTTM text and audio regions at every hop."""
    import torch
    from diart_tpu_torch import MultiStreamSession

    batch = 4
    engine = build_engine("cuda", batch, "xvector")
    engine.set_hyperparameters(tau_active=SESSION_TAU, rho_update=0.05)
    kw = dict(tau_active=SESSION_TAU, collect_audio=True, quantize_transfer=True)
    host_s, card_s = MultiStreamSession(engine, **kw), MultiStreamSession(engine, **kw)
    float_blocks = audio[:, :batch].astype(np.float32) / 32768.0
    emitted = lines = 0
    for i, blk in enumerate(float_blocks):
        present = np.ones(batch, bool)
        if i == 12:
            present[1] = False
        got = card_s.push_begin(torch.from_numpy(blk).cuda(), present, rttm=False)
        want = host_s.push_begin(blk, present, rttm=False)
        if want is None:
            assert got is None
            continue
        if not torch.equal(got.device_aggregated, want.device_aggregated):
            raise AssertionError(f"session tensor blocks, hop {i}: the card-quantized blocks give other scores")
        for g, w in zip(card_s.push_finish(got), host_s.push_finish(want)):
            if (g is None) != (w is None):
                raise AssertionError(f"session tensor blocks, hop {i}: outputs differ in presence")
            if g is None:
                continue
            emitted += 1
            lines += g[0].to_rttm().count("\n")
            if g[0].to_rttm() != w[0].to_rttm() or not np.array_equal(g[1].data, w[1].data) or \
                    g[1].sliding_window.start != w[1].sliding_window.start:
                raise AssertionError(f"session tensor blocks, hop {i}: text or audio region differs")
    if not emitted or not lines:
        raise AssertionError("session tensor blocks: no outputs or no turns")
    log(f"session with CUDA tensor blocks (collect_audio, quantize_transfer), B={batch}, "
        f"{len(float_blocks)} hops: scores bitwise equal to the numpy-fed session, same RTTM text "
        f"({lines} lines) and audio regions in all {emitted} outputs")
    return dict(outputs=emitted, rttm_lines=lines)


# --------------------------------------------------------------------- #
# The runtime and the console entry points (diart_tpu_torch.runtime,
# diart_tpu_torch.console)
RUNTIME_KINDS = ("xvector", "ecapa", "vad")
RUNTIME_BATCHES = (1, 8)
RUNTIME_SECONDS = 20  # the stream CLI's file: 31 chunks of 5 s
BENCH_SECONDS = (10, 13, 16, 19, 22, 25, 28, 30)  # the Benchmark corpus, one file each
SERVER_HOPS = 24
# the stream CLI's thresholds here: the pipelines phase's, so the random
# weights make turns; everything else at the CLI's defaults
RUNTIME_CLI_ARGS = ("--tau-active", str(SESSION_TAU), "--rho-update", "0.05")


def write_seconds(path, rng, seconds):
    """``seconds`` of seeded audio (make_audio's noise bursts) as a WAV,
    written with the port's ``audio.write_wav``."""
    from diart_tpu_torch.audio import write_wav

    pcm = make_audio(rng, 2 * seconds, 1, 8000).reshape(-1)
    write_wav(path, (pcm.astype(np.float32) / 32768.0)[None], 16000)


def runtime_pipeline(kind):
    """The pipeline the stream CLI builds for path ``kind`` on the card: its
    registry models as ``from_pretrained`` gives them (f32 weights, seeds
    from the names), its defaults (5 s / 0.5 s, latency 0.5 s, delta 1, 20
    speakers) and RUNTIME_CLI_ARGS' thresholds."""
    from diart_tpu_torch import EmbeddingModel, SegmentationModel
    from diart_tpu_torch.blocks import (SpeakerDiarization, SpeakerDiarizationConfig,
                                        VoiceActivityDetection, VoiceActivityDetectionConfig)

    seg = SegmentationModel.from_pretrained("tpu/pyannet", device="cuda")
    if kind == "vad":
        return VoiceActivityDetection(VoiceActivityDetectionConfig(segmentation=seg, latency=0.5,
                                                                   tau_active=SESSION_TAU))
    emb = EmbeddingModel.from_pretrained(EMBEDDINGS[kind], device="cuda")
    return SpeakerDiarization(SpeakerDiarizationConfig(segmentation=seg, embedding=emb, latency=0.5,
                                                       tau_active=SESSION_TAU, rho_update=0.05))


class CheckedPipeline:
    """What the runtime calls in place of a pipeline, with the same results:
    each call runs the pipeline's dispatch under the sync check, holds the
    launches of each kernel of the path to ``path_launches`` (counts set to
    0 before the dispatch, read after it), then fetches."""

    def __init__(self, pipe, kind):
        self.pipe, self.config = pipe, pipe.config
        self.per_call = path_launches(kind, pipe.config.segmentation.module.lstm.num_layers)
        self.counters = launch_counters()
        self.totals = {k: 0 for k in self.counters}
        self.calls = 0

    def reset(self):
        self.pipe.reset()

    def set_timestamp_shift(self, shift):
        self.pipe.set_timestamp_shift(shift)

    def __call__(self, chunks):
        for fn in self.counters.values():
            fn.launches = 0
        with no_host_sync():
            scores = self.pipe.dispatch(chunks)
        launches = {k: fn.launches for k, fn in self.counters.items()}
        if launches != self.per_call:
            raise AssertionError(f"runtime call {self.calls} ({len(chunks)} chunks): expected "
                                 f"{self.per_call} launches; got {launches}")
        for k, n in launches.items():
            self.totals[k] += n
        self.calls += 1
        return self.pipe.fetch(chunks, scores)


def stream_inference(pipe, wav, batch):
    """diart's file route through ``StreamingInference`` (FileAudioSource
    with the config's padding, the timestamp shift, calls of ``batch``
    chunks, profiled): the text, the Chronometer's seconds a call, the
    bare wall and the number of chunks."""
    from diart_tpu_torch.runtime import FileAudioSource, StreamingInference

    cfg = pipe.config
    pipe.reset()
    padding = cfg.get_file_padding(wav)
    source = FileAudioSource(wav, cfg.sample_rate, padding, cfg.step)
    pipe.set_timestamp_shift(-padding[0])
    inference = StreamingInference(pipe, source, batch_size=batch, do_profile=True, show_progress=False)
    t0 = time.perf_counter()
    prediction = inference()
    wall = time.perf_counter() - t0
    return prediction.to_rttm(), list(inference._chrono.history), wall, inference.num_chunks


def direct_loop(pipe, wav, batch):
    """The pipelines phase's loop on the runtime's chunks: the file loaded,
    padded as FileAudioSource pads it, cut into the windows the runtime's
    chunker gives, the same timestamp shift, calls of ``batch`` chunks
    folded into one annotation as the runtime's accumulator folds them:
    the text and each call's wall."""
    from diart_tpu_torch.audio import AudioLoader
    from diart_tpu_torch.core.segment import SlidingWindow, SlidingWindowFeature
    from diart_tpu_torch.runtime import PredictionAccumulator

    cfg = pipe.config
    sr = cfg.sample_rate
    pipe.reset()
    left, right = cfg.get_file_padding(wav)
    wave = AudioLoader(sr, mono=True).load(wav)[0]
    wave = np.concatenate([np.zeros(int(np.rint(left * sr)), np.float32), wave,
                           np.zeros(int(np.rint(right * sr)), np.float32)])
    block = int(np.rint(cfg.step * sr))
    wave = np.concatenate([wave, np.zeros(-len(wave) % block, np.float32)])
    win, hop, res = int(round(cfg.duration * sr)), int(round(cfg.step * sr)), 1.0 / sr
    chunks = [SlidingWindowFeature(wave[k * hop : k * hop + win, None].copy(),
                                   SlidingWindow(start=k * hop / sr, duration=res, step=res))
              for k in range((len(wave) - win) // hop + 1)]
    pipe.set_timestamp_shift(-left)
    acc = PredictionAccumulator(os.path.splitext(os.path.basename(wav))[0])
    walls = []
    for i in range(0, len(chunks), batch):
        t0 = time.perf_counter()
        outs = pipe(chunks[i : i + batch])
        walls.append(time.perf_counter() - t0)
        for out in outs:
            acc.on_next(out)
    return acc.get_prediction().to_rttm(), walls, len(chunks)


def check_rttm(text, uri, what):
    """Every line a well-formed RTTM SPEAKER line of ``uri``; the number of
    lines (at least one)."""
    lines = text.splitlines()
    for line in lines:
        f = line.split()
        if len(f) != 10 or f[:3] != ["SPEAKER", uri, "1"] or f[5:7] != ["<NA>", "<NA>"] \
                or f[8:] != ["<NA>", "<NA>"] or not float(f[3]) >= 0.0 or not float(f[4]) > 0.0:
            raise AssertionError(f"{what}: malformed RTTM line {line!r}")
    if not lines:
        raise AssertionError(f"{what}: no turns")
    return len(lines)


def stream_cli(wav, out_dir, *extra, tf32_override=True):
    """``python -m diart_tpu_torch.console.stream <wav> --no-plot --output
    <dir>`` in a subprocess on the card, with the default models and
    RUNTIME_CLI_ARGS. ``NVIDIA_TF32_OVERRIDE=0`` keeps TF32 out of its
    cuDNN convolutions, as this script's ``allow_tf32 = False`` does here,
    so both processes round alike; ``tf32_override=False`` runs the CLI as
    a user's shell does, with no override and torch's default switches.
    The RTTM text, the wall and the CLI's own profile line. ``extra``: more
    arguments."""
    env = dict(os.environ)
    env.pop("NVIDIA_TF32_OVERRIDE", None)
    if tf32_override:
        env["NVIDIA_TF32_OVERRIDE"] = "0"
    cmd = [sys.executable, "-m", "diart_tpu_torch.console.stream", wav, "--no-plot", "--output",
           out_dir, *RUNTIME_CLI_ARGS, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=PKG_ROOT, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"stream CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    uri = os.path.splitext(os.path.basename(wav))[0]
    text = open(os.path.join(out_dir, f"{uri}.rttm")).read()
    profile = [l for l in (proc.stdout + proc.stderr).splitlines() if "seconds/chunk" in l]
    return text, wall, profile[-1].strip() if profile else None


def drive_runtime_inference(wav, cli_text):
    """StreamingInference over FileAudioSource on the CLI's file for each
    path, in calls of 1 and 8: every dispatch under the sync check, each
    kernel launched per call as its path says, the same text from both call
    sizes and from the direct loop over the same chunks and shift; the
    x-vector text at calls of 1 equal to the stream CLI's. ms per chunk from
    the Chronometer and the bare wall, against the direct loop's."""
    import torch

    recs = {}
    for kind in RUNTIME_KINDS:
        pipe = CheckedPipeline(runtime_pipeline(kind), kind)
        # first use, outside the sync check: the models' device constants
        # (the packed LSTM weights, ...) are copied from the host once
        direct_loop(pipe.pipe, wav, 1)
        torch.cuda.synchronize()
        texts, rec = {}, dict(launches_per_call=pipe.per_call)
        launches, calls = {k: 0 for k in pipe.totals}, 0
        for batch in RUNTIME_BATCHES:
            before, calls_before = dict(pipe.totals), pipe.calls
            text, chrono, wall, expected = stream_inference(pipe, wav, batch)
            calls_runtime = pipe.calls - calls_before
            calls += calls_runtime
            for k in launches:
                launches[k] += pipe.totals[k] - before[k]
            direct, walls, chunks = direct_loop(pipe, wav, batch)
            if expected != chunks or calls_runtime != -(-chunks // batch):
                raise AssertionError(f"runtime[{kind}] b{batch}: {calls_runtime} calls for {chunks} chunks "
                                     f"(the runtime expected {expected})")
            texts[batch] = text
            if direct != text:
                raise AssertionError(f"runtime[{kind}] b{batch}: StreamingInference text differs from the "
                                     f"direct pipeline loop over the same chunks")
            rec[f"b{batch}"] = dict(
                chunks=chunks, chrono_ms_per_chunk=1e3 * sum(chrono) / chunks,
                wall_ms_per_chunk=1e3 * wall / chunks, direct_ms_per_chunk=1e3 * sum(walls) / chunks,
                overhead_ms_per_chunk=1e3 * (wall - sum(walls)) / chunks)
        if texts[1] != texts[RUNTIME_BATCHES[-1]]:
            raise AssertionError(f"runtime[{kind}]: calls of {RUNTIME_BATCHES[-1]} give other text than calls of 1")
        uri = os.path.splitext(os.path.basename(wav))[0]
        rec["rttm_lines"] = check_rttm(texts[1], uri, f"runtime[{kind}]")
        rec["launches"], rec["calls"] = launches, calls
        if kind == "xvector":
            rec["equals_stream_cli"] = texts[1] == cli_text
            if cli_text != texts[1]:
                raise AssertionError("stream CLI: its RTTM text differs from the in-process "
                                     "StreamingInference run of the same config")
        recs[kind] = rec
        log(f"runtime[{kind}] StreamingInference over {rec['b1']['chunks']} chunks in calls of "
            f"{' and '.join(map(str, RUNTIME_BATCHES))}: identical text ({rec['rttm_lines']} lines) from both "
            f"and from the direct loop{', equal to the stream CLI' if kind == 'xvector' else ''}; no host "
            f"sync in any dispatch; launches per call {pipe.per_call} in every call ({calls} calls of "
            f"the runtime: {launches})")
        for batch in RUNTIME_BATCHES:
            r = rec[f"b{batch}"]
            log(f"runtime[{kind}] {batch} chunk(s) a call: Chronometer {r['chrono_ms_per_chunk']:.3f} ms a chunk, "
                f"bare wall {r['wall_ms_per_chunk']:.3f}, direct loop {r['direct_ms_per_chunk']:.3f}, "
                f"runtime overhead {r['overhead_ms_per_chunk']:.3f} ms a chunk")
        del pipe
    return recs


def drive_benchmark(corpus, out_root):
    """Benchmark(multi_stream=True) over the corpus at full width with
    x-vector, no reference (pandas is not needed): every file has its RTTM,
    each kernel of the engine's path ran on every hop; a second run with
    other thresholds reuses the cached engine (set_hyperparameters under
    the sync check); the sequential Benchmark on the card as the reference
    of each file's DER (a record). Then Parallelize with 2 spawn workers
    over 2 files: the sequential text."""
    import shutil

    import torch
    from diart_tpu_torch.metrics import DiarizationErrorRate
    from diart_tpu_torch.runtime import Benchmark, Parallelize

    pipe = runtime_pipeline("xvector")
    config = pipe.config
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(corpus))
    seconds = sum(BENCH_SECONDS)
    counters = launch_counters()
    per_step = path_launches("xvector", config.segmentation.module.lstm.num_layers)
    ms_dir, seq_dir = os.path.join(out_root, "multi"), os.path.join(out_root, "seq")
    bench = Benchmark(corpus, None, ms_dir, show_progress=False, multi_stream=True)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ms_preds = bench(type(pipe), config)
    ms_wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    engine = bench._engine_cache[1]
    hops = int(np.ceil(max(BENCH_SECONDS) / config.step))
    want = {k: n * hops for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"benchmark multi-stream: expected {want} launches over {hops} hops; got {launches}")
    lines = {}
    for stem, pred in zip(stems, ms_preds):
        path = os.path.join(ms_dir, f"{stem}.rttm")
        if pred.uri != stem or not os.path.exists(path):
            raise AssertionError(f"benchmark multi-stream: no RTTM for {stem}")
        lines[stem] = check_rttm(open(path).read(), stem, f"benchmark multi-stream {stem}")
    with no_host_sync():
        engine.set_hyperparameters(tau_active=0.5, rho_update=0.05)
    config.tau_active = 0.5
    t0 = time.perf_counter()
    bench(type(pipe), config)
    rerun_wall = time.perf_counter() - t0
    if bench._engine_cache[1] is not engine:
        raise AssertionError("benchmark multi-stream: a run with other thresholds rebuilt the engine")
    config.tau_active = SESSION_TAU
    t0 = time.perf_counter()
    seq_preds = Benchmark(corpus, None, seq_dir, show_progress=False, batch_size=32)(type(pipe), config)
    seq_wall = time.perf_counter() - t0
    ders = {stem: float(DiarizationErrorRate()(s, m)) for stem, s, m in zip(stems, seq_preds, ms_preds)}
    # Parallelize: 2 spawn workers over 2 files, the models crossing as their loaders
    # (each worker builds them on the card from the same names and seeds)
    par_in, par_out = os.path.join(out_root, "par_in"), os.path.join(out_root, "par")
    os.makedirs(par_in, exist_ok=True)
    picked = [stems[0], stems[-1]]
    for stem in picked:
        shutil.copy(os.path.join(corpus, f"{stem}.wav"), par_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Parallelize(Benchmark(par_in, None, par_out, show_progress=False, batch_size=32), num_workers=2)(
        type(pipe), config)
    par_wall = time.perf_counter() - t0
    for stem in picked:
        got = open(os.path.join(par_out, f"{stem}.rttm")).read()
        if got != open(os.path.join(seq_dir, f"{stem}.rttm")).read():
            raise AssertionError(f"Parallelize: {stem}'s text differs from the sequential Benchmark's")
    rec = dict(files=len(stems), audio_s=seconds, hops=hops, multi_wall_s=ms_wall,
               multi_x_realtime=seconds / ms_wall, multi_rerun_wall_s=rerun_wall, seq_wall_s=seq_wall,
               seq_x_realtime=seconds / seq_wall, der_vs_sequential=ders, rttm_lines=lines,
               launches=launches, parallelize=dict(files=picked, workers=2, wall_s=par_wall))
    log(f"benchmark multi-stream over {len(stems)} files ({seconds} s of audio, {hops} hops at B={len(stems)}): "
        f"every file has its RTTM ({sum(lines.values())} lines), launches {launches} "
        f"({hops} x {per_step}); {seconds / ms_wall:.2f} s of audio a second ({ms_wall:.2f} s wall; "
        f"rerun with the cached engine {rerun_wall:.2f} s); sequential Benchmark {seconds / seq_wall:.2f} s "
        f"a second ({seq_wall:.2f} s)")
    log("benchmark DER of each file, multi-stream against the sequential run (a record): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ders.items()))
    log(f"Parallelize, 2 spawn workers over {picked}: the sequential text ({par_wall:.2f} s)")
    return rec


class StubSocket:
    """An in-process client's websocket: records what the server sends."""

    def __init__(self):
        self.sent = []

    async def send(self, message):
        self.sent.append(message)

    async def close(self, code=1000, reason=""):
        raise AssertionError(f"server closed a stub client: {code} {reason}")


def drive_server(audio):
    """StreamingServer over the full-width x-vector engine at B streams,
    SERVER_HOPS hops of stub clients in every slot, each tick driven by
    ``_tick``: one cohort on the float32 wire, then two cohorts pipelined
    with quantize_transfer, cohort 0 on the int16 wire and cohort 1 on the
    float32 wire. Every dispatch (on the server's dispatch thread) under the
    sync check; each client's text equal to a MultiStreamSession pushed the
    same blocks from the main thread (quantized likewise) at the same hop;
    each kernel of the path ran on every dispatched hop."""
    import asyncio

    import torch
    from diart_tpu_torch import MultiStreamSession
    from diart_tpu_torch.runtime.server import StreamingServer
    from diart_tpu_torch.utils import encode_audio, encode_audio_int16

    engine = build_engine("cuda", B, "xvector")
    with no_host_sync():
        engine.set_hyperparameters(tau_active=SESSION_TAU, rho_update=0.05)
    per_step = path_launches("xvector", 4)
    counters = launch_counters()
    floats = audio[:SERVER_HOPS].astype(np.float32) / 32768.0  # (hops, B, step)
    recs = {}
    for cohorts, pipelined, quantize, wires in ((1, False, False, ("f32",)),
                                                (2, True, True, ("int16", "f32"))):
        tag = f"cohorts={cohorts}{' pipelined' if pipelined else ''}{' quantized' if quantize else ''}"
        server = StreamingServer(engine, tau_active=SESSION_TAU, cohorts=cohorts, pipelined=pipelined,
                                 quantize_transfer=quantize)
        server.session.warm()
        dispatch_ms, harvest_ms = [], []
        for session in server.sessions:
            def begin(blocks, present, _begin=session.push_begin):
                with no_host_sync():
                    t0 = time.perf_counter()
                    pending = _begin(blocks, present)
                    dispatch_ms.append((time.perf_counter() - t0) * 1e3)
                return pending

            def finish(pending, _finish=session.push_finish_rttm):
                t0 = time.perf_counter()
                out = _finish(pending)
                harvest_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            session.push_begin, session.push_finish_rttm = begin, finish
        clients = [server._claim_slot(StubSocket()) for _ in range(B * cohorts)]
        lane_of = lambda j, lane: lane if j == 0 else B - 1 - lane  # cohort 1 streams in reverse
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0

        async def drive():
            for k in range(SERVER_HOPS):
                for i, client in enumerate(clients):
                    j, lane = divmod(i, B)
                    block = floats[k, lane_of(j, lane)][None]
                    wire = wires[j]
                    message = encode_audio_int16(block) if wire == "int16" else encode_audio(block)
                    client.buffer = np.concatenate([client.buffer, server._ingest(message, wire)])
                for j in range(cohorts):
                    await server._tick(j)
                    while server._in_flight:  # the deliverer's part, in order
                        fut, slots = await server._outbox.get()
                        await server._send_outputs(await fut, slots)
                        server._in_flight -= 1

        t0 = time.perf_counter()
        asyncio.run(drive())
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: n * len(dispatch_ms) for k, n in per_step.items()}
        if len(dispatch_ms) != SERVER_HOPS * cohorts or launches != want:
            raise AssertionError(f"server[{tag}]: {len(dispatch_ms)} dispatches, launches {launches}; "
                                 f"expected {SERVER_HOPS * cohorts} and {want}")
        lines, main_dispatch_ms = 0, []
        for j in range(cohorts):
            ref = MultiStreamSession(engine, uris=[f"client{j * B + lane}" for lane in range(B)],
                                     tau_active=SESSION_TAU, collect_audio=False, quantize_transfer=quantize)
            want_text = [""] * B
            order = [lane_of(j, lane) for lane in range(B)]
            for k in range(SERVER_HOPS):
                # the same dispatch on this (the main) thread, timed alike
                t0 = time.perf_counter()
                pending = ref.push_begin(floats[k, order], np.ones(B, bool))
                main_dispatch_ms.append((time.perf_counter() - t0) * 1e3)
                texts = [None] * B if pending is None else ref.push_finish_rttm(pending)
                for lane, text in enumerate(texts):
                    want_text[lane] += text or ""
            for lane in range(B):
                got = "".join(clients[j * B + lane].websocket.sent)
                if got != want_text[lane]:
                    raise AssertionError(f"server[{tag}] cohort {j} ({wires[j]} wire) client {lane}: text "
                                         f"differs from the session pushed from the main thread")
                lines += got.count("\n")
        if not lines:
            raise AssertionError(f"server[{tag}]: no turns")
        steady = slice(server.sessions[0].warmup_blocks * cohorts, None)
        rec = dict(cohorts=cohorts, pipelined=pipelined, quantize_transfer=quantize, wires=list(wires),
                   clients=len(clients), hops=SERVER_HOPS, wall_s=wall, rttm_lines=lines, launches=launches,
                   dispatch_ms=float(np.median(dispatch_ms[steady])), harvest_ms=float(np.median(harvest_ms)),
                   main_thread_dispatch_ms=float(np.median(main_dispatch_ms[steady])),
                   dispatch_ms_all=dispatch_ms, harvest_ms_all=harvest_ms)
        recs[tag] = rec
        server._dispatch_pool.shutdown()
        for pool in server._harvest_pools:
            pool.shutdown()
        log(f"server[{tag}] {len(clients)} stub clients ({'/'.join(wires)} wire), {SERVER_HOPS} hops by _tick: "
            f"every client's text equals the main thread's session ({lines} lines), no host sync in any "
            f"dispatch on the server's thread, launches {launches}; per hop dispatch {rec['dispatch_ms']:.3f} ms "
            f"(the same dispatch on the main thread {rec['main_thread_dispatch_ms']:.3f} ms), harvest "
            f"{rec['harvest_ms']:.3f} ms (medians of the hops after warm-up; {wall:.2f} s wall)")
    return recs


def drive_runtime(out_dir):
    """The runtime phase: the stream CLI in a subprocess, StreamingInference
    on three paths, Benchmark and Parallelize, StreamingServer ticks."""
    import shutil
    import tempfile

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)  # inside the checkout
    try:
        rng = np.random.default_rng(4)
        wav = os.path.join(tmp, "meeting.wav")
        write_seconds(wav, rng, RUNTIME_SECONDS)
        t0 = time.perf_counter()
        cli_text, cli_wall, cli_profile = stream_cli(wav, os.path.join(tmp, "cli"))
        cli_lines = check_rttm(cli_text, "meeting", "stream CLI")
        log(f"stream CLI (subprocess, default models on the card): exit 0, {cli_lines} well-formed RTTM "
            f"lines, {cli_wall:.2f} s wall; its profile: {cli_profile}")
        inference = drive_runtime_inference(wav, cli_text)
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        for k, seconds in enumerate(BENCH_SECONDS):
            write_seconds(os.path.join(corpus, f"file{k}.wav"), rng, seconds)
        benchmark = drive_benchmark(corpus, tmp)
        server = drive_server(make_audio(np.random.default_rng(5), SERVER_HOPS, B, 8000))
        rec = dict(stream_cli=dict(wall_s=cli_wall, rttm_lines=cli_lines, profile=cli_profile),
                   inference=inference, benchmark=benchmark, server=server,
                   seconds=time.perf_counter() - t0)
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# torch's default TF32 switches: the port's f32 convolutions stay true f32
# --------------------------------------------------------------------- #
def sinc_times():
    """The sinc filterbank of ``tpu/pyannet`` at B windows of 5 s: the
    port's call as the caller's switches stand, and the same convolution
    with cuDNN's TF32 on and off (``allow_tf32``), its TF32 error against
    true f32 beside it; for the TF32 policy question (a record)."""
    import torch
    import torch.nn.functional as F
    from diart_tpu_torch import SegmentationModel
    from diart_tpu_torch.models.sincnet import SincConv

    seg = SegmentationModel.from_registry("tpu/pyannet", device="cuda", seed=0)
    sinc = next(m for m in seg.module.modules() if isinstance(m, SincConv))
    x = torch.randn(B, 1, 80000, device="cuda", generator=torch.Generator("cuda").manual_seed(7))
    rec = {}
    with torch.no_grad():
        filters = sinc.filters()[:, None, :]
        rec["port_ms"] = time_ms(lambda: sinc(x), 20)
        port = sinc(x)
        prev = torch.backends.cudnn.allow_tf32
        try:
            for name, flag in (("tf32_ms", True), ("true_f32_ms", False)):
                torch.backends.cudnn.allow_tf32 = flag
                rec[name] = time_ms(lambda: F.conv1d(x, filters, stride=sinc.stride), 20)
                rec[name.replace("_ms", "_out")] = F.conv1d(x, filters, stride=sinc.stride)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    exact = rec.pop("true_f32_out")
    scale = exact.abs().max().item()
    rec["tf32_max_abs_err"] = (rec.pop("tf32_out") - exact).abs().max().item()
    rec["port_max_abs_err"] = (port - exact).abs().max().item()
    rec["out_max_abs"] = scale
    log(f"sinc convolution {tuple(x.shape)} -> {tuple(exact.shape)}: the port's call {rec['port_ms']:.3f} ms "
        f"(max_abs_err against true f32 {rec['port_max_abs_err']:.3e}); cuDNN TF32 {rec['tf32_ms']:.3f} ms "
        f"(max_abs_err {rec['tf32_max_abs_err']:.3e} of max |y| {scale:.3e}), true f32 {rec['true_f32_ms']:.3f} ms")
    return rec


def tf32_invariance(audio):
    """The f32 x-vector engine for 2 streams on the card: the scores of
    ``probe_frame_scores`` after WARMUP_HOPS steps with torch's TF32
    switches as they stand, then with both off. The port's f32
    convolutions and products run in true f32 whatever the switches say,
    so the two must agree bit for bit."""
    import torch

    engine = build_engine("cuda", 2, "xvector", emb_dtype="f32", precision=f32_policy())
    state = engine.init_state()
    for i in range(WARMUP_HOPS):
        state, _ = engine.step(state, audio[i, :2])
    as_is = [t.float().cpu() for t in engine.probe_frame_scores(state, audio[WARMUP_HOPS, :2])]
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        off = [t.float().cpu() for t in engine.probe_frame_scores(state, audio[WARMUP_HOPS, :2])]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    rec = dict(bitwise=all(torch.equal(a, b) for a, b in zip(as_is, off)),
               seg_gap=(as_is[0] - off[0]).abs().max().item(), emb_gap=(as_is[1] - off[1]).abs().max().item())
    log(f"the card's f32 scores with TF32 as it comes against TF32 off: bitwise {rec['bitwise']} (segmentation "
        f"{rec['seg_gap']:.3e}, embeddings {rec['emb_gap']:.3e})")
    return rec


def drive_tf32_default(out_dir):
    """Torch's TF32 switches as a process gets them (run before this script
    turns them off; no ``NVIDIA_TF32_OVERRIDE``): the x-vector engine's f32
    probe and 12 f32 hops against the CPU (``compare_cpu``'s f32 case, its
    tolerances), the same probe on the card bitwise the one with TF32 off
    (``tf32_invariance``), and the stream CLI in a subprocess without the
    override, whose RTTM text must equal the same CLI's run with TF32 off;
    the sinc filterbank's times (``sinc_times``, a record). Every gap is
    logged before the phase fails."""
    import shutil
    import tempfile

    import torch

    switches = dict(cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                    matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                    NVIDIA_TF32_OVERRIDE=os.environ.get("NVIDIA_TF32_OVERRIDE"))
    log(f"TF32 as a process gets it: {switches}")
    t0 = time.perf_counter()
    audio = make_audio(np.random.default_rng(0), HOPS + 20, B, 8000)
    probe = compare_cpu("xvector", audio, ("f32",), strict=False)
    invariance = tf32_invariance(audio)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    try:
        wav = os.path.join(tmp, "meeting.wav")
        write_seconds(wav, np.random.default_rng(4), RUNTIME_SECONDS)
        off, _, _ = stream_cli(wav, os.path.join(tmp, "off"))
        default, wall, _ = stream_cli(wav, os.path.join(tmp, "default"), tf32_override=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = off.splitlines(), default.splitlines()
    differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    sinc = sinc_times()
    rec = dict(switches=switches, probe=probe, card_invariance=invariance, cli_text_equal=off == default,
               cli_lines=[len(a), len(b)],
               cli_lines_differing=differ, sinc=sinc, seconds=time.perf_counter() - t0)
    log(f"stream CLI with TF32 as it comes against TF32 off: text equal {rec['cli_text_equal']} "
        f"({len(b)} / {len(a)} lines, {differ} differ); {wall:.2f} s wall")
    if out_dir:
        with open(os.path.join(out_dir, "tf32_default.json"), "w") as f:
            json.dump(rec, f, indent=1)
    failures = probe.get("failures", []) + ([] if rec["cli_text_equal"] else ["the stream CLI's text"]) \
        + ([] if invariance["bitwise"] else ["the card's f32 scores depend on the TF32 switches"])
    if failures:
        raise AssertionError(f"under torch's default TF32 switches: {'; '.join(failures)}")
    return rec


# --------------------------------------------------------------------- #
# The model layer: the families at full width as the engine's arms
# --------------------------------------------------------------------- #
# family: (role, registry name, the replica and its arguments in
# tests/torch_replicas.py, the engine's other model)
FAMILIES = {
    "titanet": ("embedding", "tpu/titanet", ("NMTitaNet", dict(channels=1024, embed_dim=192))),
    "xvect-sb": ("embedding", "tpu/xvect-sb", ("SBXVector", dict())),
    "resnet34": ("embedding", "tpu/resnet34", ("WSResNet34", dict(embed_dim=256, m_channels=32))),
    "powerset": ("segmentation", "tpu/pyannet-powerset",
                 ("TorchPyanNet", dict(num_speakers=7, lstm_hidden=128, lstm_layers=4, linear_dims=(128, 128)))),
}
POWERSET = (3, 2)  # 3 speakers, at most 2 at once: 7 classes
FAMILY_HOPS = 16
FAMILY_CPU_HOPS = 3
# the card against the CPU in f32 (TF32 off on both): the segmentation
# (sigmoids, or the decoded powerset activations where the margin allows)
# within 1e-4, unit-norm embeddings within 1e-3, as compare_cpu holds them
FAMILY_SEG_TOL, FAMILY_EMB_TOL = 1e-4, 1e-3
# the powerset decode is compared at frames whose top-1 - top-2
# log-probability margin on the CPU exceeds this (an argmax closer than the
# f32 error of the two forwards may pick the other class on either)
POWERSET_MARGIN = 1e-3


def family_replica(family, seed):
    """The seeded torch replica of ``family`` (a powerset PyanNet with the
    empty-set class suppressed, so its random weights make speech)."""
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    if os.path.join(root, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(root, "tests"))
    import torch_replicas

    cls, kwargs = FAMILIES[family][2]
    torch.manual_seed(seed)
    net = getattr(torch_replicas, cls)(**kwargs).eval()
    if family == "powerset":
        with torch.no_grad():
            net.classifier.bias[0] = -5.0
    return net


def family_files(scratch):
    """Each family's replica state dict as a torch checkpoint, converted by
    the port (``from_pretrained`` on the checkpoint) and written as a native
    file (``save``); {family: (checkpoint, native file)}."""
    import torch
    from diart_tpu_torch import EmbeddingModel, SegmentationModel

    files = {}
    for i, family in enumerate(FAMILIES):
        ckpt = os.path.join(scratch, f"{family}.pt")
        torch.save(family_replica(family, 10 + i).state_dict(), ckpt)
        native = os.path.join(scratch, f"{family}.native.pt")
        if family == "powerset":
            SegmentationModel.from_pretrained(ckpt, device="cpu", powerset=POWERSET).save(native)
        else:
            EmbeddingModel.from_pretrained(ckpt, device="cpu").save(native)
        files[family] = (ckpt, native)
    return files


def family_engine(family, native, device, batch, dtype="bf16", precision=None):
    """The engine of ``family`` from its native file: a mel family as the
    embedding beside ``tpu/pyannet``, the powerset PyanNet as the
    segmentation beside ``tpu/xvector``; 5 s / 0.5 s, 20 speakers. The
    embedding trunk computes in ``dtype``."""
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    if FAMILIES[family][0] == "segmentation":
        seg = SegmentationModel.from_pretrained(native, device=device)
        emb = EmbeddingModel.from_registry("tpu/xvector", device=device, seed=1, dtype=dtype)
    else:
        seg = SegmentationModel.from_registry("tpu/pyannet", device=device, seed=0)
        emb = EmbeddingModel.from_pretrained(native, device=device, dtype=dtype)
    return MultiStreamEngine(seg, emb, duration=5.0, step=0.5, latency=0.5, sample_rate=16000,
                             max_speakers=20, batch_size=batch, precision=precision,
                             tau_active=SESSION_TAU, rho_update=0.05)


def family_launches(family) -> dict:
    """Each counted kernel's launches in one step of ``family``'s engine:
    the 4-layer PyanNet's sweeps, and the embedding's statistics kernel
    (TitaNet: attention statistics; XVector-SB and the x-vector beside the
    powerset model: the fused stats head; ResNet34: its 36 convolutions, each
    one launch of ``resnet_conv``)."""
    return {"lstm_sweep": 4, "lstm_sweep_bwd": 0, "linear_stats": int(family in ("xvect-sb", "powerset")),
            "attn_stats": int(family == "titanet"), "se_res2": 0, "se_res2_staged": 0,
            "resnet_conv": 36 * int(family == "resnet34")}


def drive_family(family, native, audio):
    """The family's engine at B streams on the card: one step outside the
    sync check (the models' and the clustering's constants are copied from
    the host at first use), then
    FAMILY_HOPS hops of int16 blocks (warm-up, then running) with every step
    under the sync check and every kernel's launches counted (counts set to
    0 just before, read just after); shapes, finiteness, the ring kind; then
    the step's wall, device busy, idle share and launches a step."""
    import torch

    engine = family_engine(family, native, "cuda", B)
    engine.step(engine.init_state(), audio[0])  # first use: constants copied from the host once
    torch.cuda.synchronize()
    state = engine.init_state()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = []
    with no_host_sync():
        for i in range(FAMILY_HOPS):
            state, out = engine.step(state, audio[i], np.ones(B, bool), np.full(B, i + 1 >= WARMUP_HOPS))
            outs.append(out)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    per_hop = family_launches(family)
    if launches != {k: v * FAMILY_HOPS for k, v in per_hop.items()}:
        raise AssertionError(f"family[{family}]: expected {per_hop} launches per hop; got {launches}")
    for o in outs:
        if not (torch.isfinite(o.aggregated).all() and torch.isfinite(o.newest).all()):
            raise AssertionError(f"family[{family}]: non-finite scores")
    last = outs[-1]
    assert last.aggregated.shape == (B, engine.geometry.num_out, 20), last.aggregated.shape
    assert engine.num_local == (POWERSET[0] if family == "powerset" else 4), engine.num_local
    ring = None if engine._fring is None else engine._fring.kind
    active = state.center_active.sum(dim=1).float().mean().item()
    timing = step_timing(engine, audio, family, light=True)
    if timing["sync_check"] != "no host sync":
        raise AssertionError(f"family[{family}] step waits for the card: {timing['sync_check']}")
    rec = dict(launches=launches, launches_per_step=per_hop, frame_ring=ring, active_centres=active,
               embedding_dtype=str(engine._emb.module.compute_dtype), **timing)
    log(f"family[{family}] engine B={B}, {FAMILY_HOPS} hops under the sync check: launches {launches} "
        f"({per_hop} a step), frame ring {ring}, mean active centres {active:.2f}; step wall "
        f"{timing['back_to_back_wall_ms']:.3f} ms back to back, dispatch {timing['dispatch_ms']:.3f} ms, "
        f"device busy {timing.get('device_busy_ms', float('nan')):.3f} ms, idle share "
        f"{timing.get('idle_share', float('nan')):.3f}, {timing.get('kernels_per_step', float('nan')):.0f} "
        f"device launches a step")
    return rec


def compare_family_cpu(family, native, audio):
    """The family's engine for 2 streams on the card against the same engine
    on the CPU (the kernels' plain versions), in f32 with TF32 off:
    FAMILY_CPU_HOPS hops (every stream running), then the frame scores
    ``probe_frame_scores`` gives, held to FAMILY_SEG_TOL / FAMILY_EMB_TOL. A
    powerset model's decoded activations are compared at the frames whose
    CPU margin exceeds POWERSET_MARGIN; the smallest margin is logged. The
    aggregated scores of the hops are a record, not a check: windows that
    are still mostly the zero warm-up fill give ill-conditioned embeddings
    (a mel family's normalized silence), so the clustering of those first
    hops may decide otherwise on either device."""
    import torch
    from diart_tpu_torch.precision import Precision

    prec = Precision(bf16_lstm=False, bf16_frontend=False)
    probes, aggs, margin = [], [], None
    for device in ("cuda", "cpu"):
        engine = family_engine(family, native, device, 2, dtype="f32", precision=prec)
        state = engine.init_state()
        seq = []
        for i in range(FAMILY_CPU_HOPS):
            state, out = engine.step(state, audio[i, :2])
            seq.append(out.aggregated.float().cpu())
        seg, emb = engine.probe_frame_scores(state, audio[FAMILY_CPU_HOPS, :2])
        probes.append((seg.float().cpu(), emb.float().cpu()))
        aggs.append(torch.stack(seq))
        if device == "cpu" and family == "powerset":
            blocks = torch.from_numpy(audio[FAMILY_CPU_HOPS, :2])
            _, window, _ = engine._advance_audio(state.audio, blocks, torch.ones(2, dtype=torch.bool))
            with torch.no_grad():
                raw = engine._seg.module(window[:, None])  # class log-probabilities
            top2 = raw.topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]
    (sg, eg), (sc, ec) = probes
    for t in (sg, eg):
        if not torch.isfinite(t).all():
            raise AssertionError(f"family[{family}] card probe: non-finite values")
    rec = {}
    if margin is not None:
        clear = margin > POWERSET_MARGIN
        seg_err = (sg - sc).abs()[clear].max().item()
        rec.update(min_margin=margin.min().item(), frames_compared=int(clear.sum()), frames=clear.numel())
        if clear.sum() < 0.9 * clear.numel():
            raise AssertionError(f"family[{family}]: only {int(clear.sum())} of {clear.numel()} frames clear "
                                 f"the margin {POWERSET_MARGIN}")
    else:
        seg_err = (sg - sc).abs().max().item()
    rec["agg_err"] = (aggs[0] - aggs[1]).abs().max().item()
    emb_err = (eg - ec).abs().max().item()
    rec.update(seg_err=seg_err, seg_tol=FAMILY_SEG_TOL, emb_err=emb_err, emb_tol=FAMILY_EMB_TOL)
    log(f"family[{family}] card vs CPU (f32, 2 streams, {FAMILY_CPU_HOPS} hops): seg max_abs_err={seg_err:.3e} "
        f"(tol {FAMILY_SEG_TOL:.0e}"
        + (f"; decoded frames with margin > {POWERSET_MARGIN:g}: {rec['frames_compared']} of {rec['frames']}, "
           f"min margin {rec['min_margin']:.3e}" if margin is not None else "")
        + f"), emb max_abs_err={emb_err:.3e} (tol {FAMILY_EMB_TOL:.0e}); aggregated scores of the "
        f"{FAMILY_CPU_HOPS} hops, a record: max_abs_err={rec['agg_err']:.3e}")
    if not (seg_err <= FAMILY_SEG_TOL and emb_err <= FAMILY_EMB_TOL):
        raise AssertionError(f"family[{family}]: the card disagrees with the CPU engine")
    return rec


def convert_cli(ckpt, out):
    """``python -m diart_tpu_torch.console.convert embedding <ckpt> <out>
    --check`` in a subprocess on the card; its output file must equal the
    in-process conversion (config text and every tensor)."""
    import torch
    from diart_tpu_torch import EmbeddingModel

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "diart_tpu_torch.console.convert", "embedding", ckpt, out, "--check"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=root)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "check ok" not in proc.stdout:
        raise AssertionError(f"convert CLI exited {proc.returncode}: {proc.stdout[-1000:]} {proc.stderr[-3000:]}")
    want = out + ".inprocess.pt"
    EmbeddingModel.from_pretrained(ckpt, device="cuda").save(want)
    if open(out + ".json").read() != open(want + ".json").read():
        raise AssertionError("convert CLI: its config differs from the in-process conversion's")
    got_sd, want_sd = (torch.load(p, weights_only=True) for p in (out, want))
    if set(got_sd) != set(want_sd) or not all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd):
        raise AssertionError("convert CLI: its state dict differs from the in-process conversion's")
    return dict(wall_s=wall, tensors=len(got_sd), stdout=proc.stdout.strip().splitlines())


def stream_cli_powerset(wav, ckpt, out_dir):
    """The stream CLI in a subprocess with a powerset checkpoint and
    ``--powerset 3 2`` (``stream_cli``); its text must equal the same
    StreamingInference run in process."""
    from diart_tpu_torch import EmbeddingModel, SegmentationModel
    from diart_tpu_torch.blocks import SpeakerDiarization, SpeakerDiarizationConfig
    from diart_tpu_torch.runtime import FileAudioSource, StreamingInference

    text, wall, _ = stream_cli(wav, out_dir, "--segmentation", ckpt, "--powerset", *map(str, POWERSET))
    seg = SegmentationModel.from_pretrained(ckpt, device="cuda", powerset=POWERSET)
    emb = EmbeddingModel.from_pretrained("tpu/xvector", device="cuda")
    config = SpeakerDiarizationConfig(segmentation=seg, embedding=emb, latency=0.5, tau_active=SESSION_TAU,
                                      rho_update=0.05)
    pipeline = SpeakerDiarization(config)
    padding = config.get_file_padding(wav)
    pipeline.set_timestamp_shift(-padding[0])
    source = FileAudioSource(wav, config.sample_rate, padding, config.step)
    want = StreamingInference(pipeline, source, batch_size=1, do_profile=False, show_progress=False)()
    uri = os.path.splitext(os.path.basename(wav))[0]
    lines = check_rttm(text, uri, "stream CLI --powerset")
    if text != want.to_rttm():
        raise AssertionError("stream CLI --powerset: its RTTM text differs from the in-process run")
    return dict(wall_s=wall, rttm_lines=lines)


def drive_families(out_dir):
    """The model layer: each family's checkpoint converted and saved as a
    native file, its engine at B=64 on the card and for 2 streams against
    the CPU; the statistics kernels at the new callers' shapes against their
    plain versions; the convert CLI and the stream CLI with --powerset."""
    import shutil
    import tempfile

    import torch

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)  # inside the checkout
    try:
        t0 = time.perf_counter()
        files = family_files(tmp)
        log(f"families: replicas saved, converted and written as native files in {time.perf_counter() - t0:.1f} s")
        gen = torch.Generator(device="cuda").manual_seed(8)
        kernels = {
            "attn_stats_titanet": {k: check_attn(dt, gen, (B, T_ECAPA, 3 * 1024, H_ATT, S), False, ", titanet")
                                   for k, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))},
            "linear_stats_xvect_sb": {k: check_stats(dt, gen, (B, T_ECAPA, C_IN, C_OUT, S), False, ", xvect-sb")
                                      for k, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))},
        }
        runs = {}
        for family, (_, native) in files.items():
            t1 = time.perf_counter()
            audio = make_audio(np.random.default_rng(6), FAMILY_HOPS + 16, B, 8000)
            runs[family] = dict(engine=drive_family(family, native, audio),
                                vs_cpu=compare_family_cpu(family, native, audio))
            runs[family]["seconds"] = time.perf_counter() - t1
            log(f"family[{family}] phase in {runs[family]['seconds']:.1f} s")
        cli = dict(convert=convert_cli(files["titanet"][0], os.path.join(tmp, "titanet.cli.pt")))
        log(f"convert CLI (subprocess, titanet checkpoint, --check): exit 0, {cli['convert']['tensors']} tensors "
            f"and the config equal to the in-process conversion, {cli['convert']['wall_s']:.2f} s wall")
        wav = os.path.join(tmp, "powerset.wav")
        write_seconds(wav, np.random.default_rng(7), 10)
        cli["stream_powerset"] = stream_cli_powerset(wav, files["powerset"][0], os.path.join(tmp, "cli"))
        log(f"stream CLI --powerset {POWERSET[0]} {POWERSET[1]} (subprocess): "
            f"{cli['stream_powerset']['rttm_lines']} RTTM lines equal to the in-process run, "
            f"{cli['stream_powerset']['wall_s']:.2f} s wall")
        return dict(kernels=kernels, runs=runs, cli=cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# Training and tuning: the kernels' gradients, both trainers at full width,
# the card against the CPU, checkpoints, the tune CLI and the Optimizer
# --------------------------------------------------------------------- #
TRAIN_B, TRAIN_STEPS, TRAIN_SAMPLES = 32, 6, 80000  # 32 chunks of 5 s
# AdamW's first steps move every weight by about lr; at the embedding
# trunks' fan-ins (up to 1536) that is large: at 1e-3 ECAPA's frames grow
# tenfold in four steps and saturate its attention's tanh (no gradient
# below it), and at 1e-4 both AAM losses rise again by the third step on
# this batch (a CPU run of the same steps gives the same losses); at 1e-5
# they fall at every step
TRAIN_LR = {"seg": 1e-3, "xvector": 1e-5, "ecapa": 1e-5}
TRAIN_CLASSES = 8  # tone-plus-noise speakers, 4 chunks each
RESUME_B = 8  # the checkpoint check's batch (3 + 3 steps against 6)
# a Function's gradient is autograd through the plain version on the same
# inputs, so it is the plain version's own; both sums of index_select's
# backward (the reflect padding) use atomics on the card, so their order
# may differ from run to run. The sweep's backward is its own kernel
# (csrc/lstm_sweep_bwd.cu) with the plain version's rounding points: its
# f32 sums run in another order, and it starts from the forward kernel's
# output, whose bf16 roundings differ from the plain version's now and then
# (LSTM_TOL). Within 1e-5 (f32) / 1e-2 (bf16: a flipped rounding of a bf16
# gradient is 2**-8 of it) of the largest gradient
KERNEL_GRAD_TOL = {"f32": 1e-5, "bf16": 1e-2}
# card against CPU in f32, one step on 2 samples: the loss within 1e-4;
# each gradient tensor norm-wise within 5e-2, or within 1e-6 of the
# model's largest entry where its norm is under 1e-6 of the largest (zero
# but for rounding). The gradients below SincNet's max-pools and leaky
# ReLUs are ill-conditioned: an input within rounding of a kink or of a
# pooling tie takes the other side, and on the CPU a 2**-22 relative
# change of the waveform moves SincNet's gradients by up to 6.3e-4 of
# their norm; the card rounds differently at every layer. Every updated
# parameter within 2 x lr and two f32 roundings of its value: Adam's first
# step is lr * g / (|g| + eps) for each entry, and where |g| is near eps
# rounding noise moves it by up to lr either way.
CPU_LOSS_TOL, CPU_GRAD_TOL = 1e-4, 5e-2
# each counted kernel's launches in one training step: the forwards, and
# the sweep's backward kernel (one a layer); the other kernels' backwards
# are their plain versions' autograd
TRAIN_LAUNCHES = {
    "seg": dict(lstm_sweep=4, lstm_sweep_bwd=4, linear_stats=0, attn_stats=0, se_res2=0, se_res2_staged=0,
                resnet_conv=0),
    "xvector": dict(lstm_sweep=0, lstm_sweep_bwd=0, linear_stats=1, attn_stats=0, se_res2=0, se_res2_staged=0,
                    resnet_conv=0),
    "ecapa": dict(lstm_sweep=0, lstm_sweep_bwd=0, linear_stats=0, attn_stats=1, se_res2=3, se_res2_staged=0,
                  resnet_conv=0),
}
TUNE_SECONDS = (10, 13, 16, 20)  # the tuning corpus, one file each
TUNE_TRIALS = 3


def kernel_grad_cases(dtype, cgen, gen):
    """(name, Function call, plain version, inputs) at each kernel's
    main-path shape with B=64: the inputs all require a gradient."""
    import torch
    from diart_tpu_torch.ops import attn_stats, linear_stats, lstm_sweep, se_res2

    n = lambda *s: torch.randn(*s, generator=cgen, device="cuda")
    proj = n(T_LSTM, 2, B, 4 * H).to(dtype)
    w_hh = n(2, 4 * H, H) * (0.3 / (H / 8) ** 0.5)
    x_res2 = n(B, T_ECAPA, C_ECAPA).to(dtype)
    return [
        ("lstm_sweep", lambda p, w: lstm_sweep.SweepFunction.apply(p, w, None),
         lstm_sweep.lstm_sweep_reference, (proj, w_hh)),
        ("linear_stats", lambda *a: linear_stats.LinearStatsFunction.apply(*a, None, 0.01),
         linear_stats.linear_stats_reference, stats_inputs(B, T_EMB, C_IN, C_OUT, S, dtype, cgen)),
        ("attn_stats", lambda *a: attn_stats.AttnStatsFunction.apply(*a, None),
         attn_stats.attentive_stats_reference, attn_inputs(B, T_ECAPA, C_MFA, H_ATT, S, dtype, cgen)),
        ("se_res2", lambda x, *p: se_res2.SERes2Function.apply(x, *p, None, 2),
         lambda x, *p: se_res2.se_res2_block_reference(x, *p, 2), (x_res2, *res2_params(gen, "cuda"))),
    ]


def check_kernel_grads():
    """Each kernel's Function against autograd through its plain version on
    the same inputs and a seeded cotangent, bf16 and f32: the gradient of
    every input, the forward (the kernel), the Function's backward (the
    plain version recomputed and differentiated) and the plain version's
    backward alone (CUDA events)."""
    import torch

    out = {}
    for key, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cgen = torch.Generator(device="cuda").manual_seed(11)
        gen = torch.Generator().manual_seed(11)
        for name, fn, ref, inputs in kernel_grad_cases(dtype, cgen, gen):
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            got_out = fn(*leaves)
            got_out = got_out if isinstance(got_out, tuple) else (got_out,)
            cots = [torch.randn(o.shape, generator=cgen, device="cuda").to(o.dtype) for o in got_out]
            got = torch.autograd.grad(got_out, leaves, cots, retain_graph=True)
            want_out = ref(*leaves)
            want_out = want_out if isinstance(want_out, tuple) else (want_out,)
            want = torch.autograd.grad(want_out, leaves, cots, retain_graph=True)
            scale = max(w.float().abs().max().item() for w in want)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            tol = KERNEL_GRAD_TOL[key] * scale
            bitwise = bitwise_equal(got, want)
            finite = all(torch.isfinite(g).all().item() for g in got)
            fwd_ms = time_ms(lambda: fn(*leaves), 3, warmup=1)
            bwd_ms = time_ms(lambda: torch.autograd.grad(got_out, leaves, cots, retain_graph=True), 3, warmup=1)
            plain_bwd_ms = time_ms(lambda: torch.autograd.grad(want_out, leaves, cots, retain_graph=True), 3,
                                   warmup=1)
            rec = dict(inputs=len(leaves), grad_max_abs_err=err, grad_tol=tol, grad_scale=scale,
                       bitwise=bitwise, forward_ms=fwd_ms, backward_ms=bwd_ms,
                       plain_backward_ms=plain_bwd_ms, shapes=[list(t.shape) for t in leaves])
            out.setdefault(name, {})[key] = rec
            log(f"{name} gradient [{key}]: {len(leaves)} inputs, max_abs_err={err:.3e} (tol {tol:.3e}, "
                f"bitwise {bitwise}); forward (kernel) {fwd_ms:.3f} ms, backward (plain version "
                f"recomputed + autograd) {bwd_ms:.3f} ms, the plain version's backward alone "
                f"{plain_bwd_ms:.3f} ms")
            if not (finite and err <= tol):
                raise AssertionError(f"{name} [{key}]: the Function's gradient disagrees with its plain version")
            del got_out, want_out, got, want
    torch.cuda.empty_cache()
    return out


# The shortest dependent chain of one step of the backward kernel's walk
# back through time on its split route (H = 128: a cluster of 2), in
# cycles, from the instruction latencies: dh, dc and da (an add, an FMA, a
# multiply: 12; the gates' coefficients come from phase A), da's 16 bytes
# into the peer's shared memory until its mbarrier phase completes (~180),
# the first broadcast load of da (~30), one part's chain of 16 FMAs (64),
# the parts' store and the block barrier (~50), the cell thread's loads of
# the parts (~30), their balanced tree (5 levels of adds, 20) and the
# rounding to the stream dtype (8). The column route's chain counts 154
# for a 512-term sum as one tree and one barrier; the split route's chain
# is longer and its throughput a step far shorter. Phase A's chain is one
# multiply and add a step.
LSTM_BWD_STEP_FLOOR_CYCLES = 394
SWEEP_BWD_BATCHES = (B, TRAIN_B)  # the kernel checks' 64 streams, the trainer's 32 chunks
# (T, B, H) off the main path: one step, 600 streams (split route: 2 rows
# a block, several waves of clusters), a width that is not a multiple of 32
# (the column route), the half width (split route, one block a tile), and
# the widest H (the column route; f32: most of W read through L2)
SWEEP_BWD_CASES = [(1, 3, H), (37, 600, H), (21, 3, 20), (37, 9, 64), (21, 5, 256)]


def sweep_bwd_inputs(time_, batch, dtype, cgen, hidden=H):
    """A seeded sweep: the gate stream, w_hh at the scale of
    kernel_grad_cases, the kernel forward's output and a cotangent."""
    import torch
    from diart_tpu_torch.ops import lstm_sweep

    n = lambda *s: torch.randn(*s, generator=cgen, device="cuda")
    proj = n(time_, 2, batch, 4 * hidden).to(dtype)
    w_hh = n(2, 4 * hidden, hidden) * (0.3 / (hidden / 8) ** 0.5)
    with torch.no_grad():
        out = lstm_sweep.lstm_sweep_tm(proj, w_hh)
    return proj, w_hh, out, n(time_, 2, batch, hidden).to(dtype)


def kernel_only_ms(proj, w_hh, out, dout, iters=10, launch=None, pack=None):
    """A backward kernel's launch alone (CUDA events around each launch;
    its in-place input is refilled before each, outside the events):
    ``launch(proj, pre, dout, wp)`` with ``wp = pack(w_hh, dtype)``, by
    default the port's (``_launch_backward``, ``pack_backward_w``)."""
    import torch
    from diart_tpu_torch.ops import lstm_sweep

    launch = launch or lstm_sweep._launch_backward
    pack = pack or lstm_sweep.pack_backward_w
    w = w_hh.to(proj.dtype).float()
    hr = lstm_sweep._prev_hidden(out)
    pre = lstm_sweep._recurrent_products(hr, w)
    wp = pack(w_hh, proj.dtype)
    work = torch.empty_like(pre)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters + 1)]
    for a, b in pairs:
        work.copy_(pre)
        a.record()
        launch(proj, work, dout, wp)
        b.record()
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs[1:]]))


# Kernels built in the script's own scratch build (``build/smoke/``) from
# sources that include the package's, for A B B A turns against the routes
# the package now takes at H = 128: the backward's column route (the route
# of the other widths) and the forward's FMA route (the route of the other
# widths; f32 at H = 128 before the split route), each exported at every H
# under another name
COLUMN_SOURCE = """#include "lstm_sweep_bwd.cu"

extern "C" int lstm_sweep_bwd_column_launch(const void* proj, void* gates, const void* dout,
                                            const void* wp, void* cells, int time, int batch,
                                            int hidden, int dtype, int num_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_column<float>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
  return launch_column<__nv_bfloat16>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
}
"""
FMA_SOURCE = """#include "lstm_sweep.cu"

extern "C" int lstm_sweep_fma_launch(const void* proj, const void* wp, void* out, int time, int batch,
                                     int hidden, int num_sms, void* stream) {
  return launch<float>(proj, wp, out, time, batch, hidden, num_sms, static_cast<cudaStream_t>(stream));
}
"""
# ... and the f32 FMA routes that the TF32 tensor-core routes replaced at
# the main paths' widths: the SE-Res2Block with every product on FMAs
# (`tdnn_fma`, `res2_cascade_fma`) and the stats head's `linear_stats_fma`
RES2_FMA_SOURCE = """#include "se_res2.cu"

extern "C" int se_res2_fma_block_launch(const void* x, void* out, void* cat, void* part, void* gate,
                                        const void* w1, const void* v1, const void* wg, const void* vg,
                                        const void* w2, const void* v2, const void* ws1, const void* bs1,
                                        const void* ws2, const void* bs2, const void* w1s, const void* wgs,
                                        const void* w2s, int batch, int time, int chans, int groups, int taps,
                                        int hidden, int dilation, int tile, int dtype, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Operands k{w1, wg, w2, f(v1), f(vg), f(v2), f(ws1), f(bs1), f(ws2), f(bs2), f(w1s), f(wgs), f(w2s)};
  return block(x, out, cat, static_cast<float*>(part), static_cast<float*>(gate), k, batch, time, chans,
               groups, taps, hidden, dilation, tile, dtype, false, static_cast<cudaStream_t>(stream));
}
"""
STATS_FMA_SOURCE = """#include "linear_stats.cu"

extern "C" int linear_stats_fma_launch(const void* x, const void* w, const void* bias, const void* scale,
                                       const void* shift, const void* wt, void* s1, void* s2, int batch,
                                       int time, int cin, int channels, int ldw, int speakers, float slope,
                                       void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
#define FMA_CASE(S_) \\
  case S_:           \\
    return launch_fma<float, S_>(x, w, f(bias), f(scale), f(shift), f(wt), o1, o2, batch, time, cin, channels, ldw, slope, s);
  switch (speakers) {
    FMA_CASE(1) FMA_CASE(2) FMA_CASE(3) FMA_CASE(4) FMA_CASE(5) FMA_CASE(6) FMA_CASE(7) FMA_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
SCRATCH_KERNELS = {  # library -> (source, entry point, its ctypes argument kinds)
    "lstm_sweep_bwd_column": (COLUMN_SOURCE, "lstm_sweep_bwd_column_launch", "pppppiiiiip"),
    "lstm_sweep_fma": (FMA_SOURCE, "lstm_sweep_fma_launch", "pppiiiip"),
    "se_res2_fma": (RES2_FMA_SOURCE, "se_res2_fma_block_launch", "p" * 18 + "i" * 9 + "p"),
    "linear_stats_fma": (STATS_FMA_SOURCE, "linear_stats_fma_launch", "p" * 8 + "i" * 6 + "fp"),
}
SCRATCH_BUILDS = {}  # library -> the nvcc process and the library's path, started beside the package's builds
BUILD_LOGS = {}  # the package's nvcc output (-Xptxas -v) by library


def start_scratch_builds():
    """Start nvcc on each SCRATCH_KERNELS source (with the package's flags)
    into ``build/smoke/`` beside this script; ``scratch_library`` waits."""
    from diart_tpu_torch.ops import _build

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
    os.makedirs(out, exist_ok=True)
    for name, (source, _, _) in SCRATCH_KERNELS.items():
        src = os.path.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(source)
        so = os.path.join(out, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src]
        SCRATCH_BUILDS[name] = dict(so=so, proc=subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                                 stderr=subprocess.STDOUT, text=True))


def stop_scratch_builds():
    for build in SCRATCH_BUILDS.values():
        if build["proc"].poll() is None:
            build["proc"].kill()


def scratch_library(name):
    """A scratch kernel's library, loaded (its build waited for; raises if
    it failed), and its entry point."""
    import ctypes

    build = SCRATCH_BUILDS[name]
    if "lib" not in build:
        text = build["proc"].communicate()[0]
        if build["proc"].returncode != 0:
            raise AssertionError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(build["so"])
        _, entry, kinds = SCRATCH_KERNELS[name]
        fn = getattr(lib, entry)
        fn.argtypes = [dict(p=ctypes.c_void_p, i=ctypes.c_int, f=ctypes.c_float)[k] for k in kinds]
        fn.restype = ctypes.c_int
        build.update(lib=lib, fn=fn, log=text)
    return build["fn"]


def column_launch(proj, pre, dout, wp):
    """The column kernel on CUDA tensors (``wp`` in its layout,
    ``lstm_sweep._pack_column``): ``pre`` overwritten with da. Not counted:
    a comparison, not the path."""
    import torch
    from diart_tpu_torch.ops import _build, lstm_sweep

    time_, _, batch, gates4 = proj.shape
    cells = torch.empty(2, time_, batch, gates4 // 4, dtype=torch.float32, device=proj.device)
    err = scratch_library("lstm_sweep_bwd_column")(
        proj.data_ptr(), pre.data_ptr(), dout.data_ptr(), wp.data_ptr(), cells.data_ptr(), time_, batch,
        gates4 // 4, lstm_sweep._DTYPES[proj.dtype], _build.num_sms(proj.device),
        _build.stream_handle(proj.device))
    if err != 0:
        raise AssertionError(f"the column kernel failed to launch: cudaError {err}")
    return pre


def column_backward(proj, w_hh, out, dout):
    """The whole backward with the column kernel between the same products."""
    from diart_tpu_torch.ops import lstm_sweep

    return lstm_sweep._backward(proj, w_hh, out, dout,
                                lambda p, pre, d, w: column_launch(p, pre, d, lstm_sweep._pack_column(w, p.dtype)))


PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PTXAS_KERNEL = re.compile(r"lstm_sweep_bwd_(split|kernel)I(f|13__nv_bfloat16)((?:Li\d+E)+)(?:Lb([01])E)?")
PTXAS_SPLIT = re.compile(r"lstm_sweep_splitI((?:Li\d+E)+)E")  # the forward's split route: <H, BT>


def ptxas_records(text):
    """-Xptxas -v's registers, shared memory and spill bytes of each
    instantiation of the backward kernel, and of the forward's split route,
    in an nvcc log."""
    recs, cur = [], None
    for line in text.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            k = PTXAS_KERNEL.search(m.group(1))
            f = PTXAS_SPLIT.search(m.group(1))
            cur = None
            if f:
                h, bt = (int(v) for v in re.findall(r"Li(\d+)E", f.group(1)))
                cur = dict(route="split", dtype="f32", H=h, BT=bt, phase_a_only=False)
                recs.append(cur)
            elif k:
                ints = [int(v) for v in re.findall(r"Li(\d+)E", k.group(3))]
                cur = dict(route="split" if k.group(1) == "split" else "column",
                           dtype="f32" if k.group(2) == "f" else "bf16",
                           H=ints[0] if k.group(1) == "split" else None, BT=ints[-1],
                           phase_a_only=k.group(4) == "1")
                recs.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return recs


def backward_profile(call, what, calls=5):
    """A profile of ``calls`` backwards: their device rows, the kernel's
    device ms a launch and the device launches of one backward (every row's
    launches over the kernel's). Late in a long run the profiler loses some
    calls' events, or all of them: then the readings are None (logged, not
    measured); they are records, not checks."""
    try:
        rows = device_times(call, what, calls)
    except AssertionError as exc:
        log(f"  {exc}: the kernel's device ms and the backward's launches not measured")
        return [], None, None
    kernel = [r for r in rows if r[0].startswith("lstm_sweep_bwd")]
    if not kernel:
        log(f"  the profile of {what} holds no launch of the kernel: not measured ({rows})")
        return rows, None, None
    seen = kernel[0][2]  # the kernel's launches a call that the profile kept
    return rows, kernel[0][1] / seen, round(sum(r[2] for r in rows) / seen)


def abba(a, b):
    """Two readings taken in turns a, b, b, a: ([a1, a2], [b1, b2])."""
    a1, b1 = a(), b()
    b2, a2 = b(), a()
    return [a1, a2], [b1, b2]


def check_split_build(library="lstm_sweep_bwd"):
    """-Xptxas -v of the backward kernel's library (or of the forward's,
    ``lstm_sweep``): every instantiation's registers, shared memory, stack
    frame and spill bytes, logged; none may spill on the split route (W in
    registers), and the forward's split route keeps no array in local
    memory (a stack frame: its sums, indexed at run time)."""
    recs = ptxas_records(BUILD_LOGS.get(library, ""))
    for r in recs:
        log(f"  [{library}] {r['route']} {r['dtype']} H={r['H']} BT={r['BT']}"
            f"{' (phase A alone)' if r['phase_a_only'] else ''}: {r.get('registers')} registers, "
            f"{r.get('smem')} bytes smem, stack frame {r.get('stack_frame')} bytes, spill stores "
            f"{r.get('spill_stores')} / loads {r.get('spill_loads')}")
    split = [r for r in recs if r["route"] == "split"]
    if not split:
        raise AssertionError(f"no -Xptxas -v record of the split route's instantiations in {library}'s build log")
    bad = [r for r in split if r.get("spill_stores") or r.get("spill_loads") or "registers" not in r
           or (library == "lstm_sweep" and r.get("stack_frame"))]
    if bad:
        raise AssertionError(f"the split route spills or keeps an array in local memory (W in registers): {bad}")
    return recs


# the f32 routes on the TF32 tensor cores, by library: each kernel and the
# tensor-core instruction its design issues (`wgmma`: HGMMA; `mma.sync`: HMMA)
TF32_KERNELS = {
    "se_res2": (("tdnn_wgmma_tf32", "HGMMA"), ("res2_cascade_tf32", "HMMA")),
    "linear_stats": (("linear_stats_wgmma_tf32", "HGMMA"),),
}


def ptxas_entries(text):
    """-Xptxas -v's record of every entry function in an nvcc log: its
    mangled name, registers, shared memory, stack frame and spill bytes."""
    recs, cur = [], None
    for line in text.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            cur = dict(entry=m.group(1))
            recs.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return recs


def check_tf32_build(library):
    """The library's f32 tensor-core kernels (TF32_KERNELS) as built:
    ptxas' report of every instantiation (none may spill or keep a stack
    frame) and the SASS (``cuobjdump --dump-sass``): every instantiation
    issues its design's tensor-core instruction on TF32 operands."""
    from diart_tpu_torch.ops import _build

    kernels = TF32_KERNELS[library]
    recs = [dict(r, kernel=name) for r in ptxas_entries(BUILD_LOGS.get(library, ""))
            for name, _ in kernels if name in r["entry"]]
    for r in recs:
        log(f"  [{library}] {r['entry']}: {r.get('registers')} registers, {r.get('smem')} bytes smem, stack frame "
            f"{r.get('stack_frame')} bytes, spill stores {r.get('spill_stores')} / loads {r.get('spill_loads')}")
    missing = [name for name, _ in kernels if not any(r["kernel"] == name for r in recs)]
    bad = [r for r in recs if r.get("spill_stores") or r.get("spill_loads") or r.get("stack_frame")
           or "registers" not in r]
    if missing or bad:
        raise AssertionError(f"{library}'s f32 tensor-core kernels: no ptxas record of {missing}, or a spill or "
                             f"stack frame: {bad}")
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    so = str(_build.BUILD_DIR / f"lib{library}.so")
    text = subprocess.run([tool, "--dump-sass", so], capture_output=True, text=True, timeout=120).stdout
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    sass = {}
    for name, op in kernels:
        mine = [f for f in funcs if name in f.split("\n", 1)[0]]
        found = [sorted(set(re.findall(rf"\b{op}\.[\w.]+", f))) for f in mine]
        sass[name] = dict(instantiations=len(mine), instructions=sum(len(re.findall(rf"\b{op}\.", f)) for f in mine),
                          forms=sorted({x for fs in found for x in fs}))
        log(f"  [{library}] SASS of {name}: {len(mine)} instantiations, {sass[name]['instructions']} {op} "
            f"instructions, forms {sass[name]['forms']}")
        if not mine or not all(any("TF32" in x for x in fs) for fs in found):
            raise AssertionError(f"{library}: every instantiation of {name} must issue {op} on TF32 operands: {sass[name]}")
    return dict(ptxas=recs, sass=sass)


def check_sweep_backward():
    """The sweep's backward on the card (``lstm_sweep_backward``: the bulk
    products around the backward kernel) against its plain version
    (``lstm_sweep_backward_reference`` on the same CUDA tensors, the kernel
    forward's output and a seeded cotangent) at (293, B, 128) for B = 64
    and the trainer's 32, bf16 and f32, within KERNEL_GRAD_TOL of the
    largest gradient, bitwise over two calls, on the split route with no
    row of W through L2. The column kernel on the same inputs (within the
    same tolerance) and both kernels' ms in A B B A turns (the column
    kernel's first). At
    B = 64 also: phase A alone, the kernel's device ms (profiler), the
    whole backward's ms with each kernel (A B B A) and device launches, the
    two batched products alone, the plain backward's ms, autograd through
    the plain forward (the backward before the kernel), cuDNN's LSTM backward of
    the same (T, B, H) with 2H inputs (a yardstick the port never calls),
    the bound, the argued latency floor and the clusters the card holds."""
    import torch
    from diart_tpu_torch.ops import lstm_sweep
    from diart_tpu_torch.ops._numerics import true_f32

    out_rec = {}
    column_kernel_ms = lambda a: kernel_only_ms(*a, launch=column_launch, pack=lstm_sweep._pack_column)
    for key, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cgen = torch.Generator(device="cuda").manual_seed(17)
        for batch in SWEEP_BWD_BATCHES:
            args = sweep_bwd_inputs(T_LSTM, batch, dtype, cgen)
            proj, w_hh, out, dout = args
            got = lstm_sweep.lstm_sweep_backward(*args)
            want = lstm_sweep.lstm_sweep_backward_reference(*args)
            torch.cuda.synchronize()
            scale = max(w.float().abs().max().item() for w in want)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            tol = KERNEL_GRAD_TOL[key] * scale
            finite = all(torch.isfinite(g).all().item() for g in got)
            again = lstm_sweep.lstm_sweep_backward(*args)
            deterministic = bitwise_equal(got, again)
            plan = lstm_sweep.backward_plan(batch, H, dtype, proj.device)
            column = column_backward(*args)
            column_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(column, want))
            a_ms, b_ms = abba(lambda: column_kernel_ms(args), lambda: kernel_only_ms(*args))
            rec = dict(max_abs_err=err, tol=tol, grad_scale=scale, deterministic=deterministic, plan=plan,
                       column_max_abs_err=column_err, ms=float(np.mean(b_ms)), ms_turns=b_ms,
                       ms_column=float(np.mean(a_ms)), ms_column_turns=a_ms)
            log(f"lstm_sweep_bwd[{key}] T={T_LSTM} B={batch} H={H} plan={plan}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e} = {KERNEL_GRAD_TOL[key]:.0e} x the largest gradient {scale:.3e}); "
                f"bitwise over two calls: {deterministic}; the column kernel {column_err:.3e}")
            log(f"lstm_sweep_bwd[{key}] B={batch} A B B A (A: the column kernel, B: the split route), ms: "
                f"{a_ms[0]:.4f} {b_ms[0]:.4f} {b_ms[1]:.4f} {a_ms[1]:.4f}")
            if not (finite and err <= tol and deterministic):
                raise AssertionError(f"lstm_sweep_bwd[{key}] B={batch} disagrees with its plain version")
            if plan["route"] != "split" or plan["w_rows_in_l2"] or plan["w_rows_in_registers"] != 4 * H:
                raise AssertionError(f"lstm_sweep_bwd[{key}] B={batch}: W is not held on chip ({plan})")
            if not column_err <= tol:
                raise AssertionError(f"the column kernel [{key}] B={batch} disagrees with the plain version")
            if batch == B:
                phase_a = kernel_only_ms(*args, launch=lstm_sweep._launch_phase_a)
                dev_rows, dev_ms, launches = backward_profile(
                    lambda: lstm_sweep.lstm_sweep_backward(*args), f"lstm_sweep_bwd[{key}]")
                a_whole, b_whole = abba(lambda: time_ms(lambda: column_backward(*args), 10),
                                        lambda: time_ms(lambda: lstm_sweep.lstm_sweep_backward(*args), 10))
                w = w_hh.to(dtype).float()
                hr = lstm_sweep._prev_hidden(out)
                with true_f32(proj.device):
                    pre = lstm_sweep._recurrent_products(hr, w)
                    products_ms = dict(
                        recurrent=time_ms(lambda: lstm_sweep._recurrent_products(hr, w), 10),
                        weight_gradient=time_ms(lambda: lstm_sweep._gradients(pre, hr, dtype, w_hh.dtype), 10))
                del pre
                clusters = lstm_sweep.backward_max_clusters(batch, dtype, proj.device)
                plain_ms = time_ms(lambda: lstm_sweep.lstm_sweep_backward_reference(*args), 2, warmup=1)
                leaves = [proj.detach().requires_grad_(True), w_hh.detach().requires_grad_(True)]
                ref_out = lstm_sweep.lstm_sweep_reference(*leaves)
                autograd_ms = time_ms(lambda: torch.autograd.grad(ref_out, leaves, dout, retain_graph=True), 2,
                                      warmup=1)
                del ref_out, leaves
                # yardstick only: cuDNN's bidirectional LSTM backward over the
                # same (T, B, H) with 2H inputs (layers 2-4 of PyanNet), data
                # and weight gradients (w_ih's too: more than the sweep's)
                lstm = torch.nn.LSTM(2 * H, H, bidirectional=True).to("cuda", dtype)
                lstm.flatten_parameters()
                xin = torch.randn(T_LSTM, batch, 2 * H, generator=cgen, device="cuda").to(dtype).requires_grad_(True)
                y = lstm(xin)[0]
                ycot = torch.randn(y.shape, generator=cgen, device="cuda").to(dtype)
                lib_ms = time_ms(lambda: torch.autograd.grad(y, [xin, *lstm.parameters()], ycot, retain_graph=True),
                                 10)
                del lstm, xin, y, ycot
                elt = proj.element_size()
                gemm = 2.0 * T_LSTM * 2 * batch * 4 * H * H
                # the kernel: proj, the recurrent products and dout read, da written, W read
                k_bytes = proj.numel() * elt + 2 * proj.numel() * 4 + dout.numel() * elt + w_hh.numel() * elt
                k_bound, k_by = bound_ms(k_bytes, gemm, "f32")
                # the whole backward: proj, w_hh, out, dout read, dproj, dw_hh written; three
                # f32 products (the recurrent products, the walk's, the weight gradient)
                w_bytes = (2 * proj.numel() + 2 * out.numel()) * elt + 2 * w_hh.numel() * 4
                w_bound, w_by = bound_ms(w_bytes, 3 * gemm, "f32")
                # phase A alone: proj and the recurrent products read, the six
                # values a cell of phase B written (four over pre, two in its scratch)
                a_bytes = proj.numel() * elt + 2 * proj.numel() * 4 + proj.numel() // 2 * 4
                a_bound = a_bytes / HBM_BYTES_PER_S * 1e3
                clock = sm_clock_hz()
                floor_ms = T_LSTM * LSTM_BWD_STEP_FLOOR_CYCLES / clock * 1e3
                ms = rec["ms"]
                rec.update(device_ms=dev_ms, device_rows=[list(r) for r in dev_rows],
                           backward_ms=float(np.mean(b_whole)), backward_ms_turns=b_whole,
                           backward_ms_column=float(np.mean(a_whole)), backward_ms_column_turns=a_whole,
                           backward_launches=launches, phase_a_ms=phase_a, phase_a_share=phase_a / ms,
                           phase_a_bound_ms=a_bound,
                           cycles_a_step=(ms - phase_a) * 1e-3 * clock / T_LSTM, products_ms=products_ms,
                           max_clusters=clusters, plain_ms=plain_ms, autograd_plain_ms=autograd_ms,
                           library_ms=lib_ms, bound_ms=k_bound, bound_by=k_by, backward_bound_ms=w_bound,
                           backward_bound_by=w_by, argued_latency_floor_ms=floor_ms)
                log(f"lstm_sweep_bwd[{key}] B={batch}: kernel_ms={ms:.4f} (device {rec['device_ms']}; the column "
                    f"kernel {rec['ms_column']:.4f}) bound_ms={k_bound:.5f} ({k_by}) argued latency_floor_ms="
                    f"{floor_ms:.4f} ({LSTM_BWD_STEP_FLOOR_CYCLES} cycles a step at the card's highest clock; not "
                    f"a measurement); phase A alone {phase_a:.4f} ms ({phase_a / ms:.3f} of the kernel; its bytes "
                    f"{a_bytes / 1e6:.1f} MB, {a_bound:.4f} ms at the HBM rate), phase B "
                    f"{rec['cycles_a_step']:.0f} cycles a step at the highest clock; the whole backward "
                    f"A B B A {a_whole[0]:.4f} {b_whole[0]:.4f} {b_whole[1]:.4f} {a_whole[1]:.4f} ms in "
                    f"{launches} device launches (bound {w_bound:.5f}, {w_by}); the recurrent products "
                    f"{products_ms['recurrent']:.4f} ms, the weight gradient {products_ms['weight_gradient']:.4f}; "
                    f"plain backward {plain_ms:.3f} ms; autograd through the plain forward {autograd_ms:.3f} ms; "
                    f"cuDNN LSTM backward (yardstick) {lib_ms:.4f} ms; clusters the card holds at once: "
                    f"{clusters} (the launch has {plan['blocks'] // plan['cluster']})")
                for name, dms, count in dev_rows:
                    log(f"  {dms:9.4f} ms x{count:4.1f}  {name}")
            out_rec.setdefault(key, {})[f"B{batch}"] = rec
            del proj, w_hh, out, dout, got, want, again, column, args
        cases = []
        for time_, batch, hidden in SWEEP_BWD_CASES:
            args = sweep_bwd_inputs(time_, batch, dtype, cgen, hidden)
            got = lstm_sweep.lstm_sweep_backward(*args)
            want = lstm_sweep.lstm_sweep_backward_reference(*args)
            again = lstm_sweep.lstm_sweep_backward(*args)
            scale = max(w.float().abs().max().item() for w in want)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            deterministic = bitwise_equal(got, again)
            plan = lstm_sweep.backward_plan(batch, hidden, dtype, args[0].device)
            log(f"  lstm_sweep_bwd[{key}] T={time_} B={batch} H={hidden} plan={plan}: max_abs_err={err:.3e} "
                f"(tol {KERNEL_GRAD_TOL[key] * scale:.3e}); bitwise over two calls: {deterministic}")
            if not (all(torch.isfinite(g).all().item() for g in got) and err <= KERNEL_GRAD_TOL[key] * scale
                    and deterministic):
                raise AssertionError(f"lstm_sweep_bwd[{key}] T={time_} B={batch} H={hidden} disagrees with its "
                                     f"plain version")
            cases.append(dict(T=time_, B=batch, H=hidden, max_abs_err=err, tol=KERNEL_GRAD_TOL[key] * scale,
                              deterministic=deterministic, plan=plan))
        out_rec[key]["cases"] = cases
    torch.cuda.empty_cache()
    return out_rec


def seg_step_abba(attr, other, what, steps=4):
    """The segmentation training step at full width, B=32, f32, in A B B A
    turns on one trainer: A with ``lstm_sweep.<attr>`` replaced by ``other``
    (``what``), B the port's own. Each turn: the median step wall over
    ``steps`` steps after one more, then one more step split into forward /
    backward / update (``step_split``)."""
    import torch
    from diart_tpu_torch import precision
    from diart_tpu_torch.ops import lstm_sweep

    port = getattr(lstm_sweep, attr)
    with precision.use(f32_policy()):
        model, state, opt, step = trainer("seg", "cuda")
        waves, targets = seg_batch(TRAIN_B, model.num_frames(TRAIN_SAMPLES), torch.Generator().manual_seed(3),
                                   "cuda")

        def turn(a):
            nonlocal state
            walls = []
            setattr(lstm_sweep, attr, other if a else port)
            try:
                for _ in range(steps + 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with plain_sweep_refused():
                        state, _ = step(state, waves, targets)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                split = step_split("seg", state, opt, waves, targets)
            finally:
                setattr(lstm_sweep, attr, port)
            return float(np.median(walls[1:])), split

        a, b = abba(lambda: turn(True), lambda: turn(False))
    fmt = lambda r: (f"{r[0]:.3f} (forward {r[1]['forward_ms']:.2f}, backward {r[1]['backward_ms']:.2f}, update "
                     f"{r[1]['update_ms']:.2f})")
    log(f"train[seg] step at B={TRAIN_B}, A B B A (A: {what}, B: the port), median ms: "
        f"{fmt(a[0])} {fmt(b[0])} {fmt(b[1])} {fmt(a[1])}")
    del model, state, opt
    torch.cuda.empty_cache()
    return dict(batch=TRAIN_B, steps=steps, other=what, step_ms=float(np.mean([r[0] for r in b])),
                step_ms_turns=[r[0] for r in b], split_ms_turns=[r[1] for r in b],
                step_ms_other=float(np.mean([r[0] for r in a])), step_ms_other_turns=[r[0] for r in a],
                split_ms_other_turns=[r[1] for r in a])


def fma_forward(port):
    """``lstm_sweep._launch`` (``port``) with the f32 stream at H = 128 on the
    FMA route (built in build/smoke/) instead of the split route."""
    from diart_tpu_torch.ops import lstm_sweep

    def launch(proj_t, packed):
        if packed.route != "split":
            return port(proj_t, packed)
        return fma_launch(proj_t, lstm_sweep._pack_fma(lstm_sweep.unpack_w_hh(packed), proj_t.dtype))
    return launch


def step_split(kind, state, opt, waves, targets):
    """One more training step, split with CUDA events as ``train_step`` runs
    it: forward, backward and update ms."""
    import torch

    module, ev = state.module, [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    with plain_sweep_refused():
        ev[0].record()
        if kind == "seg":
            from diart_tpu_torch.train import pit_bce_loss

            loss = pit_bce_loss(module(waves), targets)
        else:
            from diart_tpu_torch.train import aam_softmax_loss

            loss = aam_softmax_loss(module(waves), targets, state.prototypes)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
    return dict(forward_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
                update_ms=ev[2].elapsed_time(ev[3]))


@contextlib.contextmanager
def plain_sweep_refused():
    """While open, the sweep's plain forward and plain backward raise on a
    CUDA tensor: a training step on the card runs neither (no autograd
    through the plain step loop)."""
    import torch
    from diart_tpu_torch.ops import lstm_sweep

    names = ("lstm_sweep_reference", "lstm_sweep_backward_reference", "_bptt_reference")
    saved = {n: getattr(lstm_sweep, n) for n in names}

    def refuse(name, fn):
        def guarded(*args):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{name} ran on a CUDA tensor in a training step")
            return fn(*args)
        return guarded

    for n, fn in saved.items():
        setattr(lstm_sweep, n, refuse(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(lstm_sweep, n, fn)


def seg_batch(batch, frames, gen, device):
    """A fixed seeded segmentation batch: (B, 1, 5 s) noise waveforms and
    random 4-speaker targets."""
    import torch

    waves = 0.1 * torch.randn(batch, 1, TRAIN_SAMPLES, generator=gen)
    targets = (torch.rand(batch, frames, 4, generator=gen) > 0.6).float()
    return waves.to(device), targets.to(device)


def speaker_batch(batch, rng, device):
    """(B, 1, 5 s) chunks of TRAIN_CLASSES tone-plus-noise speakers (a
    fundamental and two harmonics each, random phase), and their labels."""
    import torch

    t = np.arange(TRAIN_SAMPLES) / 16000.0
    labels = np.arange(batch) % TRAIN_CLASSES
    waves = []
    for k in labels:
        f0 = 140.0 + 45.0 * k
        wave = sum(a * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 2 * np.pi))
                   for h, a in ((1, 0.3), (2, 0.15), (3, 0.08)))
        waves.append(wave + 0.05 * rng.normal(size=t.size))
    waves = torch.from_numpy(np.stack(waves).astype(np.float32))[:, None, :]
    return waves.to(device), torch.from_numpy(labels).to(device)


def trainer(kind, device, dtype="f32", seed=0):
    """(model, state, optimizer, step(state) -> (state, loss)) of one trainer
    at full width: ``seg`` (tpu/pyannet, PIT-BCE) or an embedding family
    (AAM-softmax over TRAIN_CLASSES)."""
    from diart_tpu_torch import EmbeddingModel, SegmentationModel
    from diart_tpu_torch.train import (embedding_train_step, make_embedding_train_state, make_train_state,
                                       train_step)

    if kind == "seg":
        model = SegmentationModel.from_registry("tpu/pyannet", device=device, seed=seed)
        state, opt = make_train_state(model, learning_rate=TRAIN_LR[kind])
        return model, state, opt, lambda s, w, y: train_step(lambda m, x: m(x), opt, s, w, y)
    model = EmbeddingModel.from_registry(EMBEDDINGS[kind], device=device, seed=seed + 1, dtype=dtype)
    state, opt = make_embedding_train_state(model, TRAIN_CLASSES, model.embedding_dim,
                                            learning_rate=TRAIN_LR[kind], seed=seed)
    return model, state, opt, lambda s, w, y: embedding_train_step(lambda m, x: m(x), opt, s, w, y)


def f32_policy():
    from diart_tpu_torch.precision import Precision

    return Precision(bf16_lstm=False, bf16_frontend=False)


def named_grads(state):
    """(name, gradient) of every trained parameter, the prototypes included."""
    pairs = [(n, p.grad) for n, p in state.module.named_parameters()]
    return pairs + ([("prototypes", state.prototypes.grad)] if state.prototypes is not None else [])


def check_all_gradients(state, what):
    """Every parameter has a finite, nonzero gradient; the smallest norms."""
    import torch

    bad = [n for n, g in named_grads(state) if g is None or not torch.isfinite(g).all().item()
           or g.abs().max().item() == 0.0]
    if bad:
        raise AssertionError(f"{what}: no finite nonzero gradient for {bad[:12]} ({len(bad)} parameters)")
    norms = sorted((g.norm().item(), n) for n, g in named_grads(state))
    return len(norms), norms[:3]


def train_full_width(kind, model_dtype, launches_per_step, serve_probe):
    """TRAIN_STEPS AdamW steps of trainer ``kind`` at full width and B=32 on
    the card: finite losses, the last below the first, every parameter's
    gradient finite and nonzero, each kernel's launches a step; then the
    forward / backward / update split of one more step (CUDA events), its
    device busy and idle share (a profile), and the trained model serving
    its new weights."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    counters = launch_counters()
    model, state, opt, step = trainer(kind, "cuda", model_dtype)
    if kind == "seg":
        waves, targets = seg_batch(TRAIN_B, model.num_frames(TRAIN_SAMPLES), torch.Generator().manual_seed(3),
                                   "cuda")
    else:
        waves, targets = speaker_batch(TRAIN_B, np.random.default_rng(3), "cuda")
    before = serve_probe(model)  # held kernel operands made before training
    losses, walls, launches = [], [], []
    for _ in range(TRAIN_STEPS):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_sweep_refused():
            state, loss = step(state, waves, targets)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: fn.launches for k, fn in counters.items()})
        losses.append(loss)
    losses = [float(l) for l in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train[{kind}]: losses {losses} (finite, the last below the first)")
    if any(l != launches_per_step for l in launches):
        raise AssertionError(f"train[{kind}]: expected {launches_per_step} launches a step; got {launches}")
    n_params, smallest = check_all_gradients(state, f"train[{kind}]")
    f1 = None
    if kind == "ecapa":  # F1: every SE-Res2Block parameter is trained
        blocks = [(n, g) for n, g in named_grads(state) if n.startswith("block")]
        f1 = len(blocks)
        if not blocks or any(g.abs().max().item() == 0.0 for _, g in blocks):
            raise AssertionError("train[ecapa]: an SE-Res2Block parameter has no gradient")
    if kind == "seg":  # F2: SincNet and every LSTM layer's w_ih and w_hh
        names = {n for n, _ in named_grads(state)}
        want = {f"lstm.l{i}_{w}" for i in range(model.module.lstm.num_layers) for w in ("w_ih", "w_hh")}
        if not want <= names or not any(n.startswith("sincnet.") for n in names):
            raise AssertionError(f"train[seg]: parameters missing from the check: {sorted(want - names)}")

    split = step_split(kind, state, opt, waves, targets)  # one more step, split with CUDA events
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, plain_sweep_refused():
        t0 = time.perf_counter()
        state, _ = step(state, waves, targets)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    dev = device_summary(prof, 1)
    idle = max(0.0, 1.0 - dev["device_busy_ms"] / prof_wall)

    # the trained model serves its new weights: a no-grad engine step on it
    # (held operands remade) equals one on a fresh model loaded with them
    after = serve_probe(model)
    fresh, *_ = trainer(kind, "cuda", model_dtype, seed=7)
    fresh.module.load_state_dict(model.module.state_dict())
    again = serve_probe(fresh)
    if not bitwise_equal(after, again) or bitwise_equal(after, before):
        raise AssertionError(f"train[{kind}]: the trained model does not serve its new weights")

    step_ms = float(np.median(walls[1:]))
    rec = dict(batch=TRAIN_B, steps=TRAIN_STEPS, lr=TRAIN_LR[kind], losses=losses, step_wall_ms=step_ms,
               step_wall_ms_all=walls, launches_per_step=launches[-1], params_with_grad=n_params,
               smallest_grad_norms=smallest, split_ms=split, profiled_step_wall_ms=prof_wall,
               device_busy_ms=dev["device_busy_ms"], device_launches=dev["kernels_per_step"],
               idle_share=idle, top_device_items=dev["top_device_items"][:8], f1_block_params=f1)
    log(f"train[{kind}] full width, B={TRAIN_B}, {TRAIN_STEPS} AdamW steps at lr {TRAIN_LR[kind]}: losses "
        + " ".join(f"{l:.4f}" for l in losses)
        + f"; every one of {n_params} parameters has a finite nonzero gradient (smallest norms "
        + ", ".join(f"{n} {v:.2e}" for v, n in smallest) + f"); launches a step {launches[-1]}"
        + (f"; all {f1} SE-Res2Block parameters trained" if f1 else ""))
    log(f"train[{kind}] step wall median {step_ms:.2f} ms (all: {', '.join(f'{w:.1f}' for w in walls)}"
        + ("; with autograd through the plain step loop as the sweep's backward: 640-1157 ms on an H100 80GB HBM3"
           if kind == "seg" else "") + "); "
        f"forward {split['forward_ms']:.2f} ms, backward {split['backward_ms']:.2f} ms, update "
        f"{split['update_ms']:.2f} ms; profiled step: wall {prof_wall:.2f} ms, device busy "
        f"{dev['device_busy_ms']:.2f} ms ({dev['kernels_per_step']:.0f} device launches), idle share "
        f"{idle:.3f}; the trained model serves its new weights (bitwise equal to a fresh load)")
    for item in rec["top_device_items"][:5]:
        log(f"  {item['ms_per_step']:8.3f} ms  x{item['per_step']:6.1f}  {item['name']}")
    del state, opt, model, fresh
    torch.cuda.empty_cache()
    return rec


def engine_probe(kind):
    """A no-grad engine probe of a trained model beside a fixed partner:
    ``probe_frame_scores`` after 10 hops of 2 streams (the segmentation
    scores, or the embeddings)."""
    import torch
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    audio = make_audio(np.random.default_rng(9), WARMUP_HOPS + 1, 2, 8000)

    def probe(model):
        if kind == "seg":
            seg, emb = model, EmbeddingModel.from_registry("tpu/xvector", device="cuda", seed=1, dtype="bf16")
        else:
            seg, emb = SegmentationModel.from_registry("tpu/pyannet", device="cuda", seed=0), model
        engine = MultiStreamEngine(seg, emb, duration=5.0, step=0.5, latency=0.5, sample_rate=16000,
                                   max_speakers=20, batch_size=2)
        state = engine.init_state()
        for i in range(WARMUP_HOPS):
            state, _ = engine.step(state, audio[i], run_mask=np.full(2, i + 1 >= WARMUP_HOPS))
        s, e = engine.probe_frame_scores(state, audio[WARMUP_HOPS])
        torch.cuda.synchronize()
        return (s.clone(), e.clone())

    return probe


def compare_trainer_cpu(kind):
    """One f32 step of trainer ``kind`` on 2 samples on the card and on the
    CPU from the same weights: the loss, every gradient and every updated
    parameter."""
    import torch

    out = []
    for device in ("cuda", "cpu"):
        model, state, opt, step = trainer(kind, device, "f32")
        if kind == "seg":
            waves, targets = seg_batch(2, model.num_frames(TRAIN_SAMPLES), torch.Generator().manual_seed(4), device)
        else:
            waves, targets = speaker_batch(2, np.random.default_rng(4), device)
        with plain_sweep_refused():
            state, loss = step(state, waves, targets)
        grads = {n: g.detach().cpu() for n, g in named_grads(state)}
        params = {n: p.detach().cpu() for n, p in state.module.named_parameters()}
        if state.prototypes is not None:
            params["prototypes"] = state.prototypes.detach().cpu()
        out.append((float(loss), grads, params))
    (lc, gc, pc), (lh, gh, ph) = out
    loss_err = abs(lc - lh) / abs(lh)
    top_norm = max(g.norm().item() for g in gh.values())
    largest = max(g.abs().max().item() for g in gh.values())
    rel, bad = [], []
    for n, g in gh.items():
        d = (gc[n] - g)
        if g.norm().item() >= 1e-6 * top_norm:
            rel.append((d.norm().item() / g.norm().item(), n))
            if rel[-1][0] > CPU_GRAD_TOL:
                bad.append(n)
        elif d.abs().max().item() > 1e-6 * largest:
            bad.append(n)
    rel.sort(reverse=True)
    lr = TRAIN_LR[kind]
    param_err = max(((pc[n] - p).abs() - 2.0**-22 * p.abs()).max().item() for n, p in ph.items())
    log(f"train[{kind}] card vs CPU, one f32 step on 2 samples: loss {lc:.6f} / {lh:.6f} (rel err "
        f"{loss_err:.2e}, tol {CPU_LOSS_TOL:.0e}); gradients norm-wise within {rel[0][0]:.2e} (tol "
        f"{CPU_GRAD_TOL:.0e}; largest: " + ", ".join(f"{n} {e:.2e}" for e, n in rel[:3])
        + f"); updated parameters within {param_err:.2e} beyond two roundings (tol {2 * lr:.0e})")
    if bad or not (loss_err <= CPU_LOSS_TOL and param_err <= 2 * lr):
        raise AssertionError(f"train[{kind}] card vs CPU disagree (gradients of {bad})")
    return dict(loss_rel_err=loss_err, grad_norm_rel_err=rel[0][0], grad_worst=rel[:5],
                param_max_abs_err=param_err)


def check_resume(tmp):
    """The segmentation trainer at full width, B=8: 3 steps, save, restore
    into a fresh state (other weights, fresh moments), 3 more steps give
    the bits of 6 straight steps (cuDNN's deterministic algorithms)."""
    import torch
    from diart_tpu_torch.train import restore_train_state, save_train_state

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with plain_sweep_refused():
            model, straight, _, step = trainer("seg", "cuda")
            waves, targets = seg_batch(RESUME_B, model.num_frames(TRAIN_SAMPLES), torch.Generator().manual_seed(5),
                                       "cuda")
            losses = []
            for _ in range(2 * 3):
                straight, loss = step(straight, waves, targets)
                losses.append(loss)
            _, resumed, _, step2 = trainer("seg", "cuda")
            for _ in range(3):
                resumed, _ = step2(resumed, waves, targets)
            path = save_train_state(os.path.join(tmp, "ckpt"), resumed)
            _, again, _, step3 = trainer("seg", "cuda", seed=9)
            again = restore_train_state(os.path.join(tmp, "ckpt"), again)
            tail = []
            for _ in range(3):
                again, loss = step3(again, waves, targets)
                tail.append(loss)
            same_loss = all(torch.equal(a, b) for a, b in zip(tail, losses[3:]))
            same_params = bitwise_equal(list(straight.module.state_dict().values()),
                                        list(again.module.state_dict().values()))
            diff = max((a - b).abs().max().item() for a, b in zip(straight.module.state_dict().values(),
                                                                   again.module.state_dict().values()))
    finally:
        torch.backends.cudnn.deterministic = prev
    log(f"checkpoint: 3 steps, {os.path.basename(path)} saved and restored into a fresh state, 3 more: "
        f"losses bitwise {same_loss}, parameters bitwise {same_params} (max diff {diff:.3e}) against 6 "
        f"straight steps")
    if not (same_loss and same_params and again.step == 6):
        raise AssertionError("checkpoint: the resumed run differs from the straight one")
    return dict(losses_bitwise=same_loss, params_bitwise=same_params, file=os.path.basename(path))


def write_reference(path, uri, seconds):
    """A reference RTTM of two speakers taking 2.5 s turns."""
    with open(path, "w") as f:
        for k, start in enumerate(np.arange(0.0, seconds - 0.5, 2.5)):
            dur = min(2.5, seconds - start)
            f.write(f"SPEAKER {uri} 1 {start:.3f} {dur:.3f} <NA> <NA> spk{k % 2} <NA> <NA>\n")


def drive_tuning(tmp):
    """The tune CLI (subprocess, --multi-stream, TUNE_TRIALS trials) and an
    in-process Optimizer(multi_stream=True) over 4 synthesized files with
    reference RTTMs: the CLI exits 0 with its trials in the study; in
    process one cached engine serves every trial, every
    set_hyperparameters runs under the sync check, and each trial's value
    is 100 x |DER| recomputed from its RTTM files."""
    import sqlite3
    from pathlib import Path

    from diart_tpu_torch.blocks import SpeakerDiarization
    from diart_tpu_torch.core import Annotation, load_rttm
    from diart_tpu_torch.metrics import DiarizationErrorRate
    from diart_tpu_torch.optim import Optimizer, Study, TPESampler

    corpus, ref = os.path.join(tmp, "tune_audio"), os.path.join(tmp, "tune_ref")
    os.makedirs(corpus)
    os.makedirs(ref)
    rng = np.random.default_rng(8)
    for k, seconds in enumerate(TUNE_SECONDS):
        write_seconds(os.path.join(corpus, f"talk{k}.wav"), rng, seconds)
        write_reference(os.path.join(ref, f"talk{k}.rttm"), f"talk{k}", seconds)
    db = os.path.join(tmp, "tune.db")
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "diart_tpu_torch.console.tune", corpus, "--reference", ref, "--multi-stream",
           "--num-iter", str(TUNE_TRIALS), "--storage", db, *RUNTIME_CLI_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                          env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"tune CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    with sqlite3.connect(db) as conn:
        rows = conn.execute("SELECT params, value, state FROM trials").fetchall()
    if len(rows) != TUNE_TRIALS or any(s != "COMPLETE" for *_, s in rows):
        raise AssertionError(f"tune CLI: expected {TUNE_TRIALS} complete trials; got {rows}")
    best = [l for l in proc.stdout.splitlines() if l.startswith("Best")]
    log(f"tune CLI (subprocess, --multi-stream, default models on the card): exit 0, {len(rows)} trials in the "
        f"study ({', '.join(f'{v:.3f}' for _, v, _ in rows)}), {cli_wall:.2f} s wall; {'; '.join(best)}")

    config = runtime_pipeline("xvector").config
    study = Study(os.path.join(tmp, "inproc", "study.db"), sampler=TPESampler(seed=0))
    optimizer = Optimizer(SpeakerDiarization, corpus, ref, study, base_config=config, multi_stream=True)
    evaluate, trials, engines, hp_calls = optimizer._evaluate, [], [], []

    def checked_set(engine):
        original = engine.set_hyperparameters

        def set_hyperparameters(**kw):
            with no_host_sync():
                original(**kw)
            hp_calls.append(kw)

        engine.set_hyperparameters = set_hyperparameters

    def traced(params):
        out_dir = os.path.join(tmp, f"trial{len(trials)}")
        optimizer.benchmark.output_path = Path(out_dir)
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        value = evaluate(params)
        ms = (time.perf_counter() - t0) * 1e3
        engine = optimizer.benchmark._engine_cache[1]
        if not engines:
            checked_set(engine)
        engines.append(engine)
        metric, bound = DiarizationErrorRate(), 0.0
        for k in range(len(TUNE_SECONDS)):
            uri = f"talk{k}"
            hyp = load_rttm(os.path.join(out_dir, f"{uri}.rttm")).get(uri, Annotation(uri=uri))
            reference = load_rttm(os.path.join(ref, f"{uri}.rttm"))[uri]
            metric(reference, hyp)
            bound += 2 * 0.0005 * (len(list(hyp.itertracks())) + len(list(reference.itertracks())))
        recomputed = 100.0 * abs(metric)
        # the files keep times to 1 ms: each turn's two ends move by at most
        # 0.5 ms, so the error moves by at most that much per end
        tol = 100.0 * bound / sum(TUNE_SECONDS) + 1e-9
        trials.append(dict(params=params, value=value, recomputed=recomputed, tol=tol, ms=ms))
        if abs(value - recomputed) > tol:
            raise AssertionError(f"tuning: trial value {value} is not 100 x |DER| of its RTTM files ({recomputed})")
        return value

    optimizer._evaluate = traced
    optimizer(num_iter=TUNE_TRIALS, show_progress=False)
    if len(engines) != TUNE_TRIALS or any(e is not engines[0] for e in engines):
        raise AssertionError("tuning: the trials did not share one cached engine")
    if len(hp_calls) != TUNE_TRIALS - 1:
        raise AssertionError(f"tuning: expected {TUNE_TRIALS - 1} set_hyperparameters calls; got {len(hp_calls)}")
    ms = [t["ms"] for t in trials]
    log(f"Optimizer(multi_stream=True), {TUNE_TRIALS} trials over {len(TUNE_SECONDS)} files "
        f"({sum(TUNE_SECONDS)} s of audio): one cached engine for every trial, {len(hp_calls)} "
        f"set_hyperparameters under the sync check, values "
        + ", ".join(f"{t['value']:.4f} (RTTM files: {t['recomputed']:.4f}, tol {t['tol']:.1e})" for t in trials)
        + f"; ms a trial {', '.join(f'{m:.0f}' for m in ms)}")
    return dict(cli=dict(wall_s=cli_wall, trials=[dict(params=p, value=v) for p, v, _ in rows]),
                optimizer=dict(trials=trials, ms_a_trial=ms, set_hyperparameters_checked=len(hp_calls)))


def drive_training(out_dir):
    """Phase 8: the kernels' gradients, both trainers at full width, the
    card against the CPU, a bitwise resume and tuning."""
    import shutil
    import tempfile

    from diart_tpu_torch import precision
    from diart_tpu_torch.ops import lstm_sweep

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)  # inside the checkout
    try:
        t0 = time.perf_counter()
        grads = check_kernel_grads()
        log(f"kernel gradients in {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        bwd_build = check_split_build()
        sweep_bwd = check_sweep_backward()
        seg_abba = seg_step_abba("lstm_sweep_backward", column_backward, "the column kernel as the sweep's backward")
        seg_fwd_abba = seg_step_abba("_launch", fma_forward(lstm_sweep._launch),
                                     "the FMA route as the sweep's f32 forward")
        log(f"the sweep's backward kernel in {time.perf_counter() - t1:.1f} s")
        runs = {}
        # segmentation in f32 (the sweep's f32 stream, the f32 frontend); the
        # embedding trunks in bf16 under the serving policy, as the engines run
        for kind, dtype, policy in (("seg", "f32", f32_policy()), ("xvector", "bf16", precision.active()),
                                    ("ecapa", "bf16", precision.active())):
            t1 = time.perf_counter()
            with precision.use(policy):
                runs[kind] = train_full_width(kind, dtype, TRAIN_LAUNCHES[kind], engine_probe(kind))
            runs[kind]["seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        with precision.use(f32_policy()):
            vs_cpu = {kind: compare_trainer_cpu(kind) for kind in ("seg", "xvector", "ecapa")}
            resume = check_resume(tmp)
        log(f"card vs CPU and checkpoint in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        tuning = drive_tuning(tmp)
        log(f"tuning in {time.perf_counter() - t1:.1f} s")
        return dict(kernel_grads=grads, sweep_bwd=sweep_bwd, sweep_bwd_build=bwd_build, sweep_bwd_seg_step=seg_abba,
                    sweep_fwd_seg_step=seg_fwd_abba,
                    runs=runs, vs_cpu=vs_cpu, resume=resume, tuning=tuning, seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
# Phase 9: scale-out and int8: the int8 convolution at every quantizable
# site, the five families with the int8 trunk, the sharded engine and the
# server on one card, process groups on one card
# --------------------------------------------------------------------- #
INT8_FAMILIES = ("xvector", "ecapa", "resnet34", "titanet", "xvect-sb")
# the int8 convolutions of one step on the card's route: the families'
# QuantizableConv sites outside the fused kernels (ECAPA's SE-Res2Blocks and
# the x-vector families' last TDNN run in se_res2 / linear_stats)
INT8_SITES = {"xvector": 4, "ecapa": 2, "resnet34": 35, "titanet": 14, "xvect-sb": 4}
INT8_OTHER_LAUNCHES = {  # the other kernels' launches a step beside tpu/pyannet's 4 sweeps
    "xvector": dict(linear_stats=1), "ecapa": dict(attn_stats=1, se_res2=3),
    "resnet34": dict(resnet_conv=0),  # the int8 trunk keeps int8_conv: no channels-last launch
    "titanet": dict(attn_stats=1), "xvect-sb": dict(linear_stats=1)}
INT8_HOPS = 12
INT8_COS = 0.999  # tests/test_quant.py's embedding fidelity bound
INT8_CPU_TOL = 1e-4
INT8_MAIN_SITE = "xvector.tdnn1"  # the kernel line's numbers: the port's main engine
MESH_SLOTS = 2
MESH_HOPS = 14
DP_B = 32


def int8_engine(family, device, batch, dtype="bf16", precision=None, mesh=None):
    """``tpu/pyannet`` beside the registry model of ``family`` (seeded, full
    width), 5 s / 0.5 s, 20 speakers, the session thresholds."""
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    seg = SegmentationModel.from_registry("tpu/pyannet", device=device, seed=0)
    emb = EmbeddingModel.from_registry(f"tpu/{family}", device=device, seed=1, dtype=dtype)
    return MultiStreamEngine(seg, emb, duration=5.0, step=0.5, latency=0.5, sample_rate=16000,
                             max_speakers=20, batch_size=batch, precision=precision, mesh=mesh,
                             tau_active=SESSION_TAU, rho_update=0.05)


def int8_counters() -> dict:
    from diart_tpu_torch.ops import quant

    return dict(launch_counters(), int8_conv=quant.int8_conv)


def quantizable_sites(module):
    """The QuantizableConv modules the int8 path takes, by name."""
    from diart_tpu_torch.models.common import QuantizableConv

    return [(n, m) for n, m in module.named_modules() if isinstance(m, QuantizableConv) and m.quantizable]


def capture_site_inputs(module, fn):
    """Run ``fn()`` and return [(site name, module, its input)] in call
    order (forward pre-hooks on the quantizable sites)."""
    seen, hooks = [], []
    for name, m in quantizable_sites(module):
        hooks.append(m.register_forward_pre_hook(
            lambda mod, args, name=name: seen.append((name, mod, args[0].detach().clone()))))
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return seen


def check_int8_site(tag, conv, x):
    """``int8_conv`` at one site's input on the card against its plain
    version on the same input: ``quantize_rows`` and the int32 sums bitwise,
    the dequantized output (the site's dtype, the bias added) bitwise too
    (every epilogue operation is rounded as the plain version's); the
    kernel's ms beside its bound, the plain version's and the yardsticks:
    cuDNN's bf16 convolution of the same shape and, where the reduction is
    a multiple of 8 and the window 1-D or 1x1, ``torch._int_mm`` over the
    input unfolded beforehand (the product alone)."""
    import torch
    import torch.nn.functional as F
    from diart_tpu_torch.ops import quant

    w, b = conv.weight, conv.bias
    st, pad, dil, dt = conv.stride, conv.padding, conv.dilation, conv.compute_dtype
    ops = quant.prepare_int8_operands(w, b)
    c_out, c_in = w.shape[:2]
    c_pad = quant.padded_channels(c_in)
    q, s = quant.quantize_rows(x)
    qp, sp = quant.quantize_per_sample(x)
    quant_ok = torch.equal(q, F.pad(qp.flatten(2).transpose(1, 2), (0, c_pad - c_in))) and torch.equal(s, sp.view(-1))
    acc = quant.int8_conv_accumulators(x, w, st, pad, dil, operands=ops)
    acc_p = quant.int8_accumulate(qp, quant.quantize_weight(w)[0], st, pad, dil)
    acc_ok = torch.equal(acc, acc_p)
    got = quant.int8_conv(x, w, b, st, pad, dil, dt, operands=ops)
    want = quant.int8_conv_reference(x, w, b, st, pad, dil, dt)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    out_ok = torch.equal(got, want)
    call = lambda: quant.int8_conv(x, w, b, st, pad, dil, dt, operands=ops)
    ms = time_ms(call, 10)
    # the three launches apart (profiler device time a call)
    by_launch = {name: t for name, t, _ in device_times(call, f"int8_conv[{tag}]", calls=5)}
    launch_ms = {k: sum(t for name, t in by_launch.items() if name.startswith(k))
                 for k in ("absmax_rows", "quantize_rows", "int8_conv_wgmma")}
    plain_ms = time_ms(lambda: quant.int8_conv_reference(x, w, b, st, pad, dil, dt), 2, warmup=1)
    conv_fn = F.conv2d if w.dim() == 4 else F.conv1d
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    cudnn_ms = time_ms(lambda: conv_fn(xb, wb, stride=st, padding=pad, dilation=dil), 10)
    window = tuple(w.shape[2:])
    k = c_in * int(np.prod(window))
    n = got.numel() // c_out
    int_mm_ms = None
    if k % 8 == 0 and c_out % 8 == 0 and (w.dim() == 3 or window == (1, 1)):
        if w.dim() == 3:  # (B, T, C) int8 unfolded to (B * O, k * C_in)
            cols = q[..., :c_in].unfold(1, (window[0] - 1) * dil + 1, 1)[..., ::dil].permute(0, 1, 3, 2)
        else:  # a 1x1 window of stride s: a strided view
            cols = qp[:, :, ::st, ::st].permute(0, 2, 3, 1)
        a = cols.reshape(-1, k).contiguous()
        # (K, N), column-major as _int_mm takes it: the taps' unpadded channels
        bw = ops.q_w.view(c_out, -1, c_pad)[:, :, :c_in].reshape(c_out, k).contiguous().t()
        if a.shape[0] > 16:
            int_mm_ms = time_ms(lambda: torch._int_mm(a, bw), 10)
    nbytes = x.numel() * x.element_size() + got.numel() * got.element_size() + ops.q_w.numel()
    bnd, by = bound_ms(nbytes, 2.0 * c_out * n * k, "int8")
    # the quantizer's own byte bound: x read once, q_x written once
    q_bound = (x.numel() * x.element_size() + q.numel()) / HBM_BYTES_PER_S * 1e3
    o1, o2 = tuple(got.shape[2:]) + (1,) * (4 - got.dim())
    s1, s2 = quant._pairs(st, w.dim() - 2) + (1,) * (4 - w.dim())
    plan = quant.conv_plan(c_out, o1, o2, s1, s2, c_pad)
    rec = dict(site=tag, x=list(x.shape), x_dtype=str(x.dtype).replace("torch.", ""),
               weight=list(w.shape), stride=st, padding=pad, dilation=dil, quantize_bitwise=quant_ok,
               accumulators_bitwise=acc_ok, output_bitwise=out_ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bnd, bound_by=by, library_ms=cudnn_ms, int_mm_ms=int_mm_ms,
               tops=2.0 * c_out * n * k / ms / 1e9, launch_ms=launch_ms, quantize_bound_ms=q_bound,
               conv_tops=2.0 * c_out * n * k / launch_ms["int8_conv_wgmma"] / 1e9
               if launch_ms["int8_conv_wgmma"] else None,
               plan=plan._asdict())
    log(f"int8_conv[{tag}] x {tuple(x.shape)} {rec['x_dtype']}, w {tuple(w.shape)}, stride {st}, padding {pad}, "
        f"dilation {dil}: quantize_rows bitwise {quant_ok}, int32 sums bitwise {acc_ok}, output bitwise {out_ok} "
        f"(max_abs_err={err:.3e}); {ms:.3f} ms ({rec['tops']:.1f} TOP/s; bound {bnd:.3f} ms by {by}), plain "
        f"{plain_ms:.3f} ms, cuDNN bf16 conv {cudnn_ms:.3f} ms"
        + (f", _int_mm of the unfolded input {int_mm_ms:.3f} ms" if int_mm_ms is not None else "")
        + f"; launches absmax_rows {launch_ms['absmax_rows']:.4f} / quantize_rows {launch_ms['quantize_rows']:.4f} "
        f"(byte bound {q_bound:.4f}) / int8_conv_wgmma {launch_ms['int8_conv_wgmma']:.4f} ms "
        f"({rec['conv_tops'] or 0:.1f} TOP/s); plan n={plan.n} mw={plan.mw} box {plan.box1}x{plan.box2} "
        f"bk={plan.bk} tiles {plan.tiles}")
    if not (quant_ok and acc_ok and out_ok):
        raise AssertionError(f"int8_conv[{tag}] disagrees with its plain version")
    return rec


def int8_sass():
    """The built ``int8_conv`` library's SASS (``cuobjdump --dump-sass``):
    every convolution kernel (``int8_conv_wgmma``) holds a warpgroup MMA on
    8-bit integers (``IGMMA``) and no ``mma.sync`` one (``IMMA``)."""
    from diart_tpu_torch.ops import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    so = str(_build.BUILD_DIR / "libint8_conv.so")
    text = subprocess.run([tool, "--dump-sass", so], capture_output=True, text=True, timeout=120).stdout
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    conv = [f for f in funcs if "int8_conv_wgmma" in f.split("\n", 1)[0]]
    rec = dict(functions=len(funcs), conv_kernels=len(conv),
               with_igmma=sum(bool(re.search(r"\bIGMMA", f)) for f in conv),
               with_imma=sum(bool(re.search(r"\bIMMA\b", f)) for f in conv),
               igmma_instructions=sum(len(re.findall(r"\bIGMMA\S*", f)) for f in conv))
    log(f"int8_conv SASS ({tool}): {rec['conv_kernels']} convolution kernels, {rec['with_igmma']} with IGMMA "
        f"({rec['igmma_instructions']} instructions), {rec['with_imma']} with IMMA")
    if not (conv and rec["with_igmma"] == len(conv) and rec["with_imma"] == 0):
        raise AssertionError(f"int8_conv's SASS: every convolution kernel must use IGMMA and none IMMA: {rec}")
    return rec


def check_int8_sites():
    """Every quantizable site of the five families at full width, B=64 and
    their serving dtype (bf16 trunks), at the inputs one forward hands it:
    one check for each distinct geometry. Then one geometry no family has:
    a 3x3 convolution of stride 2, padding 1 and dilation 3 whose 7 output
    columns divide no tile of the kernel (its general epilogue, positions
    not contiguous), 40 input channels (C_pad 64), 24 output channels."""
    import torch
    from diart_tpu_torch import EmbeddingModel, precision
    from diart_tpu_torch.models.common import QuantizableConv

    recs, done = [], set()
    wave = torch.from_numpy(make_audio(np.random.default_rng(9), 10, B, 8000).transpose(1, 0, 2)
                            .reshape(B, 1, -1).astype(np.float32) / 32768.0).cuda()
    for family in INT8_FAMILIES:
        model = EmbeddingModel.from_registry(f"tpu/{family}", device="cuda", seed=1, dtype="bf16")
        with torch.no_grad(), precision.use(precision.Precision(int8_trunk=True)):
            seen = capture_site_inputs(model.module, lambda: model.module.trunk(wave))
        for name, conv, x in seen:
            key = (tuple(x.shape), tuple(conv.weight.shape), str(conv.stride), str(conv.padding),
                   str(conv.dilation), x.stride())
            if key in done:
                continue
            done.add(key)
            recs.append(check_int8_site(f"{family}.{name}", conv, x))
        del model, seen
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(12)
    # fixed weights, as the families' are: the held operands' path, not the straight-through Function's
    conv = QuantizableConv(40, 24, (3, 3), dilation=3, stride=2, padding=1,
                           compute_dtype=torch.bfloat16).cuda().requires_grad_(False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, device="cuda", generator=gen) * 0.1)
        conv.bias.copy_(torch.randn(24, device="cuda", generator=gen))
    x = torch.randn(B, 40, 23, 17, device="cuda", generator=gen).to(torch.bfloat16)
    recs.append(check_int8_site("extra.3x3-s2-p1-d3", conv, x))
    return recs


def quick_timing(engine, audio, steps=6):
    """Back-to-back wall of ``steps`` steps (median of 2 rounds), then the
    device busy time and launches a step of 3 profiled steps."""
    import torch

    b = audio.shape[1]
    ones = np.ones(b, bool)
    state = engine.init_state()
    for i in range(WARMUP_HOPS + 1):
        state, _ = engine.step(state, audio[i], ones, np.full(b, i + 1 >= WARMUP_HOPS))
    rounds = []
    for r in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = engine.step(state, audio[(r + i) % audio.shape[0]], ones, ones)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) * 1e3 / steps)
    res = dict(back_to_back_wall_ms=float(np.median(rounds)), rounds_ms=rounds)
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            state, _ = engine.step(state, audio[i], ones, ones)
        torch.cuda.synchronize()
    res.update(device_summary(prof, 3, top=6))
    res["idle_share"] = 1.0 - res["device_busy_ms"] / res["back_to_back_wall_ms"]
    return res


@contextlib.contextmanager
def f32_fma_routes():
    """The f32 stats head and SE-Res2Block on their FMA kernels (the f32
    routes before the TF32 tensor cores; scratch builds in build/smoke/) in
    place of the port's launches, each counted as the port's launch, so a
    step runs as the parent's did. bf16 calls are the port's."""
    import torch
    from diart_tpu_torch.ops import linear_stats, se_res2

    real = (linear_stats._launch, se_res2._launch)

    def stats(x, ops, weights, negative_slope):
        if x.dtype != torch.float32:
            return real[0](x, ops, weights, negative_slope)
        out = stats_fma(x.contiguous(), ops, weights.float().contiguous(), negative_slope)
        linear_stats.fused_linear_stats.launches += 1
        return out

    def res2(x, k, dilation):
        if x.dtype != torch.float32:
            return real[1](x, k, dilation)
        out = res2_fma_block(se_res2._aligned(x), k, dilation)
        se_res2.fused_se_res2_block.launches += 1
        return out

    linear_stats._launch, se_res2._launch = stats, res2
    try:
        yield
    finally:
        linear_stats._launch, se_res2._launch = real


F32_TRAIN_STEPS = 6  # steps a turn of the f32 training A B B A (the first is not counted)


def drive_f32_steps():
    """The f32 policy's steps with the TF32 routes (B) against the FMA routes
    (A, ``f32_fma_routes``) in A B B A turns: the x-vector and ECAPA engines
    at B=64 with ``Precision.portable()`` and f32 models (back-to-back wall
    and device busy a step, ``quick_timing``), and the x-vector and ECAPA
    trainers with f32 models at B=32 after 3 warm-up steps (median wall of
    F32_TRAIN_STEPS - 1 steps; device busy a step, and the part of it in
    the kernels the routes change, from a profile of 3 steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from diart_tpu_torch.precision import Precision

    routes = lambda fma: f32_fma_routes() if fma else contextlib.nullcontext()
    out = {}
    for emb in ("xvector", "ecapa"):
        engine = build_engine("cuda", B, emb, seg_dtype="f32", emb_dtype="f32", precision=Precision.portable())
        audio = make_audio(np.random.default_rng(4), WARMUP_HOPS + 14, B, 8000)

        def turn(fma):
            with routes(fma):
                return quick_timing(engine, audio)

        a, b = abba(lambda: turn(True), lambda: turn(False))
        rec = {k: dict(fma=[r[k] for r in a], tf32=[r[k] for r in b])
               for k in ("back_to_back_wall_ms", "device_busy_ms", "kernels_per_step")}
        out[f"engine_{emb}"] = rec
        log(f"f32 engine[{emb}] B={B} A B B A (A: the FMA routes, B: the TF32 routes): wall ms "
            + " ".join(f"{v:.3f}" for v in (a[0]["back_to_back_wall_ms"], b[0]["back_to_back_wall_ms"],
                                            b[1]["back_to_back_wall_ms"], a[1]["back_to_back_wall_ms"]))
            + "; device busy ms " + " ".join(f"{v:.3f}" for v in (a[0]["device_busy_ms"], b[0]["device_busy_ms"],
                                                                 b[1]["device_busy_ms"], a[1]["device_busy_ms"])))
        del engine
    mine = ("tdnn_", "res2_cascade", "linear_stats")  # the kernels whose route the turns change
    for kind in ("xvector", "ecapa"):
        model, state, opt, step = trainer(kind, "cuda", "f32")
        waves, targets = speaker_batch(TRAIN_B, np.random.default_rng(3), "cuda")
        held = dict(state=state)

        def steps(n):
            walls = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                held["state"], _ = step(held["state"], waves, targets)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            return walls

        steps(3)  # warm-up: the allocator's pools, cuDNN's and cuBLAS's plans

        def turn(fma):
            with routes(fma):
                walls = steps(F32_TRAIN_STEPS)
                with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    steps(3)
            dev = device_summary(prof, 3, top=40)
            own = sum(r["ms_per_step"] for r in dev["top_device_items"] if any(m in r["name"] for m in mine))
            return dict(wall_ms=float(np.median(walls[1:])), device_busy_ms=dev["device_busy_ms"],
                        route_kernels_ms=own)

        a, b = abba(lambda: turn(True), lambda: turn(False))
        out[f"train_{kind}"] = {k: dict(fma=[r[k] for r in a], tf32=[r[k] for r in b])
                                for k in ("wall_ms", "device_busy_ms", "route_kernels_ms")}
        log(f"f32 train[{kind}] B={TRAIN_B} A B B A (A: the FMA routes, B: the TF32 routes): step wall ms "
            + " ".join(f"{r['wall_ms']:.3f}" for r in (a[0], b[0], b[1], a[1]))
            + "; device busy ms " + " ".join(f"{r['device_busy_ms']:.3f}" for r in (a[0], b[0], b[1], a[1]))
            + "; of it the routes' kernels " + " ".join(f"{r['route_kernels_ms']:.3f}" for r in (a[0], b[0], b[1], a[1])))
        del model, state, opt, held
    return out


def cosines(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1)


def int8_vs_cpu(family, audio):
    """The family's int8 engine for 2 streams in f32 (TF32 off) on the card
    against the same engine on the CPU: INT8_HOPS hops on the card, then the
    frame scores ``probe_frame_scores`` gives from that state on both (the
    state copied to the CPU). The CPU's quantizable sites are handed the
    card's inputs to them (teacher forcing): an activation within rounding
    of a quantization tie takes the neighbouring int8 value on the other
    device, and through the trunk such flips cascade, most of all through
    ResNet34's 35 quantized convolutions; forced, each site's int8 output
    is the card's kernel against the plain version on the same input, and
    what is left is f32 rounding: within INT8_CPU_TOL."""
    from diart_tpu_torch.precision import Precision

    prec = Precision(bf16_lstm=False, bf16_frontend=False, int8_trunk=True)
    card = int8_engine(family, "cuda", 2, dtype="f32", precision=prec)
    state = card.init_state()
    for i in range(INT8_HOPS):
        state, _ = card.step(state, audio[i, :2], np.ones(2, bool), np.full(2, i + 1 >= WARMUP_HOPS))
    block = audio[INT8_HOPS, :2]
    probe = []
    seen = capture_site_inputs(card._emb.module, lambda: probe.append(card.probe_frame_scores(state, block)))
    sg, eg = (t.float().cpu() for t in probe[0])
    host = int8_engine(family, "cpu", 2, dtype="f32", precision=prec)
    cstate = host.place_state(state)
    forced = iter(seen)
    hooks = [m.register_forward_pre_hook(lambda mod, args: (next(forced)[2].cpu(),))
             for _, m in quantizable_sites(host._emb.module)]
    try:
        sc, ec = host.probe_frame_scores(cstate, block)
    finally:
        for h in hooks:
            h.remove()
    seg_err = (sg - sc).abs().max().item()
    emb_err = (eg - ec).abs().max().item()
    rec = dict(sites_forced=len(seen), seg_err=seg_err, emb_err=emb_err, tol=INT8_CPU_TOL)
    log(f"int8[{family}] card vs CPU (f32, 2 streams, {INT8_HOPS} hops, {len(seen)} sites forced): seg "
        f"max_abs_err={seg_err:.3e}, emb max_abs_err={emb_err:.3e} (tol {INT8_CPU_TOL:.0e})")
    if len(seen) != INT8_SITES[family] or not (seg_err <= INT8_CPU_TOL and emb_err <= INT8_CPU_TOL):
        raise AssertionError(f"int8[{family}]: the card disagrees with the CPU engine")
    return rec


def drive_int8_family(family, audio):
    """The family's engine at B streams with ``int8_trunk`` on (bf16 trunk):
    one step outside the sync check, then INT8_HOPS hops under it with the
    launches counted from zero (int8_conv: the family's sites a step); the
    utterance embeddings of B windows against the same model with the
    switch off (cosine >= INT8_COS); the card against the CPU; the step
    wall, device busy and idle share with the switch on and off (a record)."""
    import torch
    from diart_tpu_torch import precision
    from diart_tpu_torch.precision import Precision

    on = int8_engine(family, "cuda", B, precision=Precision(int8_trunk=True))
    on.step(on.init_state(), audio[0])
    torch.cuda.synchronize()
    counters = int8_counters()
    for fn in counters.values():
        fn.launches = 0
    state = on.init_state()
    with no_host_sync():
        for i in range(INT8_HOPS):
            state, out = on.step(state, audio[i], np.ones(B, bool), np.full(B, i + 1 >= WARMUP_HOPS))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    per_step = dict(dict.fromkeys(counters, 0), lstm_sweep=4, int8_conv=INT8_SITES[family],
                    **INT8_OTHER_LAUNCHES[family])
    if launches != {k: v * INT8_HOPS for k, v in per_step.items()}:
        raise AssertionError(f"int8[{family}]: expected {per_step} launches a step; got {launches}")
    if not torch.isfinite(out.aggregated).all():
        raise AssertionError(f"int8[{family}]: non-finite scores")
    wave = torch.from_numpy(audio[:10].transpose(1, 0, 2).reshape(B, 1, -1).astype(np.float32) / 32768.0).cuda()
    with precision.use(Precision(int8_trunk=True)):
        e_on = on._emb(wave)
    e_off = on._emb(wave)
    cos = cosines(e_on, e_off)
    log(f"int8[{family}] engine B={B}, {INT8_HOPS} hops under the sync check: launches {launches} "
        f"({per_step} a step); utterance embeddings int8 on against off: min cosine {cos.min().item():.6f} "
        f"(bound {INT8_COS}), mean {cos.mean().item():.6f}")
    if not cos.min().item() >= INT8_COS:
        raise AssertionError(f"int8[{family}]: embedding cosine {cos.min().item():.6f} below {INT8_COS}")
    timing_on = quick_timing(on, audio)
    del on
    off = int8_engine(family, "cuda", B)
    timing_off = quick_timing(off, audio)
    del off
    torch.cuda.empty_cache()
    log(f"int8[{family}] step at B={B}, a record (int8 on / off): back-to-back wall "
        f"{timing_on['back_to_back_wall_ms']:.3f} / {timing_off['back_to_back_wall_ms']:.3f} ms, device busy "
        f"{timing_on['device_busy_ms']:.3f} / {timing_off['device_busy_ms']:.3f} ms, idle share "
        f"{timing_on['idle_share']:.3f} / {timing_off['idle_share']:.3f}, device launches "
        f"{timing_on['kernels_per_step']:.0f} / {timing_off['kernels_per_step']:.0f} a step")
    return dict(launches=launches, launches_per_step=per_step, min_cosine=cos.min().item(),
                mean_cosine=cos.mean().item(), vs_cpu=int8_vs_cpu(family, audio), timing_on=timing_on,
                timing_off=timing_off)


def drive_mesh_engine(emb, audio):
    """The engine with embedding ``emb`` at B streams cut into MESH_SLOTS
    shards on the one card (``streams_mesh(devices=[cuda:0] * 2)``). In f32
    (TF32 off, the bf16 switches off): MESH_HOPS hops with warm-up, a paused
    stream and a slot reset in the second shard, every sharded step under
    the sync check (one step before them outside it), each kernel of the
    path launched on every shard in every step; each shard's scores and
    centres within 1e-5 of an unsharded engine of the shard's B / 2 streams
    (the same products at the same shapes: expected bitwise). Against the
    unsharded engine of all B streams the difference is a record: cuBLAS
    and cuDNN pick their products by batch size, and 14 hops of centroid
    updates carry an f32 difference of the embeddings into the scores. In
    the serving configuration (bf16 LSTM stream and trunk): the sessions'
    RTTM text equal to the B-stream engine's at every hop; the step wall of
    both, a record."""
    import torch
    from diart_tpu_torch import MultiStreamSession
    from diart_tpu_torch.parallel import streams_mesh

    def engine(batch, mesh=None, **kw):
        e = build_engine("cuda", batch, emb, mesh=mesh, **kw)
        e.set_hyperparameters(tau_active=SESSION_TAU, rho_update=0.05)  # the random models then make turns
        return e

    f32 = dict(emb_dtype="f32", precision=f32_policy())
    per = B // MESH_SLOTS
    sharded = engine(B, streams_mesh(devices=["cuda:0"] * MESH_SLOTS), **f32)
    single, halves = engine(B, **f32), [engine(per, **f32) for _ in range(MESH_SLOTS)]
    sharded.step(sharded.init_state(), audio[0])
    torch.cuda.synchronize()
    counters = launch_counters()
    launches = dict.fromkeys(counters, 0)
    s1, s2 = single.init_state(), sharded.init_state()
    sh = [h.init_state() for h in halves]
    paused, reset_slot = 1, B - 2
    err = cerr = full_err = full_cerr = 0.0
    curve = []  # the gap to the 64-stream engine, hop by hop
    gap = lambda a, b: (a.cpu().float() - b.cpu().float()).abs().max().item()
    for i in range(MESH_HOPS):
        audio_mask = np.ones(B, bool)
        run_mask = np.full(B, i + 1 >= WARMUP_HOPS)
        if i == MESH_HOPS - 2:
            audio_mask[paused] = run_mask[paused] = False
        if i == MESH_HOPS - 1:
            run_mask[reset_slot] = False
        # the scores this hop's step computes before clustering: segmentation
        # and embeddings apart
        (seg2, emb2), (seg1, emb1) = (e.probe_frame_scores(st, audio[i], audio_mask)
                                      for e, st in ((sharded, s2), (single, s1)))
        curve.append(dict(hop=i + 1, seg=gap(seg2, seg1), emb=gap(emb2, emb1)))
        before = {k: fn.launches for k, fn in counters.items()}
        with no_host_sync():
            s2, o2 = sharded.step(s2, audio[i], audio_mask, run_mask)
            if i == MESH_HOPS - 2:
                s2 = sharded.reset_stream(s2, reset_slot)
        for k, fn in counters.items():
            launches[k] += fn.launches - before[k]
        s1, o1 = single.step(s1, audio[i], audio_mask, run_mask)
        for k, h in enumerate(halves):
            rows = slice(k * per, (k + 1) * per)
            sh[k], oh = h.step(sh[k], audio[i, rows], audio_mask[rows], run_mask[rows])
            if i == MESH_HOPS - 2 and rows.start <= reset_slot < rows.stop:
                sh[k] = h.reset_stream(sh[k], reset_slot - rows.start)
            err = max(err, (o2.aggregated[k] - oh.aggregated).abs().max().item())
            cerr = max(cerr, (s2.centers[k] - sh[k].centers).abs().max().item())
        if i == MESH_HOPS - 2:
            s1 = single.reset_stream(s1, reset_slot)
        curve[-1].update(aggregated=gap(o2.aggregated, o1.aggregated), centres=gap(s2.centers, s1.centers),
                         active_differ=int((s2.center_active.cpu() != s1.center_active.cpu()).sum()))
        full_err = max(full_err, curve[-1]["aggregated"])
        full_cerr = max(full_cerr, curve[-1]["centres"])
    torch.cuda.synchronize()
    per_hop = path_launches(emb, 4)
    want = {k: v * MESH_HOPS * MESH_SLOTS for k, v in per_hop.items()}
    if launches != want:
        raise AssertionError(f"mesh[{emb}]: expected {want} launches of the sharded steps; got {launches}")
    active = s2.center_active.cpu().sum().item()
    del single, halves
    sharded, single = engine(B, streams_mesh(devices=["cuda:0"] * MESH_SLOTS)), engine(B)
    texts = []
    for e in (single, sharded):
        session = MultiStreamSession(e, tau_active=SESSION_TAU, collect_audio=False)
        hop_texts = []
        for i in range(MESH_HOPS):
            present = np.ones(B, bool)
            if i == 4:
                present[paused] = False
            hop_texts.append(session.push_rttm(audio[i], present))
            if i == 6:
                session.reset_slots([reset_slot], uris=["fresh"], shifts=[1.5])
        texts.append(hop_texts)
    lines = sum(t.count("\n") for hop in texts[0] for t in hop if t)
    rec = dict(shards=MESH_SLOTS, launches=launches, agg_err_f32=err, centres_err_f32=cerr, tol=1e-5,
               bitwise=err == 0.0 and cerr == 0.0, active_centres_f32=active, agg_err_vs_all_streams=full_err,
               centres_err_vs_all_streams=full_cerr, gap_by_hop=curve,
               session_text_equal=texts[0] == texts[1], rttm_lines=lines,
               timing_sharded=quick_timing(sharded, audio), timing_single=quick_timing(single, audio))
    log(f"mesh[{emb}] B={B} as {MESH_SLOTS} x {per} on one card, f32, {MESH_HOPS} hops (sharded steps under the "
        f"sync check): launches of the sharded steps {launches} (every kernel on every shard); each shard against "
        f"an unsharded engine of its {per} streams: aggregated max_abs_err={err:.3e}, centres {cerr:.3e} (tol "
        f"1e-5; {active} active centres); against the unsharded {B}-stream engine, a record: aggregated "
        f"{full_err:.3e}, centres {full_cerr:.3e}; serving configuration: session text over {MESH_HOPS} hops "
        f"equal to the {B}-stream engine's: {rec['session_text_equal']} ({lines} lines); step wall sharded / "
        f"unsharded {rec['timing_sharded']['back_to_back_wall_ms']:.3f} / "
        f"{rec['timing_single']['back_to_back_wall_ms']:.3f} ms, device busy "
        f"{rec['timing_sharded']['device_busy_ms']:.3f} / {rec['timing_single']['device_busy_ms']:.3f} ms "
        f"(a record)")
    fmt = lambda key: " ".join(f"{h[key]:.1e}" for h in curve)
    log(f"mesh[{emb}] gap to the {B}-stream engine by hop 1..{MESH_HOPS} (f32): segmentation {fmt('seg')}; "
        f"embeddings {fmt('emb')}; aggregated {fmt('aggregated')}; centres {fmt('centres')}; active centres "
        f"differing {' '.join(str(h['active_differ']) for h in curve)}")
    if not (err <= 1e-5 and cerr <= 1e-5 and active and rec["session_text_equal"] and lines):
        raise AssertionError(f"mesh[{emb}]: the sharded engine disagrees with the unsharded one")
    return rec


def drive_server_mesh(audio):
    """``serve --mesh 2``'s server on one card: StreamingServer over the
    sharded x-vector engine (MESH_SLOTS shards of cuda:0), stub clients in
    all B slots, MESH_HOPS hops driven by ``_tick`` (float32 wire), every
    dispatch under the sync check; each client's text equal to a session on
    the unsharded engine pushed the same blocks."""
    import asyncio

    import torch
    from diart_tpu_torch import MultiStreamSession
    from diart_tpu_torch.parallel import streams_mesh
    from diart_tpu_torch.runtime.server import StreamingServer
    from diart_tpu_torch.utils import encode_audio

    engine = build_engine("cuda", B, "xvector", mesh=streams_mesh(devices=["cuda:0"] * MESH_SLOTS))
    single = build_engine("cuda", B, "xvector")
    for e in (engine, single):
        e.set_hyperparameters(tau_active=SESSION_TAU, rho_update=0.05)
    server = StreamingServer(engine, tau_active=SESSION_TAU)
    server.session.warm()
    session = server.session

    def begin(blocks, present, _begin=session.push_begin):
        with no_host_sync():
            return _begin(blocks, present)

    session.push_begin = begin
    clients = [server._claim_slot(StubSocket()) for _ in range(B)]
    floats = audio[:MESH_HOPS].astype(np.float32) / 32768.0

    async def drive():
        for k in range(MESH_HOPS):
            for lane, client in enumerate(clients):
                client.buffer = np.concatenate([client.buffer, server._ingest(encode_audio(floats[k, lane][None]),
                                                                              "f32")])
            await server._tick(0)
            while server._in_flight:
                fut, slots = await server._outbox.get()
                await server._send_outputs(await fut, slots)
                server._in_flight -= 1

    asyncio.run(drive())
    torch.cuda.synchronize()
    ref = MultiStreamSession(single, uris=[f"client{lane}" for lane in range(B)], tau_active=SESSION_TAU,
                             collect_audio=False)
    want = [""] * B
    for k in range(MESH_HOPS):
        for lane, text in enumerate(ref.push_rttm(floats[k], np.ones(B, bool))):
            want[lane] += text or ""
    got = ["".join(c.websocket.sent) for c in clients]
    server._dispatch_pool.shutdown()
    for pool in server._harvest_pools:
        pool.shutdown()
    lines = sum(t.count("\n") for t in got)
    log(f"server --mesh {MESH_SLOTS} (one card): {B} stub clients, {MESH_HOPS} hops by _tick under the sync "
        f"check; every client's text equals the unsharded session's: {got == want} ({lines} lines)")
    if got != want or not lines:
        raise AssertionError("server --mesh: a client's text differs from the unsharded session's")
    return dict(clients=B, hops=MESH_HOPS, rttm_lines=lines)


def dp_batch(device):
    """DP_B tone-plus-noise chunks and their labels (``speaker_batch``)."""
    return speaker_batch(DP_B, np.random.default_rng(12), device)


def dp_trainer(device):
    """The x-vector AAM trainer in f32 (seeded weights and prototypes)."""
    from diart_tpu_torch import EmbeddingModel
    from diart_tpu_torch.train import make_embedding_train_state

    model = EmbeddingModel.from_registry("tpu/xvector", device=device, seed=2, dtype="f32")
    return make_embedding_train_state(model, TRAIN_CLASSES, model.embedding_dim, learning_rate=1e-5, seed=3)


def group_engine_run(mesh, rows):
    """The f32 x-vector engine (TF32 off, the bf16 switches off) over the
    streams ``rows`` of B, MESH_HOPS hops of seeded audio: (state, last
    output). With ``mesh``, a rank's engine of the group's B streams;
    without, an unsharded engine of just ``rows`` (the same products at
    the same shapes as the rank's)."""
    batch = B if mesh is not None else rows.stop - rows.start
    engine = build_engine("cuda", batch, "xvector", emb_dtype="f32", precision=f32_policy(), mesh=mesh)
    audio = make_audio(np.random.default_rng(13), MESH_HOPS, B, 8000)[:, rows]
    state = engine.init_state()
    for i in range(MESH_HOPS):
        state, out = engine.step(state, audio[i], run_mask=np.full(audio.shape[1], i + 1 >= WARMUP_HOPS))
    return state, out


def rank_child(kind, rank, port, out_dir) -> int:
    """One process of ``drive_process_groups`` (``--rank-child``). ``gloo``:
    rank ``rank`` of 2 in a gloo group with CUDA tensors on cuda:0, driving
    its half of the x-vector engine's B streams (MESH_HOPS hops) and one
    data-parallel AAM step of DP_B samples; ``nccl``: a one-process NCCL
    group that all-reduces once."""
    import torch
    import torch.distributed as dist
    from diart_tpu_torch import precision
    from diart_tpu_torch.parallel import streams_mesh
    from diart_tpu_torch.parallel.mesh import initialize_distributed
    from diart_tpu_torch.train import embedding_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = 2 if kind == "gloo" else 1
    os.environ.update(DIART_TPU_COORDINATOR=f"127.0.0.1:{port}", DIART_TPU_NUM_PROCESSES=str(world),
                      DIART_TPU_PROCESS_ID=str(rank))
    if kind == "nccl":
        assert initialize_distributed(device="cuda") and dist.get_backend() == "nccl"
        t = torch.full((4,), 2.0, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        assert torch.equal(t.cpu(), torch.full((4,), 2.0)), t
        dist.destroy_process_group()
        print("nccl: ok", flush=True)
        return 0
    mesh = streams_mesh(devices=["cuda:0"], backend="gloo")
    assert dist.get_backend() == "gloo" and mesh.world_size == 2 and mesh.rank == rank
    rows = mesh.local_slice(B)
    state, out = group_engine_run(mesh, rows)
    dump = dict(rows=np.array([rows.start, rows.stop]), agg=out.aggregated.cpu().numpy(),
                centers=state.centers.cpu().numpy())
    state, opt = dp_trainer("cuda")
    waves, labels = dp_batch("cuda")
    with precision.use(f32_policy()):
        state, loss = embedding_train_step(lambda m, x: m(x), opt, state, waves, labels, dp=mesh)
    dump["loss"] = loss.cpu().numpy()
    dump.update({f"grad/{n}": g.cpu().numpy() for n, g in named_grads(state)})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **dump)
    dist.destroy_process_group()
    print(f"gloo rank {rank}: ok", flush=True)
    return 0


def drive_process_groups(tmp):
    """Process groups on the one card, in f32: two processes in a gloo group
    with CUDA tensors, each owning half of the x-vector engine's streams
    (each rank's rows within 1e-5 of one process's engine of those streams,
    as ``drive_mesh_engine`` holds its shards) and taking one
    data-parallel AAM step of DP_B / 2 samples (every gradient norm-wise
    within 1e-5 of one process's step on DP_B; a gradient that is a sum of
    large cancelling terms, a norm under 1e-3 of the largest (SincNet's
    waveform-norm bias, before the filters' instance norms), within 1e-5 of
    a thousandth of the largest);
    and a one-process NCCL group that initializes and all-reduces. NCCL
    cannot put two ranks on one GPU, so the two-rank group is gloo."""
    import socket

    from diart_tpu_torch import precision
    from diart_tpu_torch.train import embedding_train_step

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    here = os.path.abspath(__file__)
    ports = {"gloo": free_port(), "nccl": free_port()}
    procs = []
    for kind, rank in (("gloo", 0), ("gloo", 1), ("nccl", 0)):
        port = ports[kind]
        procs.append((kind, rank, subprocess.Popen(
            [sys.executable, here, "--rank-child", kind, str(rank), str(port), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=os.path.dirname(here))))
    t0 = time.perf_counter()
    try:
        for kind, rank, p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"{kind} rank {rank} exited {p.returncode}: {out[-1000:]} {err[-3000:]}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    log("process groups: NCCL cannot put two ranks on one GPU, so the two-rank group is gloo (CUDA tensors "
        "on cuda:0); a one-process NCCL group initialized and all-reduced once")
    dumps = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in (0, 1)]
    agg_err = cen_err = 0.0
    for d in dumps:
        lo, hi = d["rows"]
        state, out = group_engine_run(None, slice(int(lo), int(hi)))
        agg_err = max(agg_err, float(np.abs(d["agg"] - out.aggregated.cpu().numpy()).max()))
        cen_err = max(cen_err, float(np.abs(d["centers"] - state.centers.cpu().numpy()).max()))
    tstate, opt = dp_trainer("cuda")
    waves, labels = dp_batch("cuda")
    with precision.use(f32_policy()):
        tstate, loss = embedding_train_step(lambda m, x: m(x), opt, tstate, waves, labels)
    want = {f"grad/{n}": g.cpu().numpy() for n, g in named_grads(tstate)}
    top = max(np.linalg.norm(v) for v in want.values())
    worst, worst_name = 0.0, None
    for name, w in want.items():
        norm = np.linalg.norm(w)
        scale = max(norm, 1e-3 * top)
        for d in dumps:
            rel = float(np.linalg.norm(d[name] - w) / scale)
            if rel > worst:
                worst, worst_name = rel, f"{name[5:]} (norm {norm / top:.1e} of the largest)"
    loss_err = abs(float(dumps[0]["loss"]) - loss.item()) / abs(loss.item())
    log(f"process groups (gloo, 2 ranks on cuda:0, {wall:.1f} s for the three processes): each rank's rows "
        f"against one process's engine of those streams: aggregated max_abs_err={agg_err:.3e}, centres "
        f"{cen_err:.3e} (tol 1e-5); "
        f"data-parallel AAM step {DP_B} as 2 x {DP_B // 2}: loss rel err {loss_err:.3e}, worst gradient "
        f"norm-wise rel err {worst:.3e} over {len(want)} tensors, {worst_name} (tol 1e-5)")
    if not (agg_err <= 1e-5 and cen_err <= 1e-5 and worst <= 1e-5 and loss_err <= 1e-5):
        raise AssertionError("process groups: the ranks disagree with one process")
    return dict(agg_err=agg_err, centres_err=cen_err, loss_rel_err=loss_err, worst_grad_rel_err=worst,
                worst_grad=worst_name, wall_s=wall, nccl="initialized, all-reduced once (one process)")


def check_int8():
    """``int8_conv``'s SASS and every site (run with the other kernel checks
    of phase 2 in a whole run: late in a long process the profiler that
    times its launches apart sees no device time)."""
    t0 = time.perf_counter()
    rec = dict(sass=int8_sass(), sites=check_int8_sites())
    log(f"int8 site checks in {time.perf_counter() - t0:.1f} s")
    return rec


def drive_scaleout_int8(out_dir, int8=None):
    """Phase 9: int8_conv at every quantizable site (``int8``: the record
    of ``check_int8`` where it ran already), the five families with the
    int8 trunk, the sharded engines and server on one card, process groups
    on one card."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    int8 = int8 or check_int8()
    families = {}
    for family in INT8_FAMILIES:
        t1 = time.perf_counter()
        families[family] = drive_int8_family(family, make_audio(np.random.default_rng(10), INT8_HOPS + 12, B, 8000))
        families[family]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    log(f"int8 families in {time.perf_counter() - t0:.1f} s")
    audio = make_audio(np.random.default_rng(11), MESH_HOPS + 12, B, 8000)
    mesh = {emb: drive_mesh_engine(emb, audio) for emb in ("xvector", "ecapa")}
    mesh["server"] = drive_server_mesh(audio)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    try:
        groups = drive_process_groups(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(int8, families=families, mesh=mesh, process_groups=groups,
                seconds=time.perf_counter() - t0)


# --------------------------------------------------------------------- #
# phase 10: the files diart_tpu writes, and the stacked SincNet frontend

JAX_FILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "jax_files")
# the card (its kernels in f32, TF32 off) against diart_tpu in f32 on the
# CPU, relative to the outputs' largest (floor 1): the engines' agreement
JAX_FILES_TOL = 1e-4
# each committed model file -> the kernels its forward launches on the card
JAX_FILE_KERNELS = {
    "pyannet.msgpack": ("lstm_sweep",), "xvector.npz": ("linear_stats",),
    "ecapa.msgpack": ("attn_stats", "se_res2"), "titanet.msgpack": ("attn_stats",),
    "xvect_sb.msgpack": ("linear_stats",), "resnet34.msgpack": (),
}
FULL_WIDTH_HOPS = 12


def zeroed_counters() -> dict:
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_counters(counters) -> dict:
    import torch

    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters.items()}


def require_launches(what, launches, kernels):
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched ({launches})")


def jax_file_models(stored) -> dict:
    """Every committed model file through ``from_pretrained`` on the card
    (f32 policy): its output on the stored input against diart_tpu's, and
    the kernels its forward launched."""
    import torch
    from diart_tpu_torch import EmbeddingModel, SegmentationModel, precision

    wave = torch.from_numpy(stored["wave"]).to("cuda")
    weights = torch.from_numpy(stored["weights"]).to("cuda")
    rec = {}
    for name, kernels in JAX_FILE_KERNELS.items():
        cls = SegmentationModel if name.startswith("pyannet") else EmbeddingModel
        model = cls.from_pretrained(os.path.join(JAX_FILES, "models", name), device="cuda")
        counters = zeroed_counters()
        with torch.no_grad(), precision.use(f32_policy()):
            out = model(wave) if cls is SegmentationModel else model.head(model.trunk(wave), weights)
        launches = read_counters(counters)
        err, tol = held_to((out.cpu(),), (torch.from_numpy(stored[f"{name}:out"]),), JAX_FILES_TOL, 1.0)
        log(f"jax_files[{name}]: {type(model.module).__name__} {tuple(out.shape)} max_abs_err {err:.3e} "
            f"(tol {tol:.1e}) against diart_tpu's, launches {launches}")
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"jax_files[{name}]: max_abs_err {err} > {tol}")
        require_launches(f"jax_files[{name}]", launches, kernels)
        rec[name] = dict(max_abs_err=err, tol=tol, launches=launches)
    return rec


def jax_file_session(stored) -> dict:
    """diart_tpu's session file restored onto the card's engine of the two
    committed model files (f32 policy): the next hops' aggregated scores
    against diart_tpu's and the same RTTM text."""
    import torch
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, MultiStreamSession, SegmentationModel

    kw = json.loads(bytes(stored["session:engine"]).decode())
    seg = SegmentationModel.from_pretrained(os.path.join(JAX_FILES, "models", "pyannet.msgpack"), device="cuda")
    emb = EmbeddingModel.from_pretrained(os.path.join(JAX_FILES, "models", "xvector.npz"), device="cuda")
    engine = MultiStreamEngine(seg, emb, precision=f32_policy(), **kw)
    record, step = [], engine.step

    def spy(state, blocks, audio_mask=None, run_mask=None):
        state, out = step(state, blocks, audio_mask, run_mask)
        record.append(out.aggregated)
        return state, out

    engine.step = spy
    session = MultiStreamSession(engine, tau_active=kw["tau_active"], collect_audio=False)
    session.restore(os.path.join(JAX_FILES, "session.msgpack"))
    counters = zeroed_counters()
    texts = [session.push_rttm(b) for b in stored["session:blocks"]]
    launches = read_counters(counters)
    got = torch.stack([a.cpu() for a in record])
    err, tol = held_to((got,), (torch.from_numpy(stored["session:aggregated"]),), JAX_FILES_TOL, 1.0)
    same_text = ["\x00".join(t or "" for t in hop).encode() for hop in texts] == list(stored["session:rttm"])
    log(f"jax_files[session]: {len(texts)} hops after restore, aggregated max_abs_err {err:.3e} (tol {tol:.1e}), "
        f"RTTM text {'equal' if same_text else 'DIFFERENT'}, launches {launches}")
    if not (err <= tol and same_text):
        raise AssertionError("jax_files[session]: the resumed session is not diart_tpu's")
    require_launches("jax_files[session]", launches, ("lstm_sweep", "linear_stats"))
    return dict(max_abs_err=err, tol=tol, hops=len(texts), launches=launches)


def jax_file_training(stored) -> dict:
    """diart_tpu's trainer directory restored into a template from the
    committed PyanNet file on the card, 2 AdamW steps (f32 policy): every
    parameter within 2 x lr a step of diart_tpu's after its 2 more."""
    import torch
    from diart_tpu_torch import SegmentationModel, flaxio, precision
    from diart_tpu_torch.train import latest_checkpoint, make_train_state, restore_train_state, train_step
    from diart_tpu_torch.weights import flatten_flax

    lr = float(stored["train:lr"])
    directory = os.path.join(JAX_FILES, "train")
    assert os.path.basename(str(latest_checkpoint(directory))) == "step_00000002.msgpack"
    model = SegmentationModel.from_pretrained(os.path.join(JAX_FILES, "models", "pyannet.msgpack"), device="cuda")
    state, opt = make_train_state(model, learning_rate=lr)
    state = restore_train_state(directory, state)
    assert state.step == 2, state.step
    waves, targets = (torch.from_numpy(stored[k]).to("cuda") for k in ("train:waves", "train:targets"))
    counters = zeroed_counters()
    with precision.use(f32_policy()), plain_sweep_refused():
        for _ in range(2):
            state, loss = train_step(lambda m, x: m(x), opt, state, waves, targets)
    launches = read_counters(counters)
    with open(os.path.join(JAX_FILES, "train_after.msgpack"), "rb") as f:
        after = flatten_flax(state.module, flaxio.loads(f.read()))
    err = max(float(np.abs(p.detach().cpu().numpy() - after[n]).max()) for n, p in state.module.named_parameters())
    bound = 2 * lr * 2
    log(f"jax_files[training]: restored step 2, 2 more steps: max |param - diart_tpu's| {err:.3e} "
        f"(bound {bound:.1e}), loss {float(loss):.5f}, launches {launches}")
    if not err <= bound:
        raise AssertionError(f"jax_files[training]: {err} > {bound}")
    require_launches("jax_files[training]", launches, ("lstm_sweep", "lstm_sweep_bwd"))
    return dict(max_abs_param_err=err, bound=bound, launches=launches)


def write_jax_file(path, module):
    """``module`` as diart_tpu's ``save`` writes it: flax msgpack of its
    parameter tree (``flaxio.dumps``) and the ``.json`` config."""
    from diart_tpu_torch import flaxio
    from diart_tpu_torch.models.base import module_config
    from diart_tpu_torch.weights import flax_params

    with open(path, "wb") as f:
        f.write(flaxio.dumps(flax_params(module)))
    with open(f"{path}.json", "w") as f:
        json.dump({"module": module_config(module), "module_class": type(module).__name__,
                   "init_samples": 80000}, f)


def jax_file_full_width(tmp, audio) -> dict:
    """The registry PyanNet (4 x 128) and XVectorSincNet (512 x 4 / 1500,
    bf16 trunk) written in diart_tpu's format and read back with
    ``from_pretrained``: the B=64 engine of the read models over
    FULL_WIDTH_HOPS hops bitwise the engine of the modules themselves,
    with its launches."""
    import torch
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    seg = SegmentationModel.from_registry("tpu/pyannet", device="cuda", seed=0)
    emb = EmbeddingModel.from_registry("tpu/xvector", device="cuda", seed=1, dtype="bf16")
    write_jax_file(os.path.join(tmp, "pyannet.msgpack"), seg.module)
    write_jax_file(os.path.join(tmp, "xvector.npz"), emb.module)
    read = (SegmentationModel.from_pretrained(os.path.join(tmp, "pyannet.msgpack"), device="cuda"),
            EmbeddingModel.from_pretrained(os.path.join(tmp, "xvector.npz"), device="cuda"))
    kw = dict(duration=5.0, step=0.5, latency=0.5, sample_rate=16000, max_speakers=20, batch_size=B,
              tau_active=SESSION_TAU, rho_update=0.05)
    runs = {}
    for tag, (s, e) in (("modules", (seg, emb)), ("files", read)):
        engine = MultiStreamEngine(s, e, **kw)
        state, outs = engine.init_state(), []
        counters = zeroed_counters()
        for i in range(FULL_WIDTH_HOPS):
            state, out = engine.step(state, audio[i], run_mask=np.full(B, i + 1 >= WARMUP_HOPS))
            outs.append(out)
        runs[tag] = (outs, read_counters(counters))
    launches = runs["files"][1]
    bitwise = all(torch.equal(a.aggregated, b.aggregated) and torch.equal(a.newest, b.newest)
                  for a, b in zip(runs["modules"][0], runs["files"][0]))
    want = {"lstm_sweep": 4 * FULL_WIDTH_HOPS, "linear_stats": FULL_WIDTH_HOPS}
    log(f"jax_files[full width]: the engine of the files read back over {FULL_WIDTH_HOPS} hops x {B} streams "
        f"{'bitwise' if bitwise else 'NOT bitwise'} the modules' engine, launches {launches}")
    if not bitwise:
        raise AssertionError("jax_files[full width]: the models read from diart_tpu's format differ")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"jax_files[full width]: expected {want} launches; got {launches}")
    return dict(bitwise=bitwise, hops=FULL_WIDTH_HOPS, launches=launches)


def perturb_sincnet(sincnet):
    """A distinct filterbank and waveform norm (tests/test_engine.py's
    stacked test), in place."""
    import torch

    with torch.no_grad():
        sincnet.sinc.low_hz.mul_(1.03).add_(2.0)
        sincnet.sinc.band_hz.mul_(0.97).add_(1.0)
        sincnet.wav_norm_scale.mul_(1.5)
        sincnet.wav_norm_bias.add_(0.1)


def dispatch_ms(engine, audio, steps=10) -> float:
    """Median host ms to enqueue one step with the card idle (a
    synchronize before each), after the warm-up hops."""
    import torch

    b = audio.shape[1]
    ones = np.ones(b, bool)
    state = engine.init_state()
    for i in range(WARMUP_HOPS + 1):
        state, _ = engine.step(state, audio[i], ones, np.full(b, i + 1 >= WARMUP_HOPS))
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = engine.step(state, audio[i % audio.shape[0]], ones, ones)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def stacked_frontend(audio) -> dict:
    """``stack_frontend`` on the card: the 160-channel sinc convolution
    against two 80-channel ones at (B, 1, 80000) in true f32, in the order
    two, one, one, two; the x-vector engine (registry models, the
    embedding's SincNet perturbed so the filterbanks differ) with the
    switch off and on, (off on on off) x 2: back-to-back wall, device busy,
    idle share and the host's dispatch of a step, then the host's time by
    op (profiler); the stacked engine against the unstacked one in
    f32 for 2 streams."""
    import torch
    import torch.nn.functional as F
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel
    from diart_tpu_torch.ops import _numerics
    from diart_tpu_torch.precision import Precision

    seg = SegmentationModel.from_registry("tpu/pyannet", device="cuda", seed=0)
    emb = EmbeddingModel.from_registry("tpu/xvector", device="cuda", seed=1, dtype="bf16")
    perturb_sincnet(emb.module.sincnet)
    rec = {}
    x = torch.randn(B, 1, 80000, device="cuda", generator=torch.Generator("cuda").manual_seed(9))
    with torch.no_grad():
        fs, fe = seg.module.sincnet.sinc.filters(), emb.module.sincnet.sinc.filters()
        f160 = torch.cat([fs, fe])[:, None, :]
        stride = seg.module.sincnet.sinc.stride
        with _numerics.true_f32(x.device):
            one = lambda: F.conv1d(x, f160, stride=stride)
            two = lambda: (F.conv1d(x, fs[:, None, :], stride=stride), F.conv1d(x, fe[:, None, :], stride=stride))
            order = (("two_80_ms", two), ("one_160_ms", one), ("one_160_ms", one), ("two_80_ms", two))
            for name, fn in order:
                rec.setdefault(name + "_runs", []).append(time_ms(fn, 20))
            y = one()
            err = (y - torch.cat(two(), dim=1)).abs().max().item()
    out_frames = y.shape[-1]
    nbytes = x.numel() * 4 + f160.numel() * 4 + y.numel() * 4
    flops = 2.0 * B * 160 * out_frames * f160.shape[-1]
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, "f32")
    for name in ("two_80_ms", "one_160_ms"):
        rec[name] = float(np.median(rec[name + "_runs"]))
    rec["max_abs_err_160_vs_two_80"] = err
    log(f"stacked sinc convolution {tuple(x.shape)} -> {tuple(y.shape)} in true f32: one 160-channel "
        f"{rec['one_160_ms']:.3f} ms (runs {['%.3f' % t for t in rec['one_160_ms_runs']]}), two 80-channel "
        f"{rec['two_80_ms']:.3f} ms (runs {['%.3f' % t for t in rec['two_80_ms_runs']]}), bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), max |160 - two 80| {err:.3e}")

    kw = dict(duration=5.0, step=0.5, latency=0.5, sample_rate=16000, max_speakers=20,
              tau_active=SESSION_TAU, rho_update=0.05)
    engines = {on: MultiStreamEngine(seg, emb, batch_size=B, precision=Precision(stack_frontend=on), **kw)
               for on in (False, True)}
    assert engines[True]._stacked is not None and engines[False]._stacked is None
    steps = {}
    for on in (False, True, True, False) * 2:
        steps.setdefault(on, []).append(
            dict(quick_timing(engines[on], audio, steps=10), dispatch_ms=dispatch_ms(engines[on], audio)))
    for on, tag in ((False, "off"), (True, "on")):
        runs = steps[on]
        rec[f"engine_{tag}"] = dict(
            wall_ms=[r["back_to_back_wall_ms"] for r in runs], busy_ms=[r["device_busy_ms"] for r in runs],
            idle_share=[r["idle_share"] for r in runs], launches_per_step=[r["kernels_per_step"] for r in runs],
            dispatch_ms=[r["dispatch_ms"] for r in runs])
        log(f"x-vector engine B={B}, stack_frontend {tag}: wall {rec[f'engine_{tag}']['wall_ms']} ms, "
            f"busy {rec[f'engine_{tag}']['busy_ms']} ms, idle {rec[f'engine_{tag}']['idle_share']}, "
            f"device launches {rec[f'engine_{tag}']['launches_per_step']}, "
            f"dispatch with the card idle {rec[f'engine_{tag}']['dispatch_ms']} ms")

    # where the host's time a step goes, off and on: the ops' self CPU ms
    # of 3 profiled steps, the largest differences first
    from torch.profiler import ProfilerActivity, profile as torch_profile

    host = {}
    for on in (False, True):
        engine, b = engines[on], audio.shape[1]
        state = engine.init_state()
        for i in range(WARMUP_HOPS + 1):
            state, _ = engine.step(state, audio[i], run_mask=np.full(b, i + 1 >= WARMUP_HOPS))
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(3):
                state, _ = engine.step(state, audio[i])
            torch.cuda.synchronize()
        host[on] = {e.key: (e.self_cpu_time_total / 1e3 / 3, e.count / 3) for e in prof.key_averages()}
    keys = set(host[False]) | set(host[True])
    diff = sorted(keys, key=lambda k: -abs(host[True].get(k, (0, 0))[0] - host[False].get(k, (0, 0))[0]))
    rec["host_ops"] = [dict(op=k[:60], off_ms=host[False].get(k, (0, 0))[0], on_ms=host[True].get(k, (0, 0))[0],
                            off_calls=host[False].get(k, (0, 0))[1], on_calls=host[True].get(k, (0, 0))[1])
                       for k in diff[:8]]
    rec["host_ms"] = {tag: sum(v[0] for v in host[on].values()) for on, tag in ((False, "off"), (True, "on"))}
    log(f"host self CPU ms a step (profiled): off {rec['host_ms']['off']:.3f}, on {rec['host_ms']['on']:.3f}; "
        f"largest differences:")
    for item in rec["host_ops"]:
        log(f"  {item['op']:60s} off {item['off_ms']:7.3f} ms x{item['off_calls']:5.1f}  "
            f"on {item['on_ms']:7.3f} ms x{item['on_calls']:5.1f}")

    # the check in f32 throughout (a bf16 trunk rounds the fold's last-bit
    # differences to its own ulp)
    emb32 = EmbeddingModel.from_registry("tpu/xvector", device="cuda", seed=1)
    perturb_sincnet(emb32.module.sincnet)
    small = audio[:, :2]
    probes = []
    for on in (False, True):
        engine = MultiStreamEngine(seg, emb32, batch_size=2, precision=Precision(
            bf16_lstm=False, bf16_frontend=False, stack_frontend=on), **kw)
        state = engine.init_state()
        for i in range(WARMUP_HOPS):
            state, _ = engine.step(state, small[i], run_mask=np.full(2, i + 1 >= WARMUP_HOPS))
        probes.append(engine.probe_frame_scores(state, small[WARMUP_HOPS]))
    err, tol = held_to(probes[1], probes[0], 1e-5, 1.0)
    rec.update(stacked_vs_unstacked_f32=err, stacked_tol=tol)
    log(f"stacked against unstacked engine, f32, 2 streams: max_abs_err {err:.3e} (tol {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"stacked frontend: {err} > {tol}")
    return rec


def drive_jax_files(out_dir) -> dict:
    """Phase 10 (see the module docstring)."""
    import tempfile

    t0 = time.perf_counter()
    with np.load(os.path.join(JAX_FILES, "outputs.npz")) as data:
        stored = {k: data[k] for k in data.files}
    rec = dict(models=jax_file_models(stored), session=jax_file_session(stored),
               training=jax_file_training(stored))
    audio = make_audio(np.random.default_rng(4), WARMUP_HOPS + 8, B, 8000)
    with tempfile.TemporaryDirectory() as tmp:
        rec["full_width"] = jax_file_full_width(tmp, audio)
    rec["stacked_frontend"] = stacked_frontend(audio)
    rec["seconds"] = time.perf_counter() - t0
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_jax_files.json"), "w") as f:
            json.dump(rec, f, indent=1)
    log(f"jax_files phase in {rec['seconds']:.1f} s")
    return rec


def jax_files_launches(rec, name) -> dict:
    """A kernel's launches on each of phase 10's paths."""
    return dict(**{f"model_{m}": r["launches"][name] for m, r in rec["models"].items()},
                session=rec["session"]["launches"][name], training=rec["training"]["launches"][name],
                full_width=rec["full_width"]["launches"][name])


def int8_entry(scaleout) -> dict:
    """The kernel line's entry for int8_conv: the numbers at the main
    engine's site (the x-vector's TDNN 1, bf16), its launches in the int8
    x-vector engine's run, every site's record and each family's launches."""
    sites = scaleout["sites"]
    main_site = next(r for r in sites if r["site"] == INT8_MAIN_SITE)
    fams = scaleout["families"]
    return dict(name="int8_conv", route="cuda", source="diart_tpu_torch/csrc/int8_conv.cu",
                replaces="diart_tpu/ops/quant.py:87",
                launches=fams["xvector"]["launches"]["int8_conv"],
                launches_family_paths={f: r["launches"]["int8_conv"] for f, r in fams.items()},
                launches_per_step={f: r["launches_per_step"]["int8_conv"] for f, r in fams.items()},
                **{k: main_site[k] for k in KEYS}, int_mm_ms=main_site["int_mm_ms"],
                max_abs_err_all_sites=max(r["max_abs_err"] for r in sites),
                sites=[{k: r[k] for k in ("site", "x", "weight", "ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "int_mm_ms", "tops")} for r in sites])


# --------------------------------------------------------------------- #
# Phase 11: the rest of diart_tpu's surface on the card: lazy models, the
# DIART_TPU_* variables of the policy, the generic log-mel frontend
# --------------------------------------------------------------------- #
# every variable diart_tpu reads for a switch of its policy: the five the
# port honours and the JAX-only ones it does not read
POLICY_VARIABLES = (
    "DIART_TPU_BF16_LSTM", "DIART_TPU_BF16_FRONTEND", "DIART_TPU_FBANK_RING", "DIART_TPU_INT8_TRUNK",
    "DIART_TPU_STACK_FRONTEND", "DIART_TPU_PALLAS_LSTM", "DIART_TPU_PALLAS_HEAD", "DIART_TPU_PALLAS_ATTN",
    "DIART_TPU_PALLAS_RES2", "DIART_TPU_LSTM_BLOCK", "DIART_TPU_LSTM_BLOCK_K", "DIART_TPU_FAST_FBANK",
    "DIART_TPU_PHASED_RING",
)
SURFACE_HOPS = 12
# each child process's variable and value, the engine it drives with the
# default policy, and the Precision (no variable) whose bits it must give
ENV_CASES = {
    "int8_trunk": ("DIART_TPU_INT8_TRUNK", "1", "xvector", dict(int8_trunk=True)),
    "fbank_ring": ("DIART_TPU_FBANK_RING", "0", "ecapa", dict(fbank_ring=False)),
    "bf16_lstm": ("DIART_TPU_BF16_LSTM", "0", "xvector", dict(bf16_lstm=False)),
    "pallas_lstm": ("DIART_TPU_PALLAS_LSTM", "0", "xvector", {}),
}
# each case's kernels a step (the 4-layer PyanNet's sweeps included)
ENV_CASE_LAUNCHES = {
    "int8_trunk": {"lstm_sweep": 4, "linear_stats": 1},
    "fbank_ring": {"lstm_sweep": 4, "attn_stats": 1, "se_res2": 3},
    "bf16_lstm": {"lstm_sweep": 4, "linear_stats": 1},
    "pallas_lstm": {"lstm_sweep": 4, "linear_stats": 1},
}
# log_mel_filterbank on the card against the CPU, both in true f32: only the
# order of the f32 sums differs. An f32 DFT's error in a bin is relative to
# its frame's energy, and white noise leaves some single-bin mel bands far
# below it (1.5e-7 of the frame's peak at (64, 80000): the CPU's log there
# is 6.6e-4 off a float64 oracle). So, as tests/test_torch_fbank_generic.py
# holds diart_tpu: the log features within 1e-4 where the mel energy is at
# least 1e-3 of its frame's peak (95% of them), and every mel energy within
# 4 u sqrt(400) = 4.8e-6 of its frame's peak (a 400-tap f32 sum is off by
# about u sqrt(n) of its size, twice that for a power, on each side; the
# CPU reads 7.9e-7 off float64; TF32 would read ~1e-2)
LOG_MEL_TOL, LOG_MEL_FLOOR, LOG_MEL_PEAK_TOL = 1e-4, 1e-3, 4 * 2.0**-24 * 400**0.5
# torch's TF32 switches as this process got them (phase 11's log-mel check
# runs under them)
DEFAULT_TF32 = {}


def scrub_policy_variables() -> dict:
    """Remove every policy variable from this process's environment (the
    phases before 11 must not see one) and return what was set."""
    return {name: os.environ.pop(name) for name in POLICY_VARIABLES if name in os.environ}


def surface_audio():
    return make_audio(np.random.default_rng(4), SURFACE_HOPS, B, 8000)


def surface_run(engine, audio) -> dict:
    """SURFACE_HOPS steps of ``engine``: its outputs (aggregated, newest)
    stacked on the host, the segmentation and embeddings the next step
    would compute (``probe_frame_scores``), and every kernel's launches
    over the steps."""
    import torch

    counters = int8_counters()
    for fn in counters.values():
        fn.launches = 0
    state, aggs, newest = engine.init_state(), [], []
    for i in range(SURFACE_HOPS):
        state, out = engine.step(state, audio[i], run_mask=np.full(B, i + 1 >= WARMUP_HOPS))
        aggs.append(out.aggregated.float().cpu())
        newest.append(out.newest.float().cpu())
    launches = read_counters(counters)
    seg, emb = engine.probe_frame_scores(state, audio[-1])
    return dict(aggregated=torch.stack(aggs), newest=torch.stack(newest), seg=seg.float().cpu(),
                emb=emb.float().cpu(), launches=launches)


def same_run(a: dict, b: dict) -> bool:
    """Whether two :func:`surface_run` results hold the same bits."""
    import torch

    return all(torch.equal(a[k], b[k]) for k in ("aggregated", "newest", "seg", "emb"))


def step_kwargs() -> dict:
    return dict(duration=5.0, step=0.5, latency=0.5, sample_rate=16000, max_speakers=20, batch_size=B,
                tau_active=SESSION_TAU, rho_update=0.05)


def lazy_models(audio) -> dict:
    """``tpu/pyannet`` and ``tpu/xvector`` (bf16 trunk) through
    ``from_pretrained``: not in memory, nothing placed on the card, before
    the engine's first use; the B=64 engine of the lazy models bitwise the
    one of models loaded beforehand over SURFACE_HOPS hops, with its
    launches; ``with_dtype("f32")`` after the load: the f32 engine's probe
    bitwise that of an engine of models made in f32."""
    import torch
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    seg = SegmentationModel.from_pretrained("tpu/pyannet", device="cuda", seed=0)
    emb = EmbeddingModel.from_pretrained("tpu/xvector", device="cuda", seed=1, dtype="bf16")
    placed = torch.cuda.memory_allocated() - before
    in_memory = (seg.is_in_memory(), emb.is_in_memory())
    if any(in_memory) or placed:
        raise AssertionError(f"lazy models: in memory {in_memory}, {placed} bytes on the card before first use")
    lazy = surface_run(MultiStreamEngine(seg, emb, **step_kwargs()), audio)
    loaded = (SegmentationModel.from_registry("tpu/pyannet", device="cuda", seed=0).load(),
              EmbeddingModel.from_registry("tpu/xvector", device="cuda", seed=1, dtype="bf16").load())
    eager = surface_run(MultiStreamEngine(*loaded, **step_kwargs()), audio)
    launches = lazy["launches"]
    bitwise = same_run(lazy, eager)
    want = {"lstm_sweep": 4 * SURFACE_HOPS, "linear_stats": SURFACE_HOPS}
    log(f"surface[lazy]: from_pretrained in memory {in_memory}, {placed} bytes placed before first use; "
        f"the engine of the lazy models over {SURFACE_HOPS} hops x {B} streams "
        f"{'bitwise' if bitwise else 'NOT bitwise'} the loaded models' engine; launches {launches}")
    if not bitwise:
        raise AssertionError("surface[lazy]: the engine of lazy models differs from the loaded models'")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"surface[lazy]: expected {want} launches; got {launches}")
    assert seg.to("cuda") is seg and emb.eval() is emb and seg.is_in_memory() and emb.is_in_memory()

    # with_dtype after the load: the f32 engine's probe
    emb.with_dtype("f32")
    f32_models = (SegmentationModel.from_registry("tpu/pyannet", device="cuda", seed=0, dtype="f32"),
                  EmbeddingModel.from_registry("tpu/xvector", device="cuda", seed=1, dtype="f32"))
    probes = []
    for models in ((seg, emb), f32_models):
        engine = MultiStreamEngine(*models, precision=f32_policy(), **step_kwargs())
        state = engine.init_state()
        for i in range(WARMUP_HOPS):
            state, _ = engine.step(state, audio[i], run_mask=np.full(B, i + 1 >= WARMUP_HOPS))
        probes.append([p.cpu() for p in engine.probe_frame_scores(state, audio[WARMUP_HOPS])])
    dtype_ok = emb.module.compute_dtype == torch.float32 and all(
        torch.equal(a, b) for a, b in zip(*probes))
    log(f"surface[with_dtype]: with_dtype('f32') after the load: the f32 engine's probe "
        f"{'bitwise' if dtype_ok else 'NOT bitwise'} that of models made in f32")
    if not dtype_ok:
        raise AssertionError("surface[with_dtype]: with_dtype('f32') after the load is not the f32 model")
    return dict(in_memory_before_use=list(in_memory), bytes_placed_before_use=placed, bitwise=bitwise,
                hops=SURFACE_HOPS, launches=launches, with_dtype_f32_probe_bitwise=dtype_ok)


def env_child(case, path) -> int:
    """One environment case (run by :func:`env_overrides` in a process of
    its own, the variable set): the engine of ENV_CASES[case] with the
    default policy over SURFACE_HOPS hops; for ``bf16_lstm`` also the
    PyanNet forward under ``use(Precision(), force=True)``, which ignores
    the variable."""
    import torch
    from diart_tpu_torch.precision import Precision, use

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    var, value, emb, _ = ENV_CASES[case]
    assert os.environ.get(var) == value, (var, os.environ.get(var))
    engine = int8_engine(emb, "cuda", B, precision=Precision())
    out = surface_run(engine, surface_audio())
    rec = dict(variable=f"{var}={value}", resolved=Precision().resolved("cuda"), launches=out.pop("launches"))
    if case == "bf16_lstm":
        wave = probe_wave()
        with torch.no_grad(), use(Precision(), force=True):
            rec["resolved_forced"] = Precision().resolved("cuda")
            out["forced"] = engine._seg(wave).float().cpu()
        with torch.no_grad():
            out["unforced"] = engine._seg(wave).float().cpu()
    torch.save(out, f"{path}.pt")
    with open(f"{path}.json", "w") as f:
        json.dump(rec, f)
    return 0


def probe_wave():
    """B windows of 5 s of the surface audio, on the card."""
    import torch

    audio = surface_audio()
    return torch.from_numpy(audio[:10].transpose(1, 0, 2).reshape(B, 1, -1).astype(np.float32)).cuda()


def env_overrides(tmp) -> dict:
    """Each ENV_CASES case in a child process with its variable set and the
    default policy, started together; meanwhile this process (no variable)
    runs each case's Precision. Each child's scores bitwise those of its
    Precision, its kernels launched on every hop (``DIART_TPU_PALLAS_LSTM=0``
    does not keep the sweep from launching), the int8 and bf16 variables
    changing the scores against the default policy, and ``force=True``
    giving the default policy's forward whatever the variable says."""
    import torch
    from diart_tpu_torch import SegmentationModel
    from diart_tpu_torch.precision import Precision

    procs = {}
    for case, (var, value, _, _) in ENV_CASES.items():
        path = os.path.join(tmp, case)
        logf = open(f"{path}.log", "w")
        procs[case] = (path, logf, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--env-child", case, path],
            env=dict(os.environ, **{var: value}), cwd=PKG_ROOT, stdout=logf, stderr=subprocess.STDOUT))
    audio = surface_audio()
    refs = {case: surface_run(int8_engine(emb, "cuda", B, precision=Precision(**policy)), audio)
            for case, (_, _, emb, policy) in ENV_CASES.items()}
    seg = SegmentationModel.from_registry("tpu/pyannet", device="cuda", seed=0)
    with torch.no_grad():
        default_forward = seg(probe_wave()).float().cpu()
    rec, failures = {}, []
    for case, (path, logf, proc) in procs.items():
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
        if rc != 0:
            with open(f"{path}.log") as f:
                log(f.read()[-4000:])
            raise AssertionError(f"surface[env {case}]: the child exited {rc}")
        with open(f"{path}.json") as f:
            child = json.load(f)
        got = torch.load(f"{path}.pt")
        ref = refs[case]
        bitwise = same_run(got, ref)
        want = {k: v * SURFACE_HOPS for k, v in ENV_CASE_LAUNCHES[case].items()}
        launches, ref_launches = child["launches"], ref["launches"]
        if case == "int8_trunk":
            want["int8_conv"] = ref_launches["int8_conv"]
        # the int8 trunk changes the embeddings, the f32 LSTM stream the
        # segmentation (the aggregated scores move only where an
        # assignment does)
        changed = not torch.equal(got["emb"], refs["pallas_lstm"]["emb"]) or \
            not torch.equal(got["seg"], refs["pallas_lstm"]["seg"])
        entry = dict(variable=child["variable"], resolved=child["resolved"], bitwise=bitwise,
                     launches=launches, reference_launches=ref_launches, changed_against_default=changed)
        log(f"surface[env {child['variable']}]: the default policy resolves to {child['resolved']}; "
            f"scores {'bitwise' if bitwise else 'NOT bitwise'} those of Precision({ENV_CASES[case][3]}) "
            f"with no variable; {'differ from' if changed else 'equal to'} the default policy's; "
            f"launches {launches}")
        if not bitwise:
            failures.append(f"{case}: not bitwise the matching Precision")
        if any(launches.get(k) != v for k, v in want.items()):
            failures.append(f"{case}: expected launches {want}, got {launches}")
        if case in ("int8_trunk", "bf16_lstm") and not changed:
            failures.append(f"{case}: the variable changed nothing")
        if case == "int8_trunk" and not launches["int8_conv"]:
            failures.append("int8_trunk: int8_conv never launched")
        if case == "bf16_lstm":
            forced = torch.equal(got["forced"], default_forward)
            unforced_differs = not torch.equal(got["unforced"], default_forward)
            entry.update(force_bitwise_default=forced, resolved_forced=child["resolved_forced"],
                         unforced_differs=unforced_differs)
            log(f"surface[env force]: use(Precision(), force=True) under {child['variable']}: resolves to "
                f"{child['resolved_forced']}, the PyanNet forward {'bitwise' if forced else 'NOT bitwise'} "
                f"the default policy's with no variable (without force it "
                f"{'differs' if unforced_differs else 'does NOT differ'})")
            if not (forced and unforced_differs and child["resolved_forced"] == Precision().as_dict()):
                failures.append("force: use(..., force=True) does not ignore the variable")
        rec[case] = entry
    if failures:
        raise AssertionError("surface[env]: " + "; ".join(failures))
    return rec


def log_mel_check(smi) -> dict:
    """``log_mel_filterbank`` at (64, 80000) f32 on the card against the
    CPU, under torch's TF32 switches as this process got them; its time
    with CUDA events beside ``speechbrain_log_mel`` of the same input."""
    import torch
    from diart_tpu_torch.models.fbank import log_mel_filterbank, num_fbank_frames, speechbrain_log_mel

    rng = np.random.default_rng(9)
    gains = 10.0 ** (-np.linspace(0.0, 60.0, B) / 20.0)  # 64 streams over 60 dB
    wave = (rng.normal(scale=0.1, size=(B, 80000)) * gains[:, None]).astype(np.float32)
    host = torch.from_numpy(wave)
    card = host.cuda()
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = DEFAULT_TF32.get("matmul", False)
        torch.backends.cudnn.allow_tf32 = DEFAULT_TF32.get("cudnn", True)
        flags = dict(matmul=torch.backends.cuda.matmul.allow_tf32, cudnn=torch.backends.cudnn.allow_tf32)
        with torch.no_grad():
            got = log_mel_filterbank(card)
            want = log_mel_filterbank(host)
            ms = time_ms(lambda: log_mel_filterbank(card), 20)
            sb_ms = time_ms(lambda: speechbrain_log_mel(card), 20)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    frames = num_fbank_frames(80000)
    got = got.cpu()
    err = (got - want).abs().max().item()
    energy = lambda x: torch.exp(x.double()) - 1e-10
    peak = energy(want).amax(dim=-1, keepdim=True)
    strong = energy(want) >= LOG_MEL_FLOOR * peak
    strong_err = (got - want).abs()[strong].max().item()
    peak_err = ((energy(got) - energy(want)).abs() / peak).max().item()
    ok = (got.shape == (B, frames, 80) and bool(torch.isfinite(got).all()) and strong_err <= LOG_MEL_TOL
          and peak_err <= LOG_MEL_PEAK_TOL)
    # the DFT product (402 rows x 400 taps a frame) and the mel product, f32
    flops = 2.0 * B * frames * (402 * 400 + 201 * 80)
    bound, bound_by = bound_ms(4.0 * B * (80000 + frames * 80), flops, "f32")
    log(f"surface[log_mel_filterbank]: {tuple(wave.shape)} -> {tuple(got.shape)} on the card against the CPU "
        f"under TF32 switches {flags}: log max_abs_err {strong_err:.3e} where the energy is >= "
        f"{LOG_MEL_FLOOR:.0e} of its frame's peak ({strong.double().mean().item():.3f} of them; tol "
        f"{LOG_MEL_TOL:.0e}), everywhere {err:.3e}; energy error {peak_err:.3e} of the frame's peak (tol "
        f"{LOG_MEL_PEAK_TOL:.0e}); {ms:.3f} ms "
        f"(bound {bound:.3f} ms, {bound_by}), speechbrain_log_mel {sb_ms:.3f} ms ({smi})")
    if not ok:
        raise AssertionError(f"surface[log_mel_filterbank]: {strong_err} > {LOG_MEL_TOL} or {peak_err} > "
                             f"{LOG_MEL_PEAK_TOL} of the peak, or a bad output")
    return dict(shape=list(got.shape), max_abs_err=err, strong_max_abs_err=strong_err, tol=LOG_MEL_TOL,
                floor=LOG_MEL_FLOOR, peak_rel_err=peak_err, peak_tol=LOG_MEL_PEAK_TOL, tf32=flags, ms=ms,
                speechbrain_log_mel_ms=sb_ms, bound_ms=bound, bound_by=bound_by, gpu=smi)


def drive_surface(out_dir, smi) -> dict:
    """Phase 11 (see the module docstring)."""
    import tempfile

    t0 = time.perf_counter()
    rec = dict(lazy=lazy_models(surface_audio()))
    with tempfile.TemporaryDirectory() as tmp:
        rec["env"] = env_overrides(tmp)
    rec["log_mel"] = log_mel_check(smi)
    rec["seconds"] = time.perf_counter() - t0
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_surface.json"), "w") as f:
            json.dump(rec, f, indent=1)
    log(f"surface phase in {rec['seconds']:.1f} s ({smi})")
    return rec


def surface_launches(rec, name) -> dict:
    """A kernel's launches in phase 11's runs."""
    out = {"lazy_engine": rec["lazy"]["launches"].get(name, 0)}
    out.update({f"env_{case}": r["launches"].get(name, 0) for case, r in rec["env"].items()})
    return out


KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# the sweep's f32 stream at B=64 (the split route): its plan, device time,
# the clusters the card holds, the A B B A against the FMA route, and the
# other batch sizes
SWEEP_F32_KEYS = ("plan", "device_ms", "max_clusters", "abba", "ms_b256", "ms_b528")
# the f32 routes on the TF32 tensor cores (se_res2, linear_stats): the
# same work's bound as f32 FMAs, the product alone in true f32, the A B B A
# against the FMA route
TF32_KEYS = ("bound_ms_f32_fma", "product_library_ms", "abba")
# the statistics kernels' extra readings: prepared and raw operands, the
# product alone (a yardstick, not the same function)
STATS_KEYS = ("device_ms", "raw_operands_ms", "product_library_ms", "plan")
# the sweep backward's extra readings, bf16 and f32 at B=64: the kernel's
# device time, the whole backward (its time, device launches and bound),
# autograd through the plain forward (the backward before the kernel), the
# argued latency floor
SWEEP_BWD_KEYS = ("device_ms", "backward_ms", "backward_launches", "backward_bound_ms", "autograd_plain_ms",
                  "argued_latency_floor_ms", "plan", "ms_turns", "ms_column", "ms_column_turns", "phase_a_ms",
                  "phase_a_share", "phase_a_bound_ms", "cycles_a_step", "backward_ms_turns", "backward_ms_column",
                  "backward_ms_column_turns", "products_ms", "max_clusters")


KERNEL_CHECKS = ("lstm", "stats", "attn", "res2", "sinc", "resnet")  # phase 2's checks, in the order they run


def run_kernel_checks(names):
    """Phase 2's checks of ``names`` (of KERNEL_CHECKS, run in that order),
    each in bf16 and f32 (ResNet34's convolutions in bf16 only) with the
    generators a whole run gives them."""
    import torch

    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device="cuda").manual_seed(0)  # the sweeps' large inputs, made on the card
    bf16_f32 = (("bf16", torch.bfloat16), ("f32", torch.float32))
    checks = dict(lstm=(check_lstm, gen, reversed(bf16_f32)), stats=(check_stats, cgen, bf16_f32),
                  attn=(check_attn, cgen, bf16_f32), res2=(check_res2, gen, bf16_f32),
                  sinc=(check_sinc, cgen, bf16_f32), resnet=(check_resnet, cgen, bf16_f32[:1]))
    out = {}
    for name in KERNEL_CHECKS:
        if name in names:
            check, g, kinds = checks[name]
            out[name] = {k: check(dt, g) for k, dt in kinds}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="directory for detailed results")
    parser.add_argument("--step-timing", action="store_true",
                        help="only time the step with host inputs (and its sync check), both engines")
    parser.add_argument("--root", default=None,
                        help="with --step-timing, --tf32-default or --engine-outputs: import diart_tpu_torch from this "
                             "tree (to compare two trees)")
    parser.add_argument("--engine-outputs", metavar="NPZ", default=None,
                        help="only write the x-vector and ECAPA engines' outputs (B=64, phase 3's hops) to NPZ")
    parser.add_argument("--compare-outputs", nargs=2, metavar=("A", "B"), default=None,
                        help="only compare two --engine-outputs files bitwise")
    parser.add_argument("--families", action="store_true",
                        help="only build the kernels and run the families phase (7)")
    parser.add_argument("--training", action="store_true",
                        help="only build the kernels and run the training and tuning phase (8)")
    parser.add_argument("--scaleout", action="store_true",
                        help="only build the kernels and run the scale-out and int8 phase (9)")
    parser.add_argument("--tf32-default", action="store_true",
                        help="only build the kernels and run phase 1's TF32-default checks")
    parser.add_argument("--jax-files", action="store_true",
                        help="only build the kernels and run the diart_tpu files and stacked frontend phase (10)")
    parser.add_argument("--surface", action="store_true",
                        help="only build the kernels and run the lazy models, DIART_TPU_* and log-mel phase (11)")
    parser.add_argument("--kernels", default=None, metavar="NAMES",
                        help="only build the kernels and run phase 2's checks of NAMES (comma-separated: "
                             + ", ".join(KERNEL_CHECKS) + ")")
    parser.add_argument("--f32-steps", action="store_true",
                        help="only build the kernels and run phase 2's f32 steps (TF32 against FMA routes, A B B A)")
    parser.add_argument("--rank-child", nargs=4, metavar=("KIND", "RANK", "PORT", "DIR"),
                        help="one process of phase 9's process groups (started by the script itself)")
    parser.add_argument("--env-child", nargs=2, metavar=("CASE", "PATH"),
                        help="one environment case of phase 11 (started by the script itself)")
    args = parser.parse_args()
    if args.root:
        global PKG_ROOT
        PKG_ROOT = os.path.abspath(args.root)
        sys.path.insert(0, PKG_ROOT)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 2
    from diart_tpu_torch.ops import _build

    if args.rank_child:
        kind, rank, port, out = args.rank_child
        return rank_child(kind, int(rank), int(port), out)
    if args.env_child:
        return env_child(*args.env_child)
    scrubbed = scrub_policy_variables()
    DEFAULT_TF32.update(matmul=torch.backends.cuda.matmul.allow_tf32, cudnn=torch.backends.cudnn.allow_tf32)
    def tf32_off():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
            f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = smi_line()
    log(f"gpu: {smi}")
    from diart_tpu_torch.precision import Precision

    log(f"policy variables removed from the environment: {scrubbed or 'none set'}; the default policy "
        f"resolves on the card to {Precision().resolved('cuda')}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    if args.compare_outputs:
        return 0 if compare_outputs(*args.compare_outputs) else 1
    if args.engine_outputs:
        import diart_tpu_torch

        tf32_off()
        log(f"engine outputs of {os.path.dirname(diart_tpu_torch.__file__)}")
        _build.build()
        engine_outputs(args.engine_outputs)
        log(f"gpu: {smi}")
        return 0

    if args.step_timing:
        import diart_tpu_torch

        tf32_off()
        log(f"step timing of {os.path.dirname(diart_tpu_torch.__file__)}")
        _build.build()
        timing = {}
        for emb in ("xvector", "ecapa"):
            engine = build_engine("cuda", B, emb)
            timing[emb] = step_timing(engine, make_audio(np.random.default_rng(1), 32, B, 8000), emb)
            del engine
        if args.out:
            with open(os.path.join(args.out, "step_timing.json"), "w") as f:
                json.dump(dict(gpu=smi, root=args.root, step_timing=timing), f, indent=1)
        log(f"gpu: {smi}")
        log(json.dumps({"step_timing": {k: {m: v[m] for m in v if not m.endswith("_all")
                                            and m != "top_device_items"} for k, v in timing.items()}}))
        return 0

    from diart_tpu_torch import native

    only = [k for k in (args.kernels or "").split(",") if k]
    if any(k not in KERNEL_CHECKS for k in only):
        parser.error(f"--kernels takes {', '.join(KERNEL_CHECKS)}; got {args.kernels}")
    t_start = t0 = time.perf_counter()
    if not (args.scaleout or args.jax_files or args.surface or args.tf32_default):
        start_scratch_builds()  # the A sides of phases 2's, 7's and 8's A B B A, beside the package's builds
        atexit.register(stop_scratch_builds)
    logs = _build.build(force=True)
    BUILD_LOGS.update(logs)
    if args.out:
        with open(os.path.join(args.out, "build_logs.txt"), "w") as f:
            f.write("\n".join(f"== {name}\n{text}" for name, text in logs.items()))
    native.build(force=True)
    log(f"built {', '.join(_build.KERNELS)} and the native RTTM assembler in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "rror", "wgmma", "Performance")):
                log(f"  [{name}] {line.strip()}")

    if args.tf32_default:
        import diart_tpu_torch

        log(f"TF32-default check of {os.path.dirname(diart_tpu_torch.__file__)}")
        try:
            tf32 = drive_tf32_default(args.out)
        except AssertionError as e:
            log(f"TF32-default check failed: {e}")
            return 1
        log(f"gpu: {smi}")
        log(json.dumps({"tf32_default": {k: v for k, v in tf32.items() if k != "switches"}}))
        return 0

    if only or args.f32_steps:
        tf32_off()
        t0 = time.perf_counter()
        checked = dict(kernels=run_kernel_checks(only))
        log(f"kernel checks ({', '.join(only) or 'none'}) in {time.perf_counter() - t0:.1f} s")
        if args.f32_steps:
            checked["f32_steps"] = drive_f32_steps()
        if args.out:
            with open(os.path.join(args.out, "chip_smoke_kernels.json"), "w") as f:
                json.dump(dict(gpu=smi, **checked), f, indent=1)
        log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
        log(f"gpu: {smi}")
        return 0

    # phase 1's TF32 checks: torch's switches as they come; every later
    # phase runs with both off
    tf32 = None
    if not (args.families or args.scaleout or args.training or args.jax_files or args.surface):
        t0 = time.perf_counter()
        tf32 = drive_tf32_default(args.out)
        log(f"TF32-default phase in {time.perf_counter() - t0:.1f} s")
    tf32_off()

    if args.families:
        families = drive_families(args.out)
        if args.out:
            with open(os.path.join(args.out, "chip_smoke_families.json"), "w") as f:
                json.dump(dict(gpu=smi, families=families), f, indent=1)
        log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
        log(f"gpu: {smi}")
        return 0

    if args.scaleout:
        scaleout = drive_scaleout_int8(args.out)
        if args.out:
            with open(os.path.join(args.out, "chip_smoke_scaleout.json"), "w") as f:
                json.dump(dict(gpu=smi, scaleout=scaleout), f, indent=1)
        log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
        log(f"gpu: {smi}")
        return 0

    if args.jax_files:
        jax_files = drive_jax_files(args.out)
        log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
        log(f"gpu: {smi}")
        log(json.dumps({"jax_files": {k: v for k, v in jax_files.items() if k != "models"}}))
        return 0

    if args.surface:
        surface = drive_surface(args.out, smi)
        log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
        log(f"gpu: {smi}")
        log(json.dumps({"surface": {k: v for k, v in surface.items() if k != "env"}}))
        return 0

    if args.training:
        training = drive_training(args.out)
        if args.out:
            with open(os.path.join(args.out, "chip_smoke_training.json"), "w") as f:
                json.dump(dict(gpu=smi, training=training), f, indent=1)
        log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
        log(f"gpu: {smi}")
        return 0

    t0 = time.perf_counter()
    checked = run_kernel_checks(KERNEL_CHECKS)
    lstm, stats, attn, res2, sinc, resnet = (checked[k] for k in KERNEL_CHECKS)
    int8 = check_int8()
    f32_steps = drive_f32_steps()
    log(f"kernel checks in {time.perf_counter() - t0:.1f} s")
    result = dict(gpu=smi, tf32_default=tf32, lstm=lstm, stats=stats, attn=attn, res2=res2, sinc=sinc,
                  resnet=resnet, f32_steps=f32_steps)

    runs, probes = {}, {}
    for emb in ("xvector", "ecapa"):
        t0 = time.perf_counter()
        audio = make_audio(np.random.default_rng(0), HOPS + 20, B, 8000)
        runs[emb] = drive_engine(emb, audio, args.out)
        probes[emb] = compare_cpu(emb, audio)
        log(f"engine[{emb}] phase in {time.perf_counter() - t0:.1f} s")

    # the serving path: session and cohorts over each engine
    sessions = {}
    for emb in ("xvector", "ecapa"):
        t0 = time.perf_counter()
        audio = make_audio(np.random.default_rng(1), SESSION_HOPS + 8, B, 8000)
        engine = build_engine("cuda", B, emb)
        timing = step_timing(engine, audio, emb)
        del engine
        if timing["sync_check"] != "no host sync":
            raise AssertionError(f"step[{emb}] waits for the card: {timing['sync_check']}")
        sessions[emb] = dict(step=timing, session=drive_session(emb, audio, args.out),
                             cohorts=drive_cohorts(emb, audio))
        log(f"session[{emb}] phase in {time.perf_counter() - t0:.1f} s")

    # the pipelines: one stream's chunks through the full-width pipelines
    pipelines, pipe_cpu = {}, {}
    t0 = time.perf_counter()
    chunks = pipeline_chunks(make_audio(np.random.default_rng(2), 60, 1, 8000).reshape(-1))
    assert len(chunks) == PIPE_CHUNKS, len(chunks)
    for kind in PIPELINES:
        pipelines[kind] = drive_pipeline(kind, chunks, args.out)
        pipe_cpu[kind] = compare_pipeline_cpu(kind, chunks)
    session_tensors = check_session_tensor_blocks(make_audio(np.random.default_rng(3), 16, 4, 8000))
    log(f"pipelines phase in {time.perf_counter() - t0:.1f} s")

    # the runtime and the console entry points
    t0 = time.perf_counter()
    runtime = drive_runtime(args.out)
    log(f"runtime phase in {time.perf_counter() - t0:.1f} s")

    # the model layer: the families as the engine's arms
    t0 = time.perf_counter()
    families = drive_families(args.out)
    log(f"families phase in {time.perf_counter() - t0:.1f} s")

    # training and tuning: the kernels' gradients, both trainers, the tuner
    t0 = time.perf_counter()
    training = drive_training(args.out)
    log(f"training phase in {time.perf_counter() - t0:.1f} s")

    # scale-out and int8: the int8 convolution and the five families with the
    # int8 trunk, the sharded engines and server on one card, process groups
    t0 = time.perf_counter()
    scaleout = drive_scaleout_int8(args.out, int8)
    log(f"scale-out and int8 phase in {time.perf_counter() - t0:.1f} s")

    # what diart_tpu writes (model files, a session, a trainer's directory)
    # on the card, and the stacked SincNet frontend
    jax_files = drive_jax_files(args.out)

    # the rest of diart_tpu's surface: lazy models, the DIART_TPU_* variables
    # (in child processes), the generic log-mel frontend
    surface = drive_surface(args.out, smi)

    # the main paths run the bf16 LSTM stream and bf16 embedding trunks
    xv, ec = runs["xvector"]["launches"], runs["ecapa"]["launches"]
    on_session = lambda name: {e: sessions[e]["session"]["launches"][name] for e in sessions}
    on_pipeline = lambda name: {k: pipelines[k]["launches"][name] for k in pipelines}
    on_family = lambda name: {f: r["engine"]["launches"][name] for f, r in families["runs"].items()}
    # (the profiler's per-call device time reads a tenth of the CUDA-event
    # time this late in the run, so the new callers' entries give the latter)
    at_shape = lambda rec: {k: rec["bf16"][k] for k in KEYS + ("product_library_ms", "shape")}
    # each kernel's gradient (bf16 at the top, as the main paths run; f32
    # beside it) and its launches a training step
    grads = training["kernel_grads"]
    sweep_bwd = training["sweep_bwd"]
    on_training = lambda name: {k: r["launches_per_step"][name] for k, r in training["runs"].items()}
    grad_keys = ("grad_max_abs_err", "grad_tol", "bitwise", "forward_ms", "backward_ms", "plain_backward_ms")
    with_grad = lambda name: dict(**{k: grads[name]["bf16"][k] for k in grad_keys},
                                  grad_f32={k: grads[name]["f32"][k] for k in grad_keys},
                                  launches_training_step=on_training(name))
    on_jax_files = lambda name: jax_files_launches(jax_files, name)
    on_surface = lambda name: surface_launches(surface, name)
    on_runtime = lambda name: dict(
        **{f"inference_{k}": r["launches"][name] for k, r in runtime["inference"].items()},
        benchmark_multi_stream=runtime["benchmark"]["launches"][name],
        **{f"server_{k}": r["launches"][name] for k, r in runtime["server"].items()})
    kernels = [
        dict(name="lstm_sweep", route="cuda", source="diart_tpu_torch/csrc/lstm_sweep.cu",
             replaces="diart_tpu/ops/pallas_lstm.py:494", launches=ec["lstm_sweep"],
             launches_xvector_path=xv["lstm_sweep"], launches_session_paths=on_session("lstm_sweep"),
             launches_pipeline_paths=on_pipeline("lstm_sweep"), launches_runtime_paths=on_runtime("lstm_sweep"),
             launches_family_paths=on_family("lstm_sweep"), launches_jax_files_paths=on_jax_files("lstm_sweep"),
             launches_surface_paths=on_surface("lstm_sweep"),
             **{k: lstm["bf16"][k] for k in KEYS},
             ms_b256=lstm["bf16"]["ms_b256"], ms_b528=lstm["bf16"]["ms_b528"], plan=lstm["bf16"]["plan"],
             f32={k: lstm["f32"][k] for k in KEYS + SWEEP_F32_KEYS}, seg_step_f32_forward_b32=training["sweep_fwd_seg_step"],
             **with_grad("lstm_sweep")),
        dict(name="lstm_sweep_bwd", route="cuda", source="diart_tpu_torch/csrc/lstm_sweep_bwd.cu",
             replaces="diart_tpu/ops/pallas_lstm.py:303", launches=on_training("lstm_sweep_bwd")["seg"],
             launches_training_steps=on_training("lstm_sweep_bwd"),
             launches_jax_files_paths=on_jax_files("lstm_sweep_bwd"),
             **{k: sweep_bwd["bf16"]["B64"][k] for k in KEYS}, ms_f32=sweep_bwd["f32"]["B64"]["ms"],
             max_abs_err_f32=sweep_bwd["f32"]["B64"]["max_abs_err"],
             max_abs_err_b32={d: sweep_bwd[d]["B32"]["max_abs_err"] for d in sweep_bwd},
             ms_b32={d: sweep_bwd[d]["B32"]["ms"] for d in sweep_bwd},
             ms_column_b32={d: sweep_bwd[d]["B32"]["ms_column"] for d in sweep_bwd},
             seg_step_b32=training["sweep_bwd_seg_step"],
             **{k: {d: sweep_bwd[d]["B64"][k] for d in sweep_bwd} for k in SWEEP_BWD_KEYS}),
        dict(name="linear_stats", route="cuda", source="diart_tpu_torch/csrc/linear_stats.cu",
             replaces="diart_tpu/ops/pallas_stats.py:163", launches=xv["linear_stats"],
             launches_session_paths=on_session("linear_stats"),
             launches_pipeline_paths=on_pipeline("linear_stats"), launches_runtime_paths=on_runtime("linear_stats"),
             launches_family_paths=on_family("linear_stats"), launches_jax_files_paths=on_jax_files("linear_stats"),
             launches_surface_paths=on_surface("linear_stats"),
             at_xvect_sb=dict(at_shape(families["kernels"]["linear_stats_xvect_sb"]),
                              ms_f32=families["kernels"]["linear_stats_xvect_sb"]["f32"]["ms"]),
             **{k: stats["bf16"][k] for k in KEYS + STATS_KEYS}, ms_f32=stats["f32"]["ms"],
             f32={k: stats["f32"][k] for k in KEYS + STATS_KEYS + TF32_KEYS + ("xvect_sb",)},
             **with_grad("linear_stats")),
        dict(name="attn_stats", route="cuda", source="diart_tpu_torch/csrc/attn_stats.cu",
             replaces="diart_tpu/ops/pallas_attn_stats.py:170", launches=ec["attn_stats"],
             launches_session_paths=on_session("attn_stats"),
             launches_pipeline_paths=on_pipeline("attn_stats"), launches_runtime_paths=on_runtime("attn_stats"),
             launches_family_paths=on_family("attn_stats"), launches_jax_files_paths=on_jax_files("attn_stats"),
             launches_surface_paths=on_surface("attn_stats"),
             at_titanet=dict(at_shape(families["kernels"]["attn_stats_titanet"]),
                             ms_f32=families["kernels"]["attn_stats_titanet"]["f32"]["ms"]),
             **{k: attn["bf16"][k] for k in KEYS + STATS_KEYS}, ms_f32=attn["f32"]["ms"],
             **with_grad("attn_stats")),
        dict(name="se_res2", route="cuda", source="diart_tpu_torch/csrc/se_res2.cu",
             replaces="diart_tpu/ops/pallas_res2.py:294", launches=ec["se_res2"],
             launches_session_paths=on_session("se_res2"),
             launches_pipeline_paths=on_pipeline("se_res2"), launches_runtime_paths=on_runtime("se_res2"),
             launches_family_paths=on_family("se_res2"), launches_jax_files_paths=on_jax_files("se_res2"),
             launches_surface_paths=on_surface("se_res2"),
             **{k: res2["bf16"][k] for k in KEYS}, ms_b8=res2["bf16"]["ms_b8"],
             device_ms=res2["bf16"]["device_ms"],
             ms_f32=res2["f32"]["ms"], by_launch=res2["bf16"]["by_launch"],
             f32={k: res2["f32"][k] for k in KEYS + TF32_KEYS + ("device_ms", "by_launch", "fma_by_launch", "ms_b8",
                                                             "plan")},
             **with_grad("se_res2"),
             stage_mode=dict(res2["bf16"]["stage"], entry="se_res2_staged",
                             replaces=["scripts/res2_stage_debug.py:141",
                                       "scripts/res2_stage_debug.py:49",
                                       "scripts/res2_fix_experiments.py:126"],
                             launches=ec["se_res2_staged"],
                             stages_checked=sum(res2[k]["stage"]["stages_checked"] for k in res2),
                             max_abs_err=max(res2[k]["stage"]["max_abs_err"] for k in res2),
                             library_ms=None)),
        dict(int8_entry(scaleout), launches_surface_paths=on_surface("int8_conv")),
        dict(name="sinc_frontend", route="cuda", source="diart_tpu_torch/csrc/sinc_frontend.cu",
             replaces="diart_tpu/models/sincnet.py:138 and :212 (XLA's convolution and frontend_pool)",
             **{k: sinc["bf16"][k] for k in KEYS}, ms_f32=sinc["f32"]["ms"],
             at_b256={k: sinc["bf16"]["at_b256"][k] for k in KEYS}, ptxas=sinc["f32"]["ptxas"]),
        dict(name="resnet_conv", route="cuda", source="diart_tpu_torch/csrc/resnet_conv.cu",
             replaces="diart_tpu/models/resnet.py (XLA's conv_general_dilated, the batch norms, ReLU and the adds)",
             launches_family_paths=on_family("resnet_conv"),
             **{k: resnet["bf16"][k] for k in KEYS}, at_b256={n: {k: r[k] for k in KEYS}
                                                              for n, r in resnet["bf16"]["cases"].items()},
             trunk_b256=resnet["bf16"]["trunk"], ptxas=resnet["bf16"]["ptxas"]),
    ]
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(result, engines=runs, probes=probes, sessions=sessions, pipelines=pipelines,
                           pipelines_vs_cpu=pipe_cpu, session_tensor_blocks=session_tensors, runtime=runtime,
                           families=families, training=training, scaleout=scaleout, jax_files=jax_files,
                           surface=surface, kernels=kernels), f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
    log(f"gpu: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
