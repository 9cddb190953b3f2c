#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

Run from the repository root with no arguments (``python3 chip_smoke.py``);
``--out DIR`` also writes the detailed results and a profile there.

Phases (any failure exits non-zero):

1. Build the four hand-written kernels (``diart_tpu_torch/csrc/*.cu``, one
   ``nvcc`` each, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths with 64 streams: the LSTM sweep at T=293,
   H=128 (f32 and bf16 streams, raw and packed ``w_hh``), with other batch
   sizes (3 to 600) and hidden sizes on both of its routes; the stats head
   at X (64, 279, 512) (bf16 and f32), W (512, 1500), 4 speakers; the
   attention statistics at x (64, 501, 1536), hidden (64, 501, 128), 4
   speakers (bf16 and f32), both with prepared and raw operands, with
   streams run alone against their rows of the whole batch (bitwise),
   beside the cuBLAS product alone, and over a sweep of batch, length,
   width and speaker count (bitwise equal over repeated calls); the
   SE-Res2Block at (64, 501, 512), scale 8,
   dilations 2, 3, 4 (bf16 and f32), with every stage of its stage mode,
   other batch sizes, and other lengths and time tiles of its cascade
   (the result must not depend on the tile). Print each error beside its
   tolerance, the kernel / plain / library times (CUDA events) and bounds,
   the LSTM sweep at B=256 and the SE-Res2Block at B=8, and the device
   time of each of the block's launches by name.
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
   ``autograd.Function`` (the kernel forward, autograd through its plain
   version backward) against autograd through the plain version at the
   main paths' shapes with B=64, bf16 and f32: every input's gradient for a
   seeded cotangent, the forward's, the backward's and the plain
   backward's times; the trainers at full width on B=32 chunks of 5 s for
   6 AdamW steps: ``tpu/pyannet`` with PIT-BCE (f32, lr 1e-3, random
   targets), ``tpu/xvector`` and ``tpu/ecapa`` with AAM-softmax (bf16
   trunks, lr 1e-5, 8 tone-plus-noise speakers): finite losses, the last
   below the first, every parameter's gradient finite and nonzero (SincNet
   and every LSTM layer's ``w_ih`` / ``w_hh``, every SE-Res2Block
   parameter), each kernel's launches a step; the forward / backward /
   update split, device busy and idle share of a step; the trained model's
   engine equal to a fresh one loaded with its weights; one f32 step of
   each trainer on 2 samples against the CPU; 3 steps, a checkpoint and 3
   more bitwise equal to 6 straight; ``python -m
   diart_tpu_torch.console.tune --multi-stream`` in a subprocess over 4
   synthesized files with reference RTTMs (3 trials in the study) and an
   in-process ``Optimizer(multi_stream=True)``: one cached engine for every
   trial, every ``set_hyperparameters`` under the sync check, each trial's
   value 100 x |DER| of its RTTM files; ms a trial.
9. Print ``{"kernels": [...]}`` (with each kernel's launches on the
   pipelines', the runtime's, the families' and the training runs, and its
   gradient's error and times) and, last, ``{"ok": true, "device": ...}``.

``--families`` runs only the build and phase 7; ``--training`` only the
build and phase 8.
``--step-timing [--root TREE]`` runs only the step timing of phase 4 (its
sync check recorded, not fatal), importing ``diart_tpu_torch`` from
``TREE``: run it on two trees in the order A B B A to compare commits.

The script imports only the port (never jax or diart_tpu) and exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}  # tensor cores; f32 outside them
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


def bound_ms(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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

    proj, w_hh = inputs(T_LSTM, B, H)
    packed = lstm_sweep.pack_w_hh(w_hh, dtype)  # laid out once, as the model does
    got = lstm_sweep.lstm_sweep_tm(proj, packed)
    want = lstm_sweep.lstm_sweep_reference(proj, w_hh)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, lstm_sweep.lstm_sweep_tm(proj, w_hh)):
        raise AssertionError(f"lstm_sweep[{kind}]: the raw and the packed w_hh give different results")
    ms = time_ms(lambda: lstm_sweep.lstm_sweep_tm(proj, packed), 20)
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
    elt = proj.element_size()
    nbytes = proj.numel() * elt + w_hh.numel() * 4 + got.numel() * elt
    flops = 2.0 * T_LSTM * 2 * B * 4 * H * H
    bms, by = bound_ms(nbytes, flops, kind)
    plan = lstm_sweep.launch_plan(B, H, dtype, proj.device)
    floor_ms = T_LSTM * LSTM_STEP_FLOOR_CYCLES / sm_clock_hz() * 1e3 if plan["route"] == "mma" else None
    # off B=64: 256 streams (the same plan on more blocks) and 528 (one wave of
    # 8-row blocks on the tensor-core route)
    p256, p528 = inputs(T_LSTM, 256, H)[0], inputs(T_LSTM, 528, H)[0]
    ms_256 = time_ms(lambda: lstm_sweep.lstm_sweep_tm(p256, packed), 20)
    ms_528 = time_ms(lambda: lstm_sweep.lstm_sweep_tm(p528, packed), 20)
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
    # the other plans: the pipelines' calls (1 and 8 chunks at the full
    # length), batch tiles and the one-wave edge on short sequences, and other
    # hidden sizes (64 takes the tensor-core route in bf16; 16, 40 and 136 the
    # FMA route)
    cases = [(T_LSTM, 1, H), (T_LSTM, 8, H)]
    cases += [(37, batch, H) for batch in (3, 8, 100, 200, 528, 529, 600)]
    cases += [(37, 5, 64), (37, 9, 16), (21, 3, 40), (21, 3, 136)]
    case_errs = []
    for time_, batch, hidden in cases:
        p, w = inputs(time_, batch, hidden)
        e = (lstm_sweep.lstm_sweep_tm(p, w).float()
             - lstm_sweep.lstm_sweep_reference(p, w).float()).abs().max().item()
        log(f"  lstm_sweep[{kind}] T={time_} B={batch} H={hidden} "
            f"plan={lstm_sweep.launch_plan(batch, hidden, dtype, dev)}: max_abs_err={e:.3e} (tol {tol:.1e})")
        if not e <= tol:
            raise AssertionError(f"lstm_sweep[{kind}] B={batch} H={hidden} disagrees with its plain version")
        case_errs.append(dict(T=time_, B=batch, H=hidden, max_abs_err=e))
    return dict(max_abs_err=err, tol=tol, ms=ms, raw_w_hh_ms=raw_ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, cudnn_lstm_ms=cudnn_ms, input_projection_ms=proj_ms,
                argued_latency_floor_ms=floor_ms, ms_b256=ms_256, ms_b528=ms_528, plan=plan,
                cases=case_errs)


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

    kind = "f32" if dtype == torch.float32 else "bf16"
    B, T_EMB, C_IN, C_OUT, S = shape
    x, w, b, scale, shift, wt = stats_inputs(B, T_EMB, C_IN, C_OUT, S, dtype, gen)
    ops = ls.prepare_stats_operands(w, b, scale, shift, dtype)  # once, as the model does
    want = ls.linear_stats_reference(x, w, b, scale, shift, wt)
    got = ls.fused_linear_stats(x, ops, weights=wt)
    torch.cuda.synchronize()
    err, tol = held_to(got, want, STATS_TOL)
    if not bitwise_equal(got, ls.fused_linear_stats(x, w, b, scale, shift, wt)):
        raise AssertionError(f"linear_stats[{kind}]: raw and prepared operands give different results")
    plan = ls._plan(x, ops, S)
    for lo, hi in PART_STREAMS:
        part = ls.fused_linear_stats(x[lo:hi], ops, weights=wt[lo:hi])
        if not bitwise_equal([g[lo:hi] for g in got], part):
            raise AssertionError(f"linear_stats[{kind}]: streams {lo}..{hi - 1} alone "
                                 f"({ls._plan(x[lo:hi], ops, S)}) differ from their rows at B={B}")
    ms = time_ms(lambda: ls.fused_linear_stats(x, ops, weights=wt), 20)
    device_ms = device_times(lambda: ls.fused_linear_stats(x, ops, weights=wt), "linear_stats")[0][1]
    raw_ms = time_ms(lambda: ls.fused_linear_stats(x, w, b, scale, shift, wt), 20)
    plain_ms = time_ms(lambda: ls.linear_stats_reference(x, w, b, scale, shift, wt), 20)
    wl = w.to(dtype)
    product_ms = time_ms(lambda: torch.matmul(x, wl), 20)  # yardstick: the product alone
    nbytes = x.numel() * x.element_size() + sum(t.numel() * 4 for t in (w, b, scale, shift, wt))
    nbytes += 2 * B * S * C_OUT * 4
    gemm = 2.0 * B * T_EMB * C_IN * C_OUT
    flops = gemm + 6.0 * B * T_EMB * C_OUT + 4.0 * B * S * T_EMB * C_OUT
    bms, by = bound_ms(nbytes, flops, kind)
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
    if not sweep:
        return main
    sweep_worst = 0.0
    sweep = []
    for case in STATS_SWEEP if dtype == torch.bfloat16 else STATS_SWEEP[::3]:
        args = stats_inputs(*case, dtype, gen)
        batch, time_, c_in, channels, speakers = case
        cops = ls.prepare_stats_operands(*args[1:5], dtype)
        got = ls.fused_linear_stats(args[0], cops, weights=args[5])
        e, t = held_to(got, ls.linear_stats_reference(*args), STATS_TOL)
        p = ls._plan(args[0], cops, speakers)
        same = bitwise_equal(got, ls.fused_linear_stats(args[0], cops, weights=args[5]))
        log(f"  linear_stats[{kind}] B={batch} T={time_} C_in={c_in} C={channels} S={speakers} "
            f"{p['route']} grid {p['grid']} x{p['streams_per_block']} smem {p['smem']}: "
            f"max_abs_err={e:.3e} (tol {t:.3e}), repeat bitwise {same}")
        if not (e <= t and same):
            raise AssertionError(f"linear_stats[{kind}] fails at {case}")
        sweep_worst = max(sweep_worst, e / t)
        sweep.append(dict(case=case, max_abs_err=e, tol=t))
    return dict(main, sweep_cases=len(STATS_SWEEP), sweep_worst_err_over_tol=sweep_worst, sweep=sweep)


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
    got = at.fused_attentive_stats(x, hidden, ops, weights=wt)
    torch.cuda.synchronize()
    err, tol = held_to(got, want, ATTN_TOL, floor=1.0)
    if not bitwise_equal(got, at.fused_attentive_stats(x, hidden, w2, b2, wt)):
        raise AssertionError(f"attn_stats[{kind}]: raw and prepared operands give different results")
    plan = at._plan(x, hidden, S)
    for lo, hi in PART_STREAMS:
        part = at.fused_attentive_stats(x[lo:hi], hidden[lo:hi], ops, weights=wt[lo:hi])
        if not bitwise_equal([g[lo:hi] for g in got], part):
            raise AssertionError(f"attn_stats[{kind}]: streams {lo}..{hi - 1} alone "
                                 f"({at._plan(x[lo:hi], hidden, S)}) differ from their rows at B={B}")
    ms = time_ms(lambda: at.fused_attentive_stats(x, hidden, ops, weights=wt), 20)
    device_ms = device_times(lambda: at.fused_attentive_stats(x, hidden, ops, weights=wt), "attn_stats")[0][1]
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
        got = at.fused_attentive_stats(x_, h_, cops, weights=wt_)
        e, t = held_to(got, at.attentive_stats_reference(x_, h_, w_, b_, wt_), ATTN_TOL, floor=1.0)
        p = at._plan(x_, h_, speakers)
        same = bitwise_equal(got, at.fused_attentive_stats(x_, h_, cops, weights=wt_))
        log(f"  attn_stats[{kind}] B={batch} T={time_} C={channels} H={hdim} S={speakers} "
            f"grid {p['grid']} x{p['streams_per_block']} smem {p['smem']}: "
            f"max_abs_err={e:.3e} (tol {t:.3e}), repeat bitwise {same}")
        if not (e <= t and same):
            raise AssertionError(f"attn_stats[{kind}] fails at {case}")
        sweep_worst = max(sweep_worst, e / t)
        sweep.append(dict(case=case, max_abs_err=e, tol=t))
        del x_, h_, w_, b_, wt_, got
    return dict(main, sweep_cases=len(ATTN_SWEEP), sweep_worst_err_over_tol=sweep_worst, sweep=sweep)


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


def device_times(call, what: str, calls: int = 10):
    """Device time of each kernel that ``call`` launches, from a profile of
    ``calls`` calls, longest first: (name, ms per call, launches per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    call()
    torch.cuda.synchronize()
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
    if not rows:
        raise AssertionError(f"the profiler saw no device time for {what}")
    return sorted(rows, key=lambda r: -r[1])


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
        got = se_res2.fused_se_res2_block(x, ops, d)
        want = se_res2.se_res2_block_reference(x, *params, d)
        torch.cuda.synchronize()
        errs[d] = held(got, want, f"block d={d}", residual=x)
        for stage in range(RES2_SCALE):
            got = se_res2.se_res2_staged(x, ops, d, stage)
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
        got_c = se_res2.se_res2_staged(xb, ops, 4, last)
        got_b = se_res2.fused_se_res2_block(xb, ops, 4)
        tile = se_res2.cascade_tile(batch, time_, dtype, sms)
        held(got_c, se_res2.se_res2_stage_reference(xb, params, 4, last), f"concat T={time_} tile={tile}")
        held(got_b, se_res2.se_res2_block_reference(xb, *params, 4), f"block T={time_} tile={tile}",
             residual=xb)
        if batch > 1 and se_res2.cascade_tile(1, time_, dtype, sms) != tile:
            one_c = se_res2.se_res2_staged(xb[:1], ops, 4, last)
            one_b = se_res2.fused_se_res2_block(xb[:1], ops, 4)
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
    ms = time_ms(lambda: se_res2.fused_se_res2_block(x, ops, 2), 20)
    plain_ms = time_ms(lambda: se_res2.se_res2_block_reference(x, *params, 2), 5)
    elt = x.element_size()
    groups, width = RES2_SCALE - 1, C_ECAPA // RES2_SCALE
    nbytes = 2 * x.numel() * elt + (2 * C_ECAPA * C_ECAPA + groups * 3 * width * width) * elt
    nbytes += 4 * (9 * C_ECAPA + 3 * groups * width + 2 * C_ECAPA * SE_HIDDEN + SE_HIDDEN)
    flops = 2.0 * B * T_ECAPA * (2 * C_ECAPA * C_ECAPA + groups * 3 * width * width)
    flops += 2.0 * B * 2 * C_ECAPA * SE_HIDDEN
    bms, by = bound_ms(nbytes, flops, kind)
    x8 = x[:8].contiguous()
    ms_b8 = time_ms(lambda: se_res2.fused_se_res2_block(x8, ops, 2), 20)
    by_launch = device_times(lambda: se_res2.fused_se_res2_block(x, ops, 2), "the SE-Res2Block")
    # the stage mode's longest run: z1 and the whole cascade (the concat)
    stage_ms = time_ms(lambda: se_res2.se_res2_staged(x, ops, 2, last), 20)
    stage_plain_ms = time_ms(lambda: se_res2.se_res2_stage_reference(x, params, 2, last), 5)
    stage_bytes = 2 * x.numel() * elt + (C_ECAPA * C_ECAPA + groups * 3 * width * width) * elt
    stage_bytes += 4 * (3 * C_ECAPA + 3 * groups * width)
    stage_flops = 2.0 * B * T_ECAPA * (C_ECAPA * C_ECAPA + groups * 3 * width * width)
    stage_bms, stage_by = bound_ms(stage_bytes, stage_flops, kind)
    log(
        f"se_res2[{kind}] x=({B},{T_ECAPA},{C_ECAPA}) scale {RES2_SCALE}: block max_abs_err "
        + ", ".join(f"d={d} {e:.3e} (tol {t:.3e})" for d, (e, t) in errs.items())
        + f"; {len(stage_errs)} stages max_abs_err={max(stage_errs):.3e}; batch 1/2/3/8 ok; "
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
    stage = dict(max_abs_err=max(stage_errs), stages_checked=len(stage_errs), ms=stage_ms,
                 plain_ms=stage_plain_ms, bound_ms=stage_bms, bound_by=stage_by)
    return dict(max_abs_err=err, tol=tol, worst_mean_err=worst_mean, unrounded_gate_mean_err=mutant,
                ms=ms, plain_ms=plain_ms, ms_b8=ms_b8, device_ms=device_ms,
                by_launch=[dict(name=n, ms=m, per_block=c) for n, m, c in by_launch],
                bound_ms=bms, bound_by=by, library_ms=None, stage=stage)


# --------------------------------------------------------------------- #
def make_audio(rng, hops, batch, step):
    """int16 PCM: noise bursts of per-stream loudness, so windows differ."""
    t = np.arange(hops * step) / 16000.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (0.2 + 0.05 * np.arange(batch))[:, None] * t[None, :])
    sig = rng.normal(size=(batch, hops * step)) * env * 4000
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    return pcm.reshape(batch, hops, step).transpose(1, 0, 2).copy()  # (hops, B, step)


EMBEDDINGS = {"xvector": "tpu/xvector", "ecapa": "tpu/ecapa"}


def build_engine(device, batch, emb="xvector", seg_dtype="f32", emb_dtype="bf16", precision=None):
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    seg = SegmentationModel.from_registry("tpu/pyannet", device=device, seed=0, dtype=seg_dtype)
    model = EmbeddingModel.from_registry(EMBEDDINGS[emb], device=device, seed=1, dtype=emb_dtype)
    return MultiStreamEngine(
        seg, model, duration=5.0, step=0.5, latency=0.5, sample_rate=16000,
        max_speakers=20, batch_size=batch, precision=precision,
    )


def launch_counters() -> dict:
    """Each kernel's wrapper, which counts its launches."""
    from diart_tpu_torch.ops import attn_stats, linear_stats, lstm_sweep, se_res2

    return {
        "lstm_sweep": lstm_sweep.lstm_sweep_tm,
        "linear_stats": linear_stats.fused_linear_stats,
        "attn_stats": attn_stats.fused_attentive_stats,
        "se_res2": se_res2.fused_se_res2_block,
        "se_res2_staged": se_res2.se_res2_staged,
    }


def path_launches(kind, lstm_layers: int) -> dict:
    """Each counted kernel's launches in one step or pipeline call of the
    path ``kind`` (``xvector``, ``ecapa`` or ``vad``)."""
    return {"lstm_sweep": lstm_layers, "linear_stats": int(kind == "xvector"),
            "attn_stats": int(kind == "ecapa"), "se_res2": 3 * int(kind == "ecapa"),
            "se_res2_staged": 0}


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


def compare_cpu(emb, audio):
    """The engine with embedding ``emb`` for 2 streams on the card against
    the same engine on the CPU (the kernels' plain versions): the frame
    scores that ``probe_frame_scores`` gives after 10 hops, in f32 and in
    the serving configuration, and 12 f32 hops with clustering active."""
    import torch
    from diart_tpu_torch.precision import Precision

    results = {}
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
            raise AssertionError(f"probe [{emb}, {name}] disagrees with the CPU engine")
        results[name] = dict(seg_err=seg_err, seg_tol=seg_tol, emb_err=emb_err, emb_tol=emb_tol)
        if name != "f32":
            continue
        agg_err = (aggs[0] - aggs[1]).abs().max().item()
        log(f"steps vs CPU [{emb}, f32, {hops} hops, 2 streams]: aggregated max_abs_err={agg_err:.3e} "
            f"(tol {agg_tol:.0e}); active centres card/CPU {centres[0]}/{centres[1]}")
        if not (agg_err <= agg_tol and centres[0] == centres[1] and centres[0] > 0):
            raise AssertionError(f"engine[{emb}] steps on the card disagree with the CPU engine")
        results["steps_f32"] = dict(agg_err=agg_err, tol=agg_tol, active_centres=centres[0])
    return results


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
            bits = pending.fetch[0].numpy()
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
                        bits=sum(t.numel() * t.element_size() for t in pending.fetch),
                        scores=sum(t.numel() * t.element_size() for t in s_pending.fetch))
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


def stream_cli(wav, out_dir, *extra):
    """``python -m diart_tpu_torch.console.stream <wav> --no-plot --output
    <dir>`` in a subprocess on the card, with the default models and
    RUNTIME_CLI_ARGS. ``NVIDIA_TF32_OVERRIDE=0`` keeps TF32 out of its
    cuDNN convolutions, as this script's ``allow_tf32 = False`` does here,
    so both processes round alike. The RTTM text, the wall and the CLI's
    own profile line. ``extra``: more arguments."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    cmd = [sys.executable, "-m", "diart_tpu_torch.console.stream", wav, "--no-plot", "--output",
           out_dir, *RUNTIME_CLI_ARGS, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=root, env=env)
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
    # Parallelize: 2 spawn workers over 2 files, the models crossing as CUDA IPC handles
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
    powerset model: the fused stats head; ResNet34: none)."""
    return {"lstm_sweep": 4, "linear_stats": int(family in ("xvect-sb", "powerset")),
            "attn_stats": int(family == "titanet"), "se_res2": 0, "se_res2_staged": 0}


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
# may differ from run to run: within 1e-5 (f32) / 1e-2 (bf16: a flipped
# rounding of a bf16 gradient is 2**-8 of it) of the largest gradient
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
# each counted kernel's launches in one training step (forward only: the
# backward is the plain versions' autograd)
TRAIN_LAUNCHES = {
    "seg": dict(lstm_sweep=4, linear_stats=0, attn_stats=0, se_res2=0, se_res2_staged=0),
    "xvector": dict(lstm_sweep=0, linear_stats=1, attn_stats=0, se_res2=0, se_res2_staged=0),
    "ecapa": dict(lstm_sweep=0, linear_stats=0, attn_stats=1, se_res2=3, se_res2_staged=0),
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

    # one more step, split with CUDA events as train_step runs it
    module, ev = state.module, [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
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
    split = dict(forward_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
                 update_ms=ev[2].elapsed_time(ev[3]))
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    log(f"train[{kind}] step wall median {step_ms:.2f} ms (all: {', '.join(f'{w:.1f}' for w in walls)}); "
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

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)  # inside the checkout
    try:
        t0 = time.perf_counter()
        grads = check_kernel_grads()
        log(f"kernel gradients in {time.perf_counter() - t0:.1f} s")
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
        return dict(kernel_grads=grads, runs=runs, vs_cpu=vs_cpu, resume=resume, tuning=tuning,
                    seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# the statistics kernels' extra readings: prepared and raw operands, the
# product alone (a yardstick, not the same function)
STATS_KEYS = ("device_ms", "raw_operands_ms", "product_library_ms", "plan")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="directory for detailed results")
    parser.add_argument("--step-timing", action="store_true",
                        help="only time the step with host inputs (and its sync check), both engines")
    parser.add_argument("--root", default=None,
                        help="with --step-timing: import diart_tpu_torch from this tree (to compare two trees)")
    parser.add_argument("--families", action="store_true",
                        help="only build the kernels and run the families phase (7)")
    parser.add_argument("--training", action="store_true",
                        help="only build the kernels and run the training and tuning phase (8)")
    args = parser.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 2
    from diart_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = smi_line()
    log(f"gpu: {smi}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    if args.step_timing:
        import diart_tpu_torch

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

    t_start = t0 = time.perf_counter()
    logs = _build.build(force=True)
    native.build(force=True)
    log(f"built {', '.join(_build.KERNELS)} and the native RTTM assembler in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")

    if args.families:
        families = drive_families(args.out)
        if args.out:
            with open(os.path.join(args.out, "chip_smoke_families.json"), "w") as f:
                json.dump(dict(gpu=smi, families=families), f, indent=1)
        log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
        log(f"gpu: {smi}")
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
    gen = torch.Generator().manual_seed(0)
    bf16_f32 = (("bf16", torch.bfloat16), ("f32", torch.float32))
    lstm = {k: check_lstm(dt, gen) for k, dt in reversed(bf16_f32)}
    cgen = torch.Generator(device="cuda").manual_seed(0)  # the sweeps' large inputs, made on the card
    stats = {k: check_stats(dt, cgen) for k, dt in bf16_f32}
    attn = {k: check_attn(dt, cgen) for k, dt in bf16_f32}
    res2 = {k: check_res2(dt, gen) for k, dt in bf16_f32}
    log(f"kernel checks in {time.perf_counter() - t0:.1f} s")
    result = dict(gpu=smi, lstm=lstm, stats=stats, attn=attn, res2=res2)

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
    on_training = lambda name: {k: r["launches_per_step"][name] for k, r in training["runs"].items()}
    grad_keys = ("grad_max_abs_err", "grad_tol", "bitwise", "forward_ms", "backward_ms", "plain_backward_ms")
    with_grad = lambda name: dict(**{k: grads[name]["bf16"][k] for k in grad_keys},
                                  grad_f32={k: grads[name]["f32"][k] for k in grad_keys},
                                  launches_training_step=on_training(name))
    on_runtime = lambda name: dict(
        **{f"inference_{k}": r["launches"][name] for k, r in runtime["inference"].items()},
        benchmark_multi_stream=runtime["benchmark"]["launches"][name],
        **{f"server_{k}": r["launches"][name] for k, r in runtime["server"].items()})
    kernels = [
        dict(name="lstm_sweep", route="cuda", source="diart_tpu_torch/csrc/lstm_sweep.cu",
             replaces="diart_tpu/ops/pallas_lstm.py:494", launches=ec["lstm_sweep"],
             launches_xvector_path=xv["lstm_sweep"], launches_session_paths=on_session("lstm_sweep"),
             launches_pipeline_paths=on_pipeline("lstm_sweep"), launches_runtime_paths=on_runtime("lstm_sweep"),
             launches_family_paths=on_family("lstm_sweep"),
             **{k: lstm["bf16"][k] for k in KEYS},
             ms_b256=lstm["bf16"]["ms_b256"], ms_b528=lstm["bf16"]["ms_b528"],
             ms_f32=lstm["f32"]["ms"], plan=lstm["bf16"]["plan"], **with_grad("lstm_sweep")),
        dict(name="linear_stats", route="cuda", source="diart_tpu_torch/csrc/linear_stats.cu",
             replaces="diart_tpu/ops/pallas_stats.py:163", launches=xv["linear_stats"],
             launches_session_paths=on_session("linear_stats"),
             launches_pipeline_paths=on_pipeline("linear_stats"), launches_runtime_paths=on_runtime("linear_stats"),
             launches_family_paths=on_family("linear_stats"),
             at_xvect_sb=dict(at_shape(families["kernels"]["linear_stats_xvect_sb"]),
                              ms_f32=families["kernels"]["linear_stats_xvect_sb"]["f32"]["ms"]),
             **{k: stats["bf16"][k] for k in KEYS + STATS_KEYS}, ms_f32=stats["f32"]["ms"],
             **with_grad("linear_stats")),
        dict(name="attn_stats", route="cuda", source="diart_tpu_torch/csrc/attn_stats.cu",
             replaces="diart_tpu/ops/pallas_attn_stats.py:170", launches=ec["attn_stats"],
             launches_session_paths=on_session("attn_stats"),
             launches_pipeline_paths=on_pipeline("attn_stats"), launches_runtime_paths=on_runtime("attn_stats"),
             launches_family_paths=on_family("attn_stats"),
             at_titanet=dict(at_shape(families["kernels"]["attn_stats_titanet"]),
                             ms_f32=families["kernels"]["attn_stats_titanet"]["f32"]["ms"]),
             **{k: attn["bf16"][k] for k in KEYS + STATS_KEYS}, ms_f32=attn["f32"]["ms"],
             **with_grad("attn_stats")),
        dict(name="se_res2", route="cuda", source="diart_tpu_torch/csrc/se_res2.cu",
             replaces="diart_tpu/ops/pallas_res2.py:294", launches=ec["se_res2"],
             launches_session_paths=on_session("se_res2"),
             launches_pipeline_paths=on_pipeline("se_res2"), launches_runtime_paths=on_runtime("se_res2"),
             launches_family_paths=on_family("se_res2"),
             **{k: res2["bf16"][k] for k in KEYS}, ms_b8=res2["bf16"]["ms_b8"],
             device_ms=res2["bf16"]["device_ms"],
             ms_f32=res2["f32"]["ms"], by_launch=res2["bf16"]["by_launch"], **with_grad("se_res2"),
             stage_mode=dict(res2["bf16"]["stage"], entry="se_res2_staged",
                             replaces=["scripts/res2_stage_debug.py:141",
                                       "scripts/res2_stage_debug.py:49",
                                       "scripts/res2_fix_experiments.py:126"],
                             launches=ec["se_res2_staged"],
                             stages_checked=sum(res2[k]["stage"]["stages_checked"] for k in res2),
                             max_abs_err=max(res2[k]["stage"]["max_abs_err"] for k in res2),
                             library_ms=None)),
    ]
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(result, engines=runs, probes=probes, sessions=sessions, pipelines=pipelines,
                           pipelines_vs_cpu=pipe_cpu, session_tensor_blocks=session_tensors, runtime=runtime,
                           families=families, training=training,
                           kernels=kernels), f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s after start-up")
    log(f"gpu: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
