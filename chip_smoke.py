#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive.

Run from the repository root with no arguments (``python3 chip_smoke.py``);
``--out DIR`` also writes the detailed results and a profile there.

Phases (any failure exits non-zero):

1. Build both hand-written kernels (``diart_tpu_torch/csrc/*.cu``, one
   ``nvcc`` each, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path with 64 streams: the LSTM sweep at T=293,
   H=128 (f32 and bf16 streams), the stats head at X (64, 279, 512)
   (bf16 and f32), W (512, 1500), 4 speakers. Print each error beside its
   tolerance and the kernel / plain / library times (CUDA events).
3. Drive the full-width engine (``tpu/pyannet`` 4x128 + ``tpu/xvector``
   512/1500 with a bf16 trunk, 20 global speakers, 5 s windows, 0.5 s
   hops) for 64 streams over 14 hops of int16 audio: warm-up, running
   hops, one paused stream, one slot reset. Check shapes, finiteness and
   that each kernel ran on every hop (launch counters set to 0 just before
   and read just after). Compare ``probe_frame_scores`` with the same
   engine on the CPU for 2 streams, and time the step.
4. Print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

The script imports only the port (never jax or diart_tpu) and exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # tensor-core bf16; f32 outside the tensor cores
T_LSTM, B, H = 293, 64, 128
T_EMB, C_IN, C_OUT, S = 279, 512, 1500, 4
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
def check_lstm(dtype, gen):
    import torch
    from diart_tpu_torch.ops import lstm_sweep

    dev = "cuda"
    proj = torch.randn(T_LSTM, 2, B, 4 * H, generator=gen).to(dev, dtype)
    q = torch.linalg.qr(torch.randn(2, 4 * H, H, generator=gen))[0]  # orthonormal columns
    w_hh = q.to(dev)
    got = lstm_sweep.lstm_sweep_tm(proj, w_hh)
    want = lstm_sweep.lstm_sweep_reference(proj, w_hh)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    kind = "f32" if dtype == torch.float32 else "bf16"
    ms = time_ms(lambda: lstm_sweep.lstm_sweep_tm(proj, w_hh), 20)
    plain_ms = time_ms(lambda: lstm_sweep.lstm_sweep_reference(proj, w_hh), 3, warmup=1)
    lib_ms, lib_note = None, ""
    try:
        # yardstick only: cuDNN's LSTM over the same (T, B) with the input
        # projection included (input width 2H, as layers 2-4 of PyanNet)
        lstm = torch.nn.LSTM(2 * H, H, bidirectional=True).to(dev, dtype)
        lstm.flatten_parameters()
        xin = torch.randn(T_LSTM, B, 2 * H, generator=gen).to(dev, dtype)
        with torch.no_grad():
            lib_ms = time_ms(lambda: lstm(xin), 20)
    except Exception as exc:
        lib_note = f" (cuDNN LSTM unavailable in {kind}: {type(exc).__name__})"
    elt = proj.element_size()
    nbytes = proj.numel() * elt + w_hh.numel() * 4 + got.numel() * elt
    flops = 2.0 * T_LSTM * 2 * B * 4 * H * H
    bms, by = bound_ms(nbytes, flops, kind)
    plan = lstm_sweep.launch_plan(B, H, dtype, proj.device)
    log(
        f"lstm_sweep[{kind}] T={T_LSTM} B={B} H={H}: max_abs_err={err:.3e} (tol {tol:.0e}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} cudnn_lstm_ms={lib_ms}{lib_note} "
        f"bound_ms={bms:.5f} ({by}) plan={plan}"
    )
    if not err <= tol:
        raise AssertionError(f"lstm_sweep[{kind}] disagrees with its plain version: {err} > {tol}")
    # the other batch tiles of the launch plan, on short sequences
    for batch in (3, 100, 200, 600):
        p = torch.randn(37, 2, batch, 4 * H, generator=gen).to(dev, dtype)
        e = (lstm_sweep.lstm_sweep_tm(p, w_hh).float()
             - lstm_sweep.lstm_sweep_reference(p, w_hh).float()).abs().max().item()
        log(f"  lstm_sweep[{kind}] T=37 B={batch} plan={lstm_sweep.launch_plan(batch, H, dtype, dev)}: "
            f"max_abs_err={e:.3e} (tol {tol:.0e})")
        if not e <= tol:
            raise AssertionError(f"lstm_sweep[{kind}] B={batch} disagrees with its plain version")
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, plan=plan)


def check_stats(dtype, gen):
    import torch
    from diart_tpu_torch.ops import linear_stats

    dev = "cuda"
    x = torch.randn(B, T_EMB, C_IN, generator=gen).to(dev, dtype)
    w = (torch.randn(C_IN, C_OUT, generator=gen) * C_IN**-0.5).to(dev)
    b = (torch.randn(C_OUT, generator=gen) * 0.1).to(dev)
    scale = (1.0 + 0.1 * torch.randn(C_OUT, generator=gen)).to(dev)
    shift = (0.1 * torch.randn(C_OUT, generator=gen)).to(dev)
    wt = torch.sigmoid(torch.randn(B, S, T_EMB, generator=gen)).to(dev)
    args = (x, w, b, scale, shift, wt)
    got = linear_stats.fused_linear_stats(*args)
    want = linear_stats.linear_stats_reference(*args)
    torch.cuda.synchronize()
    # both round W to X's dtype and multiply exactly in f32; only the order
    # of the f32 sums differs — relative to each output's scale
    err = max((g - r).abs().max().item() for g, r in zip(got, want))
    scale_ref = max(r.abs().max().item() for r in want)
    tol = 1e-5 * scale_ref
    kind = "f32" if dtype == torch.float32 else "bf16"
    ms = time_ms(lambda: linear_stats.fused_linear_stats(*args), 20)
    plain_ms = time_ms(lambda: linear_stats.linear_stats_reference(*args), 20)
    nbytes = x.numel() * x.element_size() + sum(t.numel() * 4 for t in (w, b, scale, shift, wt))
    nbytes += 2 * B * S * C_OUT * 4
    flops = 2.0 * B * T_EMB * C_IN * C_OUT + 6.0 * B * T_EMB * C_OUT + 4.0 * B * S * T_EMB * C_OUT
    bms, by = bound_ms(nbytes, flops, kind)
    log(
        f"linear_stats[{kind}] X=({B},{T_EMB},{C_IN}) W=({C_IN},{C_OUT}) S={S}: "
        f"max_abs_err={err:.3e} (tol {tol:.3e} = 1e-5 x max|ref| {scale_ref:.1f}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by}) "
        f"tensor_cores={linear_stats.uses_tensor_cores(C_IN, dtype)}"
    )
    if not err <= tol:
        raise AssertionError(f"linear_stats[{kind}] disagrees with its plain version: {err} > {tol}")
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


# --------------------------------------------------------------------- #
def make_audio(rng, hops, batch, step):
    """int16 PCM: noise bursts of per-stream loudness, so windows differ."""
    t = np.arange(hops * step) / 16000.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (0.2 + 0.05 * np.arange(batch))[:, None] * t[None, :])
    sig = rng.normal(size=(batch, hops * step)) * env * 4000
    pcm = np.clip(sig, -32768, 32767).astype(np.int16)
    return pcm.reshape(batch, hops, step).transpose(1, 0, 2).copy()  # (hops, B, step)


def build_engine(device, batch, seg_dtype="f32", emb_dtype="bf16", precision=None):
    from diart_tpu_torch import EmbeddingModel, MultiStreamEngine, SegmentationModel

    seg = SegmentationModel.from_registry("tpu/pyannet", device=device, seed=0, dtype=seg_dtype)
    emb = EmbeddingModel.from_registry("tpu/xvector", device=device, seed=1, dtype=emb_dtype)
    return MultiStreamEngine(
        seg, emb, duration=5.0, step=0.5, latency=0.5, sample_rate=16000,
        max_speakers=20, batch_size=batch, precision=precision,
    )


def drive_engine(out_dir):
    import torch
    from diart_tpu_torch.ops.linear_stats import fused_linear_stats
    from diart_tpu_torch.ops.lstm_sweep import lstm_sweep_tm

    engine = build_engine("cuda", B)
    rng = np.random.default_rng(0)
    audio = make_audio(rng, HOPS + 20, B, engine.step_samples)
    blocks = torch.from_numpy(audio).cuda()  # staged on the device, as a server would
    state = engine.init_state()
    paused, reset_slot = 3, 5

    lstm_sweep_tm.launches = 0
    fused_linear_stats.launches = 0
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
    launches = {"lstm_sweep": lstm_sweep_tm.launches, "linear_stats": fused_linear_stats.launches}
    log(f"engine: {HOPS} hops x {B} streams, launches {launches}")
    layers = engine._seg.module.lstm.num_layers
    if launches != {"lstm_sweep": layers * HOPS, "linear_stats": HOPS}:
        raise AssertionError(f"expected {layers} sweeps and 1 stats launch per hop; got {launches}")

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
    log(f"engine outputs ok: aggregated {tuple(last.aggregated.shape)}, chunk_index[0..6]="
        f"{idx[:7].tolist()}, mean active centres per stream {active:.2f}")

    # steady-state step time (all streams running), host clock + synchronize
    times = []
    for i in range(20):
        t0 = time.perf_counter()
        state, out = engine.step(state, blocks[HOPS + i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times[5:]))
    log(f"engine step at B={B}: median {step_ms:.3f} ms over {len(times) - 5} steps "
        f"(min {min(times[5:]):.3f}, max {max(times[5:]):.3f})")

    profile = None
    try:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(5):
                state, out = engine.step(state, blocks[HOPS + i])
            torch.cuda.synchronize()
        profile = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
        if out_dir:
            prof.export_chrome_trace(os.path.join(out_dir, "engine_step_trace.json"))
    except Exception as exc:  # diagnostic only
        log(f"profiler unavailable: {type(exc).__name__}: {exc}")
    return engine, audio, dict(launches=launches, step_ms=step_ms, step_ms_all=times,
                               active_centres=active), profile


def compare_cpu(audio):
    """probe_frame_scores of 2 streams on the card vs the same engine on the
    CPU (the kernels' plain versions), from the same full window."""
    import torch
    from diart_tpu_torch.precision import Precision

    results = {}
    window = audio[:10, :2].transpose(1, 0, 2).reshape(2, -1).astype(np.float32) / 32768.0
    nxt = audio[10, :2]
    cases = [
        # f32 everywhere: the kernels' f32 paths against plain f32 on the CPU
        ("f32", dict(seg_dtype="f32", emb_dtype="f32", precision=Precision.portable()), 1e-4, 1e-3),
        # the serving configuration: bf16 LSTM stream, bf16 pre-pool frontend
        # and bf16 embedding trunk on the card; the CPU runs f32 LSTM and
        # frontend (the bf16 switches are CUDA-only) with the bf16 trunk
        ("serving", dict(), 3e-2, 5e-2),
    ]
    for name, kw, seg_tol, emb_tol in cases:
        outs = []
        for device in ("cuda", "cpu"):
            engine = build_engine(device, 2, **kw)
            state = engine.init_state()._replace(audio=torch.from_numpy(window).to(engine.device))
            seg, emb = engine.probe_frame_scores(state, nxt)
            outs.append((seg.float().cpu(), emb.float().cpu()))
        (sg, eg), (sc, ec) = outs
        seg_err = (sg - sc).abs().max().item()
        emb_err = (eg - ec).abs().max().item()
        log(f"probe vs CPU [{name}]: seg {tuple(sg.shape)} max_abs_err={seg_err:.3e} (tol {seg_tol:.0e}), "
            f"emb {tuple(eg.shape)} max_abs_err={emb_err:.3e} (tol {emb_tol:.0e})")
        if not (torch.isfinite(sg).all() and torch.isfinite(eg).all()):
            raise AssertionError(f"probe [{name}] produced non-finite values")
        if not (seg_err <= seg_tol and emb_err <= emb_tol):
            raise AssertionError(f"probe [{name}] disagrees with the CPU engine")
        results[name] = dict(seg_err=seg_err, seg_tol=seg_tol, emb_err=emb_err, emb_tol=emb_tol)

    # whole steps, f32: clustering thresholds low enough that the random
    # models' ~0.5 activations map speakers, so assignment and centroid
    # updates run on the card; the aggregated scores must match the CPU's
    hops, tol = 12, 1e-3
    aggs, centres = [], []
    for device in ("cuda", "cpu"):
        engine = build_engine(device, 2, seg_dtype="f32", emb_dtype="f32",
                              precision=Precision.portable())
        engine.set_hyperparameters(tau_active=0.45, rho_update=0.05)
        state, seq = engine.init_state(), []
        for i in range(hops):
            state, out = engine.step(state, audio[i, :2], run_mask=np.full(2, i + 1 >= WARMUP_HOPS))
            seq.append(out.aggregated.cpu())
        aggs.append(torch.stack(seq))
        centres.append(state.center_active.sum().item())
    agg_err = (aggs[0] - aggs[1]).abs().max().item()
    log(f"steps vs CPU [f32, {hops} hops, 2 streams]: aggregated max_abs_err={agg_err:.3e} "
        f"(tol {tol:.0e}); active centres card/CPU {centres[0]}/{centres[1]}")
    if not (agg_err <= tol and centres[0] == centres[1] and centres[0] > 0):
        raise AssertionError("engine steps on the card disagree with the CPU engine")
    results["steps_f32"] = dict(agg_err=agg_err, tol=tol, active_centres=centres[0])
    return results


# --------------------------------------------------------------------- #
def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="directory for detailed results")
    args = parser.parse_args()

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

    t0 = time.perf_counter()
    logs = _build.build(force=True)
    log(f"built {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    lstm = {k: check_lstm(dt, gen) for k, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    stats = {k: check_stats(dt, gen) for k, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))}

    engine, audio, run, profile = drive_engine(args.out)
    if profile:
        log("profile of 5 engine steps (top kernels by CUDA time):")
        log(profile)
    probe = compare_cpu(audio)

    # the main path runs the bf16 LSTM stream and the bf16 embedding trunk
    kernels = [
        dict(name="lstm_sweep", route="cuda", source="diart_tpu_torch/csrc/lstm_sweep.cu",
             replaces="diart_tpu/ops/pallas_lstm.py:494", launches=run["launches"]["lstm_sweep"],
             **{k: lstm["bf16"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}),
        dict(name="linear_stats", route="cuda", source="diart_tpu_torch/csrc/linear_stats.cu",
             replaces="diart_tpu/ops/pallas_stats.py:163", launches=run["launches"]["linear_stats"],
             **{k: stats["bf16"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}),
    ]
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(gpu=smi, lstm=lstm, stats=stats, engine=run, probe=probe,
                           kernels=kernels), f, indent=1)
        if profile:
            with open(os.path.join(args.out, "engine_step_profile.txt"), "w") as f:
                f.write(profile)
    log(f"gpu: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
