"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up makes the weights and the audio from
the seed on the card, builds the port's engine (``diart_tpu_torch``) with
the configuration's explicit precision policy, builds or loads the CUDA
kernels (``build/kernels/`` inside the checkout), warms every route the
cell's traffic takes and primes every stream past its warm-up. The window
then serves the cell's traffic for ``--seconds``. With ``--trace 0`` the
line carries the cell's end-to-end metrics; with ``--trace 1`` a profiled
window (``traffic["trace_seconds"]`` long) gives its per-layer metrics and
the breakdown. Once the window has closed, the port's engine is freed and
the plain reference (``portbench/reference``) judges what the window
produced for a sample of streams (``portbench/judge.py``); each number
compared is printed beside its limit, as the last lines on standard error
and under ``check``, the line's last key.

The last line on standard output is the result's JSON object and nothing
else. With no CUDA card, too few cards, no port to import, or JAX or the
JAX package loaded by the port, the run prints no result and exits with a
code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import statistics  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "diart_tpu")
HERE = Path(__file__).resolve().parent


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run must not load, compared
    whole (``diart_tpu_torch`` is not ``diart_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def sample_streams(rng: np.random.Generator, cohorts: int, batch: int, count: int):
    """``count`` (cohort, stream) pairs drawn from the seed, the first stream
    and the last of the whole batch among them."""
    total = cohorts * batch
    picks = set(rng.choice(total, size=min(count, total), replace=False).tolist()) | {0, total - 1}
    return sorted((p // batch, p % batch) for p in picks)


def log_window(out: dict, sessions, pauses: list, mode: str) -> None:
    """What the window looked like on the host, to standard error: hops,
    the dispatch's median, the collector's pauses and, in the open loop, the
    reply's percentiles and each second's worst reply."""
    gen2 = [(b[2] - a[2]) * 1e3 for a, b in zip(pauses[0::2], pauses[1::2]) if a[1] == 2]
    log(f"window: {out['hops']} hops in {out['window_s']:.3f} s; dispatch ms median "
        f"{statistics.median(x for s in sessions for x in s.dispatch_ms):.3f}; "
        f"collections {len(pauses) // 2}, gen 2: {len(gen2)} taking {sum(gen2):.1f} ms")
    if mode != "open":
        return
    from . import e2e

    reply = e2e.reply_ms(out["timings"])
    t0 = min(x.due for x in out["timings"])
    worst = {}
    for x, r in zip(out["timings"], reply):
        worst[int(x.due - t0)] = max(worst.get(int(x.due - t0), 0.0), r)
    log("reply ms p50 / p95 / p99 / max: " + " / ".join(f"{v:.3f}" for v in np.percentile(reply, [50, 95, 99, 100]))
        + f"; over 100 ms: {int((reply > 100).sum())}; the worst a second: "
        + " ".join(f"{worst[k]:.0f}" for k in sorted(worst)))


def run_cell(cell: dict, config: dict, traffic: dict, bench: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", fault=None) -> dict:
    """One run of a cell; returns the result object. ``fault(engine)``, for
    the tests, breaks the engine's step before set-up."""
    import torch

    from . import drive, e2e, judge, trace as tracing
    from .cell import StreamAudio, build_engine, make_all_weights, make_pool
    from .drive import Capture, Session, closed_loop, open_loop, prime
    from .work import hop_work

    cuda = device == "cuda"
    hyper, mode = config["engine"], traffic["mode"]
    batch = int(traffic["batch"])
    cohorts = int(traffic["cohorts"]) if mode == "open" else 1
    phases = [("imports", time.perf_counter())]
    weights = make_all_weights(config, seed, device)
    phases.append(("weights", time.perf_counter()))
    pool = make_pool(traffic, int(traffic["pool_streams"]), seed, device)
    phases.append(("audio", time.perf_counter()))
    audio = StreamAudio(pool, batch, int(traffic.get("cohort_offset", 0)), int(traffic.get("time_offset", 0)))
    sample = sample_streams(np.random.default_rng(seed), cohorts, batch, int(traffic["checked_streams"]))
    engine = build_engine(config, weights, batch, device)
    phases.append(("engine", time.perf_counter()))
    if fault is not None:
        fault(engine)
    capture = Capture(sample, device)
    settle = int(traffic["settle_hops"])
    from diart_tpu_torch import MultiStreamSession
    from diart_tpu_torch.parallel.cohort import CohortScheduler

    if mode == "closed":
        served = [MultiStreamSession(engine, uris=[f"c0s{i}" for i in range(batch)], tau_active=hyper["tau_active"],
                                     collect_audio=False, binarize_on_device=True)]
        served[0].warm()
    else:
        scheduler = CohortScheduler(engine, cohorts, tau_active=hyper["tau_active"], binarize_on_device=True)
        scheduler.warm()
        served = scheduler.sessions
    phases.append(("warm", time.perf_counter()))
    warmup = served[0].warmup_blocks
    sessions = [Session(s, j, capture, trace) for j, s in enumerate(served)]
    for j, s in enumerate(sessions):
        hop = prime(s, audio, j, warmup + settle)
    if cuda:
        torch.cuda.synchronize()
    # what set-up made lives as long as the run: the collector stops scanning
    # it, so a full collection in the window walks only the window's objects
    # (it took 125-300 ms over the whole heap, a stall of every cohort)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    phases.append(("prime", time.perf_counter()))
    log("set-up s by phase: " + ", ".join(f"{name} {t - prev:.2f}" for (name, t), (_, prev)
                                           in zip(phases, [("start", T_START)] + phases[:-1])))
    window_seconds = min(seconds, float(traffic["trace_seconds"])) if trace else seconds
    for s in sessions:
        s.dispatch_ms.clear()
    periods = max(1, int(round(window_seconds / hyper["step"])))
    drive.SPANS.clear()
    pauses = []  # the collector's pauses in the window, a diagnostic
    gc_timer = lambda phase, info: pauses.append((phase, info["generation"], time.perf_counter()))
    gc.callbacks.append(gc_timer)
    with tracing.profiled(trace, device) as prof:
        if mode == "closed":
            out = closed_loop(sessions[0], audio, hop, window_seconds)
        else:
            out = open_loop(scheduler, sessions, audio, hop, periods, trace, int(traffic["max_inflight"]))
        if cuda:
            torch.cuda.synchronize()
    gc.callbacks.remove(gc_timer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log_window(out, sessions, pauses, mode)

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    name_of = torch.cuda.get_device_name(0) if cuda else "cpu"
    result["device"] = {"platform": "gpu" if cuda else "cpu", "kind": name_of, "count": 1,
                        "memory_peak_bytes": int(peak)}
    late = 0
    if mode == "closed":
        result["attempted"] = out["hops"] * batch
    else:
        # a hop that never replied, or replied later than a step period, misses
        # every stream's limit
        due = cohorts * periods
        late = (e2e.late_hops(out["timings"], hyper["step"]) + due - len(out["timings"])) * batch
        result["attempted"] = due * batch
    result["failed"] = out["missing"] + late

    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == "streams_per_card":
                value = e2e.streams_per_card(batch, hyper["step"], out["hops"], out["window_s"])
            elif m["name"] == "reply_p50_ms":
                value = e2e.reply_p50_ms(out["timings"])
            else:
                raise KeyError(f"no measure of the end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        dev_ops, spans = tracing.events(prof, list(drive.SPANS))
        window = tracing.window_of(spans)
        busy_us, gaps = tracing.busy_and_gaps(dev_ops, spans, window)
        flops, kernels = hop_work(config, batch)
        r = types.SimpleNamespace(
            cell=cell, config=config, traffic=traffic, batch=batch, hops=out["hops"],
            window=window, window_s=(window[1] - window[0]) * 1e-6, busy_s=busy_us * 1e-6,
            device=dev_ops, spans=spans, gaps=gaps, flops=flops, kernels=kernels,
            dispatch_ms=[x for s in sessions for x in s.dispatch_ms], timings=out.get("timings"))
        for m in bench["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = metric_reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=r.busy_s, window_s=r.window_s)
        result["breakdown"] = tracing.breakdown(dev_ops, gaps, window)
        log("device summary:", json.dumps(tracing.device_summary(dev_ops, window, max(out["hops"], 1))))
        del prof
    result["metrics"] = metrics

    # the check, once the window has closed and the port's state is freed
    t_check = time.perf_counter()
    produced = capture.host()
    texts = dict(capture.texts)
    state = {(j, i): (served[j].state.centers[i].float().cpu().numpy(), served[j].state.center_active[i].cpu().numpy())
             for (j, i) in sample}
    del sessions, served, engine, capture
    if mode == "open":
        del scheduler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, judged, expected = check(config, weights, audio, sample, produced, texts, state, warmup, device)
    limits = config["limits"]
    result["correct"] = judge.verdict(numbers, limits) and judged == expected > 0
    result["check"] = dict(judge.report(numbers, limits), hops_judged={"value": judged, "limit": expected})
    log(f"check: {judged} stream-hops judged in {time.perf_counter() - t_check:.1f} s")
    for k, v in result["check"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    return result


def reference_windows(config, weights, audio, sample, chunks, warmup, device, num):
    """The reference's segmentation and embeddings of every distinct window
    the sampled streams heard at the given chunks: (seg, emb, index of
    (stream key, pool block) -> row). Hop h reads the stream's pool blocks
    h - 9 .. h, so a stream has as many distinct windows as the pool has
    blocks."""
    import torch

    from . import reference

    hyper = config["engine"]
    hops_window = int(round(hyper["duration"] / hyper["step"]))
    keys, index = [], {}
    for (j, i) in sample:
        for c in chunks[(j, i)]:
            hop = c + warmup - 1
            key = (audio.key(j, i), hop % audio.pool.shape[0])
            if key not in index:
                index[key] = len(keys)
                keys.append((audio.key(j, i), hop))
    waves = np.stack([audio.window(k, hop, hops_window) for k, hop in keys]).astype(np.float32) / 32768.0
    seg, emb = reference.frame_scores(config, weights["segmentation"], weights["embedding"],
                                      torch.from_numpy(waves).to(device), num)
    return seg, emb, index


def judge_streams(config, audio, sample, chunks, warmup, seg, emb, index, served, state):
    """Judge every chunk of the sampled streams; ``served(j, i, c)`` gives
    what was served, (aggregated scores, text), and ``state[(j, i)]`` the
    served clustering state once the window has closed, (centroid sums, in
    use). Returns (numbers, judged)."""
    from . import judge
    from .reference.online import Geometry

    hyper = config["engine"]
    geometry = Geometry(hyper["duration"], hyper["step"], hyper["latency"], seg.shape[1])
    judges, judged = [], 0
    for (j, i) in sample:
        sj = judge.StreamJudge(f"c{j}s{i}", geometry, hyper["max_speakers"], hyper)
        for c in chunks[(j, i)]:
            w = index[(audio.key(j, i), (c + warmup - 1) % audio.pool.shape[0])]
            agg, text = served(j, i, c)
            sj.hop(c, agg, text, seg[w], emb[w])
            judged += 1
        sj.final(*state[(j, i)])
        judges.append(sj)
    return judge.summary(judges), judged


def check(config, weights, audio, sample, produced, texts, state, warmup, device):
    """Judge every captured hop of the sampled streams against the plain
    reference: (numbers, stream-hops judged, stream-hops due)."""
    from .reference.common import Numerics

    chunks = {(j, i): sorted(c for (jj, c) in produced if jj == j) for (j, i) in sample}
    rows = {(j, i): [x for x in sample if x[0] == j].index((j, i)) for (j, i) in sample}
    seg, emb, index = reference_windows(config, weights, audio, sample, chunks, warmup, device,
                                        Numerics(config["precision_of_parts"]))
    numbers, judged = judge_streams(config, audio, sample, chunks, warmup, seg, emb, index,
                                    lambda j, i, c: (produced[(j, c)][rows[(j, i)]], texts.get((j, i, c))), state)
    return numbers, judged, sum(len(v) for v in chunks.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from .cell import resolve, load_benchmark, scrub_policy_variables

    cell, config, traffic = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    scrub_policy_variables()
    log(f"cell {cell['name']}: seed {args.seed}, {args.seconds} s, trace {args.trace}")
    result = run_cell(cell, config, traffic, load_benchmark(), args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"modules the run must not load are loaded: {found}")
        return 4
    check_entry = result.pop("check")
    result["check"] = check_entry
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
