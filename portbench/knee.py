"""The knee of an open-loop cell: the most cohorts the card serves in real
time, found once by a sweep on the card.

    python3 -m portbench.knee --workload xvector.realtime --seed <n> --cohorts 8 12 16 ... [--seconds 10]

One process builds the cell's engine once; for each K, upward, it primes K
fresh sessions and runs the real-time schedule for ``--seconds``. A K is
sustained when no hop replies later than one step period (500 ms) and the
dispatch lateness does not grow over the window (the mean of its last
third no more than 5 ms above the mean of its first third). The knee is the
highest sustained K below the first that is not; the cell runs at 4/5 of
it (``cohorts`` in its traffic file). Each K's readings go to
``portbench/knee.json``, or ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def sweep_one(engine, audio, traffic, hyper, cohorts: int, seconds: float) -> dict:
    from diart_tpu_torch.parallel.cohort import CohortScheduler

    from .drive import Capture, Session, open_loop, prime

    scheduler = CohortScheduler(engine, cohorts, tau_active=hyper["tau_active"], binarize_on_device=True)
    capture = Capture([], engine.device)
    sessions = [Session(s, j, capture, False) for j, s in enumerate(scheduler.sessions)]
    hop = 0
    for j, s in enumerate(sessions):
        hop = prime(s, audio, j, s.session.warmup_blocks + int(traffic["settle_hops"]))
    periods = int(round(seconds / hyper["step"]))
    out = open_loop(scheduler, sessions, audio, hop, periods, False, int(traffic["max_inflight"]))
    t = out["timings"]
    reply = np.asarray([(x.done - x.due) * 1e3 for x in t])
    late = np.asarray([(x.dispatched - x.due) * 1e3 for x in t])
    third = max(1, len(late) // 3)
    growth = float(late[-third:].mean() - late[:third].mean())
    return dict(cohorts=cohorts, streams=cohorts * engine.batch_size, hops=len(t), periods=periods,
                reply_p50_ms=float(np.percentile(reply, 50)), reply_p95_ms=float(np.percentile(reply, 95)),
                reply_max_ms=float(reply.max()), late_hops=int((reply > hyper["step"] * 1e3).sum()),
                dispatch_late_p95_ms=float(np.percentile(late, 95)), lateness_growth_ms=growth,
                sustained=bool(reply.max() <= hyper["step"] * 1e3 and growth <= 5.0 and len(t) == cohorts * periods))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cohorts", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=str(Path(__file__).resolve().parent / "knee.json"))
    args = p.parse_args(argv)
    from .cell import StreamAudio, build_engine, make_all_weights, make_pool, resolve, scrub_policy_variables

    cell, config, traffic = resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    scrub_policy_variables()
    hyper, batch = config["engine"], int(traffic["batch"])
    weights = make_all_weights(config, args.seed, "cuda")
    audio = StreamAudio(make_pool(traffic, int(traffic["pool_streams"]), args.seed, "cuda"), batch,
                        int(traffic["cohort_offset"]), int(traffic["time_offset"]))
    engine = build_engine(config, weights, batch, "cuda")
    rows, knee = [], None
    for k in sorted(args.cohorts):
        t0 = time.perf_counter()
        row = sweep_one(engine, audio, traffic, hyper, k, args.seconds)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not row["sustained"]:
            break
        knee = k
    smi = torch.cuda.get_device_name(0)
    record = dict(workload=cell["name"], seed=args.seed, seconds=args.seconds, device=smi, knee=knee,
                  cell_cohorts=None if knee is None else max(1, int(knee * 4 // 5)), readings=rows)
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps({k: v for k, v in record.items() if k != "readings"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
