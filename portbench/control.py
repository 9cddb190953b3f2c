"""The control of the check that decides ``correct``: the plain reference put
in the port's place and computed one precision step below what the
configuration states (``Numerics(lower=True)``: float32 parts in bfloat16,
bfloat16 parts in fp8), with its own clustering (``reference.online
.Clustering``), judged exactly as a run judges the port. It has to come out
not correct; its numbers are the upper readings the limits are set under.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...] [--chunks C]

runs it on the card at the cell's own size: the cell's sampled streams,
``C`` chunks each (as many as a run of ``run_seconds`` judges). No window
is served: the control's outputs do not depend on time. The port is not
imported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def control_numbers(cell, config, traffic, seed: int, chunks: int, device: str = "cuda") -> dict:
    """The control's numbers for one seed, and the reference's own (which
    read 0, a check of the judge)."""
    from .cell import StreamAudio, make_all_weights, make_pool
    from .reference.common import Numerics
    from .reference.online import Clustering, Geometry, permute, render_rttm
    from .run import judge_streams, reference_windows, sample_streams

    hyper = config["engine"]
    batch = int(traffic["batch"])
    cohorts = int(traffic.get("cohorts", 1)) if traffic["mode"] == "open" else 1
    weights = make_all_weights(config, seed, device)
    pool = make_pool(traffic, int(traffic["pool_streams"]), seed, device)
    audio = StreamAudio(pool, batch, int(traffic.get("cohort_offset", 0)), int(traffic.get("time_offset", 0)))
    sample = sample_streams(np.random.default_rng(seed), cohorts, batch, int(traffic["checked_streams"]))
    warmup = int(round(hyper["duration"] / hyper["step"]))
    per = {s: list(range(chunks)) for s in sample}
    out = {}
    for name, lower in (("control", True), ("reference", False)):
        num = Numerics(config["precision_of_parts"], lower=lower)
        seg, emb, index = reference_windows(config, weights, audio, sample, per, warmup, device, num)
        geometry = Geometry(hyper["duration"], hyper["step"], hyper["latency"], seg.shape[1])
        served, state = {}, {}
        for (j, i) in sample:
            clus = Clustering(hyper["max_speakers"], hyper["tau_active"], hyper["rho_update"], hyper["delta_new"])
            for c in range(chunks):
                w = index[(audio.key(j, i), (c + warmup - 1) % audio.pool.shape[0])]
                glob = permute(seg[w], clus.step(seg[w], emb[w]), hyper["max_speakers"])
                rows = geometry.first if c == 0 else geometry.focus
                res = geometry.first_resolution if c == 0 else geometry.out_resolution
                text = render_rttm(glob[rows] > hyper["tau_active"], f"c{j}s{i}", geometry.window_start(c), res)
                served[(j, i, c)] = (glob[geometry.focus].astype(np.float32), text)
            state[(j, i)] = (clus.centers.astype(np.float32), clus.active.copy())
        if lower:
            judged_by = reference_windows(config, weights, audio, sample, per, warmup, device,
                                          Numerics(config["precision_of_parts"]))
        else:
            judged_by = (seg, emb, index)
        numbers, judged = judge_streams(config, audio, sample, per, warmup, *judged_by,
                                        lambda j, i, c: served[(j, i, c)], state)
        out[name] = dict(numbers, hops_judged=judged)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--chunks", type=int, default=64)
    args = p.parse_args(argv)
    from .cell import resolve

    cell, config, traffic = resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = control_numbers(cell, config, traffic, seed, args.chunks)
        print(json.dumps(dict(workload=cell["name"], seed=seed, limits=config["limits"],
                              seconds=time.perf_counter() - t0, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
