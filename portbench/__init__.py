"""The benchmark of the PyTorch/CUDA port (``diart_tpu_torch``), driven by
``BENCHMARK.json`` at the repository's root.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench.control --workload <cell> --seeds <n> ...   # the check's control
    python3 -m portbench.knee --workload <cell> --seed <n> --cohorts K ...   # an open loop's knee
    python -m pytest portbench/tests [-m card]

Layout: ``configs/<config>.json`` (a model configuration, its precision and
its check's limits), ``traffic/<traffic>.json`` (a traffic mix, read by
``drive.py``), ``metrics/<metric>.py`` (one reader a per-layer metric),
``work/`` (operations and bytes from shapes, the peaks), ``reference/``
(the plain reference), ``judge.py`` (the comparison that decides
``correct``), ``trace.py`` (the profiler's readings), ``cell.py`` (a
cell's files, weights and audio from the seed, the port's engine).
Nothing here imports JAX or the JAX package; the reference, the judge,
the work counters and the metric readers import nothing of the port.
"""
