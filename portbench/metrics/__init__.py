"""One reader a per-layer metric: ``metrics/<metric name>.py`` holds
``read(r)``, which takes the traced run's readings (``portbench.run``
``Readings``) and returns the metric's value, or None where it finds
nothing to read (the harness then leaves the metric out of the line)."""
