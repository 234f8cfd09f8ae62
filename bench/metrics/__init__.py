"""One reader a metric, found by the metric's name in BENCHMARK.json.

``roofline.cold`` is read by ``bench/metrics/roofline.py``: the part of
the name after the first dot says which end-to-end metric the reading
moves, not how it is read.  A reader is ``read(run) -> float | None``; None (nothing to
read) leaves the metric out of the run's line.  ``run`` is the harness's
record of the run (``bench/harness.py: Run``).
"""
