"""Per-layer metrics, one reader a computation: the metric ``<name>`` of
BENCHMARK.json is read by ``<name>.py`` where that file is here, and else
by ``<stem>.py``, its name up to the first dot (``mfu.serve`` and
``mfu.lambdarank`` by ``mfu.py``). What a metric is (its source, layer,
unit and the end-to-end metric it moves) is said once, in BENCHMARK.json.

A reader has ``read(run) -> float | None``: ``run`` holds the cell's
``config`` and ``traffic``, ``spans`` (``core.Spans``), ``counters`` (work
done in the window), ``window_s`` and ``trace`` (``core.Trace`` of a traced
run, or None). A reader that finds nothing to read returns None, and the
metric is left out of the result.
"""
