"""One reader a metric, found by the metric's name in `BENCHMARK.json`:
``<name>.py`` defines ``read(window)`` (a `cofbench.window.Window`), which
returns the metric's value, or None where the run holds nothing to read."""
