"""Metric readers: ``<name>.py`` reads the metric ``name`` of BENCHMARK.json from a run."""
