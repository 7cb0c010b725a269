"""Per-layer metric readers: `metrics/<name>.py` holds `read(summary)`,
which returns the metric from the traced run's summary (`benchmark/trace.py`
plus what the loop adds), or None where the trace holds nothing to read."""
