"""Host-side utilities of the port: preemption and run summaries."""
