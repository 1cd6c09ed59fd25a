"""One reader per per-layer metric, `<metric>.py`, found by the metric's
name: `read(records) -> float`, raising `harness.Missing` when the run
holds nothing for it to read (never 0 for "not found")."""
