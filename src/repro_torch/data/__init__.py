"""The deterministic data pipeline; a copy of `repro.data`."""
