"""Launch helpers; mirrors `repro.launch` (this slice: real batches)."""
