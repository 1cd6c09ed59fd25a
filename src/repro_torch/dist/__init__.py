"""Distributed-training helpers; mirrors `repro.dist` (this slice:
gradient compression)."""
