"""Fault tolerance of the training fleet: host sessions, generation
fencing and elastic re-meshing (`manager.py`, a copy of the
reference's)."""
