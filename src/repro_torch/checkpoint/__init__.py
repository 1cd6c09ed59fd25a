"""Checkpoint interface of the port.  The Paxos-replicated store itself
(`repro/checkpoint/store.py` and the datastore under it) is copied in with
a later slice; until then the serving engine takes any object with the
store's `latest_step` / `restore` methods."""


class CheckpointError(Exception):
    """A checkpoint read or write that could not complete (the counterpart
    of `repro.checkpoint.store.CheckpointError`)."""
