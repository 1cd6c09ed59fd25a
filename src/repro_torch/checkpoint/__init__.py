"""The Paxos-replicated checkpoint store (`store.py`, the reference's
store with its pytree half over torch tensors)."""

from .store import (CheckpointError, SpinnakerCheckpointStore,
                    StaleTrainerError, StoreConfig)

__all__ = ["CheckpointError", "SpinnakerCheckpointStore",
           "StaleTrainerError", "StoreConfig"]
