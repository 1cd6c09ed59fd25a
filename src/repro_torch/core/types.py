"""Core datatypes: LSNs, log records, cells, API results.

LSNs are 64-bit integers with the *epoch* in the high bits and a sequence
number in the low bits (paper App. B: "the high order bits of the LSN are
used to store the epoch number").  LSNs double as Paxos proposal numbers;
the epoch is bumped in the coordination service on every leader takeover,
which guarantees new writes order after everything from prior regimes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

SEQ_BITS = 40
SEQ_MASK = (1 << SEQ_BITS) - 1


def make_lsn(epoch: int, seq: int) -> int:
    if seq > SEQ_MASK:
        raise ValueError("sequence number overflow")
    return (epoch << SEQ_BITS) | seq


def lsn_epoch(lsn: int) -> int:
    return lsn >> SEQ_BITS


def lsn_seq(lsn: int) -> int:
    return lsn & SEQ_MASK


def fmt_lsn(lsn: int) -> str:
    return f"{lsn_epoch(lsn)}.{lsn_seq(lsn)}"


class OpType(enum.Enum):
    PUT = "put"
    DELETE = "delete"
    COND_PUT = "cond_put"
    COND_DELETE = "cond_delete"
    # multi-column variant of put (§3: "multi-column versions of its API")
    MULTI_PUT = "multi_put"
    # range-management records (core/ranges.py): replicated through the
    # normal Paxos pipeline so every replica changes ranges at the same
    # log position.  They never touch the memtable (Store.apply ignores
    # them); CohortReplica._apply_committed intercepts them instead.
    SPLIT = "split"                  # key = split point; columns carry child rid
    MEMBER_CHANGE = "member_change"  # columns carry the new member tuple
    # cross-range 2PC records (core/txn.py): every transaction state
    # transition is made durable through the same pipeline.  PREPARE
    # stages the participant's writes + locks; COMMIT/ABORT resolve them;
    # DECISION is the coordinator's logged commit point.  Like range ops
    # they bypass the memtable and are intercepted on apply.
    TXN_PREPARE = "txn_prepare"      # key = txid; `txn` carries staged writes
    TXN_COMMIT = "txn_commit"        # key = txid
    TXN_ABORT = "txn_abort"          # key = txid
    TXN_DECISION = "txn_decision"    # key = txid; coordinator-side record

RANGE_OPS = (OpType.SPLIT, OpType.MEMBER_CHANGE)
TXN_OPS = (OpType.TXN_PREPARE, OpType.TXN_COMMIT, OpType.TXN_ABORT,
           OpType.TXN_DECISION)
# ops intercepted by the replica instead of applied to the memtable
CONTROL_OPS = RANGE_OPS + TXN_OPS


@dataclass(frozen=True)
class WriteOp:
    """A client write request (pre-LSN-assignment)."""
    op: OpType
    key: str
    colname: str = ""
    value: Any = None
    expected_version: Optional[int] = None       # for conditional ops
    columns: Optional[tuple[tuple[str, Any], ...]] = None  # for MULTI_PUT

    @property
    def is_conditional(self) -> bool:
        return self.op in (OpType.COND_PUT, OpType.COND_DELETE)


@dataclass
class LogRecord:
    """A replicated log record.  `versions` are assigned by the leader at
    propose time so every replica applies identical state.  `txn_tail`
    (§8.2 multi-op transactions) marks the LSN of the batch's last record:
    replicas apply a batch only once its tail is committed."""
    range_id: int
    lsn: int
    op: OpType
    key: str
    columns: tuple[tuple[str, Any, int], ...]  # (colname, value, version); value None => tombstone
    txn_tail: int = 0
    # 2PC payload (core/txn.py): TXN_PREPARE carries
    # (txid, coord_rid, staged) where staged = ((key, cols), ...);
    # TXN_COMMIT/TXN_ABORT carry (txid,); TXN_DECISION carries
    # (txid, outcome, participant_rids)
    txn: Any = None

    def nbytes(self) -> int:
        n = 64
        for c, v, _ in self.columns:
            n += len(c) + (len(v) if isinstance(v, (bytes, str)) else 16)
        if self.op is OpType.TXN_PREPARE and self.txn is not None:
            n += 48
            for key, cols in self.txn[2]:
                n += len(key) + sum(
                    len(c) + (len(v) if isinstance(v, (bytes, str)) else 16)
                    for c, v, _ in cols)
        elif self.txn is not None:
            n += 48
        return n


@dataclass
class CommitMarker:
    """Non-forced log record persisting a replica's last-committed LSN."""
    range_id: int
    commit_lsn: int


@dataclass(frozen=True)
class Cell:
    """A (value, version) pair stored under (key, colname)."""
    value: Any
    version: int
    lsn: int
    deleted: bool = False


class ErrorCode(enum.Enum):
    OK = "ok"
    NOT_LEADER = "not_leader"
    UNAVAILABLE = "unavailable"
    VERSION_MISMATCH = "version_mismatch"
    NOT_FOUND = "not_found"
    TIMEOUT = "timeout"
    # the key no longer belongs to the range the client addressed (it
    # moved to a child range, or the replica's range narrowed after a
    # split); the client must refresh its cached range table and re-route
    WRONG_RANGE = "wrong_range"
    # the key is locked by an in-flight cross-range transaction (no-wait
    # deadlock avoidance, core/txn.py): retryable — the lock clears as
    # soon as the owning transaction resolves
    LOCKED = "locked"
    # admission control (core/node.py): the node's CPU backlog is past its
    # configured limit and the request was shed before queuing; retryable
    # after backoff — by then the queue has drained or the client's load
    # has spread to other cohorts
    OVERLOADED = "overloaded"


@dataclass
class Result:
    code: ErrorCode
    value: Any = None
    version: Optional[int] = None
    leader_hint: Optional[int] = None
    latency: float = 0.0
    # attempts the client spent on this op (retries + 1); a write with
    # attempts > 1 may have committed more than once (a retry after a lost
    # ack re-executes), which the linearizability auditor accounts for
    attempts: int = 1

    @property
    def ok(self) -> bool:
        return self.code == ErrorCode.OK


@dataclass(frozen=True)
class KeyRange:
    """[lo, hi) over the key space; range_id indexes the cohort."""
    range_id: int
    lo: str
    hi: str          # exclusive; "" means +inf (wraparound tail range)

    def contains(self, key: str) -> bool:
        if self.hi == "":
            return key >= self.lo
        return self.lo <= key < self.hi
