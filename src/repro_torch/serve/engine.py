"""Batched serving engine in PyTorch; a port of `repro/serve/engine.py`.

Continuous-batching decode over a fixed slot pool: requests are admitted
FIFO into free slots, prefilled token by token through `decode_step`,
then decoded greedily until EOS, max_new_tokens or max_seq.  As in the
reference, one cache position is shared by all slots, so a request's
tokens depend on what ran before it.  Weight refresh polls a checkpoint
store with timeline (non-consistent) reads and swaps params between
batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..checkpoint import CheckpointError
from ..convert import to_tensor
from ..device import resolve
from ..models import decode_step, init_cache
from ..models.config import ModelConfig
from ..obs import spans
from ..tree import tree_leaves_with_path, tree_unflatten


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    output: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeConfig:
    slots: int = 4
    max_seq: int = 256
    eos_id: int = 1
    greedy: bool = True
    refresh_every_batches: int = 0     # 0 = no weight refresh polling


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 store=None, run_id: str = "run0", device="cuda"):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.store = store
        self.run_id = run_id
        self.device = resolve(device)
        self.cache = init_cache(cfg, scfg.slots, scfg.max_seq,
                                device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * scfg.slots
        self.slot_pos = np.zeros(scfg.slots, np.int32)   # per-slot progress
        self.queue: list[Request] = []
        self.finished: dict[int, Request] = {}
        self.batches_run = 0
        self.weights_step = -1

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.scfg.slots):
            if self.slot_req[i] is None and self.queue:
                self.slot_req[i] = self.queue.pop(0)
                self.slot_pos[i] = 0

    # -- decode loop ----------------------------------------------------------
    def _gather_tokens(self) -> torch.Tensor:
        """Next input token per slot: prompt token (prefill phase) or the
        last generated token (decode phase); idle slots feed EOS."""
        toks = np.full((self.scfg.slots, 1), self.scfg.eos_id, np.int64)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            p = int(self.slot_pos[i])
            if p < len(req.prompt):
                toks[i, 0] = req.prompt[p]
            elif req.output:
                toks[i, 0] = req.output[-1]
        return torch.from_numpy(toks).to(self.device)

    @spans.traced("engine.step")
    def step_batch(self) -> int:
        """One lockstep decode step across all slots.  Returns #active.

        Traced (`obs.spans`) as `engine.step` around `model.decode_step`
        and `engine.sync` (the argmax and its copy to the host, which
        drains the stream); counted as `engine.steps`, `engine.slot_steps`
        (occupied slots) and `engine.prompt_slot_steps` (slots fed a
        prompt token)."""
        self._admit()
        active = sum(r is not None for r in self.slot_req)
        if active == 0:
            return 0
        if spans.ON:
            spans.add("engine.steps", 1)
            spans.add("engine.slot_steps", active)
            spans.add("engine.prompt_slot_steps", sum(
                int(self.slot_pos[i]) < len(r.prompt)
                for i, r in enumerate(self.slot_req) if r is not None))
        logits, self.cache = decode_step(self.params, self.cache,
                                         self._gather_tokens(), self.cfg)
        with spans.span("engine.sync"):
            # first index among ties, as jnp.argmax
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_pos[i] += 1
            p = int(self.slot_pos[i])
            if p < len(req.prompt):
                continue                      # still prefilling
            tok = int(nxt[i])
            req.output.append(tok)
            if (tok == self.scfg.eos_id
                    or len(req.output) >= req.max_new_tokens
                    or p + 1 >= self.scfg.max_seq):
                req.done = True
                self.finished[req.rid] = req
                self.slot_req[i] = None
        self.batches_run += 1
        if (self.scfg.refresh_every_batches
                and self.batches_run % self.scfg.refresh_every_batches == 0):
            self.maybe_refresh_weights()
        return active

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                return
            self.step_batch()
        raise RuntimeError("serving did not drain")

    # -- timeline weight refresh ----------------------------------------------
    def maybe_refresh_weights(self) -> bool:
        """Poll the store's manifest with a timeline read and swap in a newer
        checkpoint.  A timeline read may race a commit or hit a stale
        replica; that round is skipped."""
        if self.store is None:
            return False
        try:
            step = self.store.latest_step(self.run_id, consistent=False)
            if step is None or step <= self.weights_step:
                return False
            _, flat = self.store.restore(run_id=self.run_id,
                                         consistent=False)
        except CheckpointError:
            return False
        self.params = _unflatten_like(self.params, flat)
        self.weights_step = step
        return True


def _unflatten_like(tree, flat: dict):
    """`tree` with each leaf named in `flat` ("/"-joined dict keys, the
    checkpoint store's names) replaced by that tensor (as the port's store
    restores it) or numpy array, cast to the leaf's dtype and device;
    leaves `flat` lacks are kept."""
    leaves = []
    for name, node in tree_leaves_with_path(tree):
        arr = flat.get(name)
        if arr is None:
            leaves.append(node)
        elif isinstance(arr, torch.Tensor):
            leaves.append(arr.to(device=node.device, dtype=node.dtype))
        else:
            leaves.append(to_tensor(arr, node.device, node.dtype))
    return tree_unflatten(tree, leaves)
