"""The serving engine's stated scheduling, replayed from its requests and
the tokens it served, so that the reference sees what each slot saw.

The engine has a fixed pool of slots and one cache position shared by
all of them: at every step each slot is fed one token at that position,
a prompt token while its request is prefilling, then the request's last
served token; an empty slot is fed the end-of-sequence id.  Requests are
admitted first in, first out into the free slots, in slot order, at the
start of a step.  The step that feeds a request's last prompt token
serves its first token; a request ends when it serves the
end-of-sequence id, `max_new_tokens` tokens, or reaches `max_seq`, and
its slot is free from the next step.  So a slot's stream, from the
engine's first step, holds the requests it served one after another,
and its K/V rows and recurrent state carry all of them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Replay:
    tokens: np.ndarray          # (slots, steps) fed at each step
    served: dict = field(default_factory=dict)   # rid -> [(slot, step)]
    finished: dict = field(default_factory=dict)  # rid -> step it ended
    faults: list = field(default_factory=list)   # disagreements


def replay(requests, outputs: dict, slots: int, steps: int, eos: int,
           max_seq: int) -> Replay:
    """`requests`: (rid, prompt, max_new_tokens) in submission order;
    `outputs`: rid -> the tokens the engine served (finished or not);
    `steps`: the engine's steps.  A request whose served tokens run past
    where the rules end it, or stop short of it before `steps`, is a
    fault."""
    queue = list(requests)
    slot = [None] * slots
    prog = [0] * slots
    out = Replay(np.full((slots, steps), eos, np.int64))
    for t in range(steps):
        for i in range(slots):
            if slot[i] is None and queue:
                slot[i], prog[i] = queue.pop(0), 0
        for i, req in enumerate(slot):
            if req is None:
                continue
            rid, prompt, max_new = req
            got = outputs.get(rid, [])
            p = prog[i]
            if p < len(prompt):
                out.tokens[i, t] = prompt[p]
            else:
                out.tokens[i, t] = got[p - len(prompt)]
            prog[i] = p = p + 1
            if p < len(prompt):
                continue
            j = p - len(prompt)                 # index of the token served
            if j >= len(got):
                out.faults.append(f"request {rid}: no token {j} at step {t}")
                slot[i] = None
                continue
            out.served.setdefault(rid, []).append((i, t))
            if got[j] == eos or j + 1 >= max_new or p + 1 >= max_seq:
                out.finished[rid] = t
                if j + 1 != len(got):
                    out.faults.append(f"request {rid}: {len(got)} tokens "
                                      f"served, the rules end it at {j + 1}")
                slot[i] = None
    return out
