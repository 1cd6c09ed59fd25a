"""The one traffic generator: every mix is a file of parameters that this
module reads (`mixes/<mix>.json`).  Everything is drawn from the run's
seed; the same seed gives the same traffic.

A serving generation is `requests_per_generation` requests in waves of
`slots`.  Each wave holds the same (prompt length, max_new_tokens)
pairs: `slots` prompt lengths evenly spaced over the range
{"low", "high"}, each paired with one of `slots` evenly spaced output
lengths in a fixed shuffled pairing.  The seed draws the token ids and
the order of the first wave; later waves queue in a fixed order.  So
every seed asks for the same work at the same steps (slots are
interchangeable), and the seed changes what is computed, not how much.
"""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def spread(spec: dict, n: int) -> np.ndarray:
    """n lengths evenly spaced over [low, high], rounded."""
    return np.rint(np.linspace(spec["low"], spec["high"], n)).astype(int)


def requests(mix: dict, seed: int, generation: int, vocab: int,
             first_id: int = 2) -> list[tuple]:
    """One generation's requests, (rid, prompt ids, max_new_tokens), in
    submission order.  Prompt ids avoid 0 and the end-of-sequence id 1."""
    n, w = mix["requests_per_generation"], mix["slots"]
    pairs = list(zip(spread(mix["prompt_len"], w),
                     rng(0, 0).permutation(spread(mix["max_new_tokens"],
                                                  w))))
    r = rng(seed, 1, generation)
    order = list(r.permutation(w)) + [i % w for i in range(w, n)]
    out = []
    for j, k in enumerate(order):
        prompt_len, new = pairs[k]
        out.append((generation * n + j,
                    r.integers(first_id, vocab, int(prompt_len)).tolist(),
                    int(new)))
    return out


def batches(mix: dict, seed: int, vocab: int, device) -> torch.Tensor:
    """The prefill mix's distinct batches, (n, B, S) token ids drawn on
    the device."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x2545F4914F6CDD1D + 3) % (1 << 63))
    return torch.randint(0, vocab, (mix["distinct_batches"], mix["batch"],
                                    mix["seq_len"]), generator=g,
                         device=device)


def warmup_requests(mix: dict, vocab: int) -> list[tuple]:
    """A fixed set for the set-up's warm steps: the mix's slot count of
    prompts of the mix's shortest length."""
    r = rng(0, 2)
    return [(-1 - j, r.integers(2, vocab, mix["prompt_len"]["low"]).tolist(),
             mix["max_new_tokens"]["low"]) for j in range(mix["slots"])]
