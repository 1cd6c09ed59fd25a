"""What both drivers' comparisons share: the reference's weight scheme,
the control read beside the program, and the numbers judged: the two on
logits (in standard deviations of the reference's logits at that
position, so that a limit means the same at every vocabulary and width)
and `proj_err`, a Mamba2 block's recorded projections against the
reference's product of the program's own input to each."""

from __future__ import annotations

import torch

from . import harness as H
from .reference import model as ref_model


def scheme(c: H.Cell):
    """The reference's weights: the configuration's quantisation, or
    None where it serves its dense draws."""
    w = c.conf["program"]["weights"]
    return None if w in ("bfloat16", "float32") else w


def reference(c: H.Cell, tokens, at, routes, groups: str) -> dict:
    return ref_model.forward(c.m, c.seed, tokens, at, groups=groups,
                             weights=scheme(c), routes=routes)


def beside(c: H.Cell) -> bool:
    """Whether this run reads the reference's control beside the
    program."""
    return c.control == "scheme"


def control(c: H.Cell, tokens, at, routes, groups: str) -> dict:
    """The configuration's control at the same positions: the reference
    in the precision below the configuration's (`control.scheme`),
    following the same routes."""
    return ref_model.forward(c.m, c.seed, tokens, at, groups=groups,
                             weights=c.conf["control"]["scheme"],
                             routes=routes)


def gap_sd(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the best, in standard
    deviations of that row's logits: (N, V), (N,) -> (N,)."""
    chosen = logits.gather(1, tokens.view(-1, 1))[:, 0]
    return (logits.max(dim=1).values - chosen) / logits.std(dim=1)


def err_sd(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between two rows of logits, in standard deviations
    of the reference's row."""
    return float(((out.float() - ref).abs().max(dim=1).values
                  / ref.std(dim=1)).max())


def block_layers(L: int) -> set:
    """The layers whose Mamba2 projections are recorded: first, middle,
    last."""
    return {0, L // 2, L - 1}


def projections(c: H.Cell) -> bool:
    """Whether the configuration judges recorded Mamba2 projections."""
    return "proj_err" in c.limits


def proj_err(c: H.Cell, kept: dict, want: int, notes: list):
    """(the widest relative error over the recorded projections, keyed
    by (..., layer), faults): `want` blocks of two projections each."""
    worst, n, faults = 0.0, 0, 0
    for key, pairs in kept.items():
        pairs = [(x.to(c.device), y.to(c.device)) for x, y in pairs]
        n += len(pairs)
        if not pairs:               # counted as a fault below
            continue
        try:
            worst = max(worst, ref_model.proj_err(c.m, c.seed, key[-1],
                                                  pairs, scheme(c)))
        except ValueError as e:
            faults += 1
            notes.append(f"fault: block {key}: {e}")
    notes.append(f"compared {n} projections of {len(kept)} Mamba2 blocks")
    if len(kept) != want or n != 2 * want:
        faults += 1
        notes.append(f"fault: {n} projections of {len(kept)} recorded "
                     f"blocks, not {2 * want} of {want}")
    return worst, faults
