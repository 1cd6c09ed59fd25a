"""Prefill: back-to-back calls of the program's `models.model.prefill`
(the last position's logits of a full-prompt forward) on the mix's
`distinct_batches` batches of `batch` x `seq_len` token ids, made on the
device in set-up and cycled, each call waited for before the next.

End to end: `prefill_tokens_per_s`, the prompt tokens of every call
completed in the window over the window.  Traced: `trace_calls` calls
from the window's middle.

Correct: every call's logits must be finite; for `compare_batches`
batches drawn from the seed, the last call on each in the window is
held to the reference on the same tokens (`logit_err_sd`: the widest gap
between the two rows of last-position logits in standard deviations of
the reference's row), and a MoE's routes of that call are judged
(`route_margin`).  Where the configuration judges Mamba2 projections,
that call's in_proj and out_proj at the first, middle and last layer are
recorded at every 16th position, and each output is held to the
reference's product of the program's own input to it (`proj_err`).
"""

from __future__ import annotations

import contextlib
import time

import torch

from perfbench import compare as X
from perfbench import harness as H
from perfbench import traffic


def run(c: H.Cell) -> H.Outcome:
    from perfbench import program as P
    from perfbench.trace import TracedSlice

    mix, m = c.mix, c.m
    cfg = P.config(c.conf, c.smoke)
    moe = m["family"] == "moe"
    L, B, S = m["num_layers"], mix["batch"], mix["seq_len"]
    params = P.build_params(c.weights, m, c.seed, c.device)
    data = traffic.batches(mix, c.seed, m["vocab_size"], c.device)
    n = data.shape[0]
    keep = set(traffic.rng(c.seed, 3).choice(
        n, mix["compare_batches"], replace=False).tolist())
    record = P.recorded_routes() if moe else contextlib.nullcontext([])
    layers, cur = X.block_layers(L), [None]
    projs = P.RecordedProjections(
        False, lambda i: None if cur[0] is None or i % L not in layers
        else (cur[0], i % L), lambda t: t[:, ::16]) \
        if X.projections(c) else contextlib.nullcontext()
    with record as calls, projs as rb, torch.no_grad():
        def call(j):
            return P.model_mod.prefill(params, {"tokens": data[j % n]}, cfg,
                                       S)
        for j in range(mix["warmup_calls"]):
            call(j)
        H.sync(c)
        calls.clear()
        H.free(c)
        H.reset_peak(c)

        outs, kept = [], {}
        traced, slice_, traced_calls = None, None, 0
        t0 = time.perf_counter()
        setup_s = t0 - c.t_start
        deadline = t0 + c.seconds
        j = 0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            if c.trace and traced is None and now >= t0 + c.seconds / 2:
                slice_ = traced = TracedSlice(P, c.cuda).__enter__()
            if rb is not None:
                rb.calls, cur[0] = 0, (j % n if j % n in keep else None)
            out = call(j)
            H.sync(c)
            t_end = time.perf_counter()
            outs.append(out)
            if j % n in keep:
                kept[j % n] = (out, list(calls))
            calls.clear()
            j += 1
            if slice_ is not None:
                traced_calls += 1
                if traced_calls == mix["trace_calls"]:
                    slice_.__exit__(None, None, None)
                    slice_ = None
        if slice_ is not None:
            slice_.__exit__(None, None, None)
        elapsed = t_end - t0
        peak = H.memory_peak(c)
        failed = sum(int(not torch.isfinite(o).all()) for o in outs)
        kept = {b: (o.float().cpu(), [x.cpu() for x in r])
                for b, (o, r) in kept.items()}
        recorded = {} if rb is None else {
            k: [(x.cpu(), y.cpu()) for x, y in pairs]
            for k, pairs in rb.kept.items() if k[0] in kept}

    e2e = {"prefill_tokens_per_s": j * B * S / elapsed}
    notes = [f"window {elapsed:.6f} s: {j} calls of {B} x {S} tokens"]
    records = {}
    if traced is not None:
        records = traced.records()
        records.update(m=m, mix=mix, calls=traced_calls, batch=B, seq=S)
    del params, outs, calls, rb
    H.free(c)

    lim = c.limits
    worst, route, ctl_err, ctl_route = 0.0, 0.0, 0.0, 0.0
    at = torch.zeros(B, S, dtype=torch.bool, device=c.device)
    at[:, -1] = True
    for b, (out, rec) in sorted(kept.items()):
        tokens = data[b]
        routes = [x.view(B, S, -1).to(c.device) for x in rec] if moe \
            else None
        if moe and len(rec) != L:
            failed += 1
            notes.append(f"fault: {len(rec)} routed layers, not {L}")
            routes = None
        ref = X.reference(c, tokens, at, routes, "all")
        worst = max(worst, X.err_sd(out.to(c.device), ref["logits"]))
        route = max(route, ref["route_margin"])
        if X.beside(c):
            lo = X.control(c, tokens, at, routes, "all")
            ctl_err = max(ctl_err, X.err_sd(lo["logits"], ref["logits"]))
            ctl_route = max(ctl_route, lo.get("route_margin", 0.0))
        del ref
        H.free(c)
    notes.append(f"compared the last logits of {len(kept)} calls")
    compared = {"logit_err_sd": (worst, lim["logit_err_sd"])}
    control = {"logit_err_sd": ctl_err} if X.beside(c) else {}
    if moe:
        compared["route_margin"] = (route, lim["route_margin"])
        if X.beside(c):
            control["route_margin"] = ctl_route
    if X.projections(c):
        err, faults = X.proj_err(c, recorded, len(kept) * len(layers),
                                 notes)
        compared["proj_err"] = (err, lim["proj_err"])
        failed += faults
    if not kept:
        failed += 1
        notes.append("fault: no compared batch was served in the window")
    return H.Outcome(attempted=j, failed=failed, setup_s=setup_s, e2e=e2e,
                     compared=compared, memory_peak=peak, records=records,
                     notes=notes, control=control)
