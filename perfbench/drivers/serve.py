"""Serving: generations of requests through the program's
`ServingEngine`, greedy, back to back, for the window.

A generation is a fresh engine (its cache position starts at 0) given
the mix's `requests_per_generation` requests at once; it is stepped
until its queue and slots are empty, and the next one starts.  The
window is a fixed amount of work: its first round(`steps_per_second` x
`--seconds`) steps, from a generation's start, whatever time they take.
So what a step serves, and the attention length it sees, depend on the
step's place in its generation, never on how fast the program runs.
Each step ends in the engine's copy of the chosen tokens to the host, so
a step's end on the host clock is when its tokens are served.

End to end: `gen_tokens_per_s`, every token served by a step of the
window over the window (its first step's start to its last step's end);
`itl_p95_ms`, the 95th percentile of every gap between a request's
consecutive served tokens in the window.  Traced: a slice of
`trace_steps` steps from the window's middle.

Correct: once the window has closed and the program's state is freed,
each generation's slot streams are replayed from its requests and served
tokens (`reference.streams`), the reference runs over every slot's
stream up to the last step at which a compared request finished, and
every token each finished request served is judged by how far its
logit lies below the reference's best (`token_gap_sd`).  A MoE's routes
are recorded at every step and judged (`route_margin`).  Where the
configuration judges Mamba2 projections, the decode blocks' in_proj and
out_proj at the first, middle and last layer are recorded at 4 steps of
the window for up to 8 slots, steps and slots drawn from the seed, and
each output is held to the reference's product of the program's own
input to it (`proj_err`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import compare as X
from perfbench import harness as H
from perfbench import traffic
from perfbench.reference.streams import replay


def run(c: H.Cell) -> H.Outcome:
    from perfbench import program as P
    from perfbench.trace import TracedSlice
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    mix, m = c.mix, c.m
    cfg = P.config(c.conf, c.smoke)
    moe = m["family"] == "moe"
    params = P.build_params(c.weights, m, c.seed, c.device)
    L = m["num_layers"]
    steps = max(1, round(mix["steps_per_second"] * c.seconds))
    rb = contextlib.nullcontext()
    if X.projections(c):
        at = set(traffic.rng(c.seed, 6).choice(
            steps, min(4, steps), replace=False).tolist())
        layers = X.block_layers(L)
        rows = torch.tensor(sorted(traffic.rng(c.seed, 7).choice(
            mix["slots"], min(8, mix["slots"]), replace=False).tolist()),
            device=c.device)
        rb = P.RecordedProjections(
            True, lambda i: (i // L, i % L) if i // L in at and
            i % L in layers else None, lambda t: t[rows])
    scfg = ServeConfig(slots=mix["slots"], max_seq=mix["max_seq"],
                       eos_id=mix["eos_id"])
    record = P.recorded_routes() if moe else contextlib.nullcontext([])
    with record as calls, rb as projs:
        eng = ServingEngine(cfg, params, scfg, device=c.device)
        for rid, prompt, new in traffic.warmup_requests(mix, m["vocab_size"]):
            eng.submit(Request(rid, prompt, new))
        for _ in range(mix["warmup_steps"]):
            eng.step_batch()
        H.sync(c)
        del eng
        calls.clear()
        H.free(c)
        H.reset_peak(c)

        gens, step_ends, itl = [], [], []
        generated = occupied = prompt_steps = 0
        traced, slice_, slice_steps = None, None, []
        if projs is not None:
            projs.calls = 0
        t0 = time.perf_counter()
        setup_s = t0 - c.t_start
        g = 0
        while len(step_ends) < steps:
            reqs = traffic.requests(mix, c.seed, g, m["vocab_size"])
            eng = ServingEngine(cfg, params, scfg, device=c.device)
            objs = [Request(rid, prompt, new) for rid, prompt, new in reqs]
            for r in objs:
                eng.submit(r)
            gen = {"requests": reqs, "objs": objs, "steps": 0,
                   "first_call": len(calls)}
            gens.append(gen)
            live = {r.rid: r for r in objs}
            seen = {r.rid: 0 for r in objs}
            last_t = {}
            while eng.queue or any(r is not None for r in eng.slot_req):
                if len(step_ends) == steps:
                    break
                if c.trace and traced is None and \
                        len(step_ends) >= steps // 2:
                    slice_ = traced = TracedSlice(P, c.cuda).__enter__()
                pos = gen["steps"]
                active = eng.step_batch()
                H.sync(c)
                t = time.perf_counter()
                step_ends.append(t)
                gen["steps"] += 1
                occupied += active
                for rid in list(live):
                    r = live[rid]
                    n = len(r.output)
                    if n > seen[rid]:
                        generated += n - seen[rid]
                        if rid in last_t:
                            itl.append(t - last_t[rid])
                        last_t[rid] = t
                        seen[rid] = n
                    if r.done:
                        del live[rid]
                if slice_ is not None:
                    slice_steps.append((pos, active))
                    if len(slice_steps) == mix["trace_steps"]:
                        slice_.__exit__(None, None, None)
                        slice_ = None
            if slice_ is not None:      # the generation drained mid-slice
                slice_.__exit__(None, None, None)
                slice_ = None
            # what the comparison and the counters need, then the engine
            # goes before the next one takes its cache
            gen["finished"] = set(eng.finished)
            prompt_steps += sum(len(r.prompt) for r in objs
                                if r.rid in eng.finished)
            prompt_steps += sum(min(int(eng.slot_pos[i]), len(r.prompt))
                                for i, r in enumerate(eng.slot_req)
                                if r is not None)
            del eng
            g += 1
        elapsed = step_ends[-1] - t0
        peak = H.memory_peak(c)
        recorded = {} if projs is None else {
            k: [(x.cpu(), y.cpu()) for x, y in pairs]
            for k, pairs in projs.kept.items()}

    attempted = sum(len(gen["requests"]) for gen in gens)
    outputs = {}
    for gen in gens:
        outputs.update((r.rid, list(r.output)) for r in gen["objs"])
        gen["routes"] = _routes_by_layer(calls[gen["first_call"]:],
                                         m["num_layers"], gen["steps"])
        del gen["objs"]
    e2e = {"gen_tokens_per_s": generated / elapsed}
    notes = [f"window {elapsed:.6f} s: {len(step_ends)} steps over "
             f"{len(gens)} generation(s), {generated} tokens served, "
             f"{len(itl)} inter-token gaps"]
    if itl:
        e2e["itl_p95_ms"] = 1e3 * float(np.percentile(itl, 95))
    records = {}
    if traced is not None:
        records = traced.records()
        records.update(m=m, mix=mix, slots=mix["slots"], steps=slice_steps,
                       window_steps=len(step_ends),
                       occupied=occupied, prompt_steps=prompt_steps)
    del params, calls, projs
    H.free(c)

    compared, failed, control = compare(c, gens, outputs, notes)
    if X.projections(c):
        err, faults = X.proj_err(c, recorded, len(at) * len(layers), notes)
        compared["proj_err"] = (err, c.limits["proj_err"])
        failed += faults
    return H.Outcome(attempted=attempted, failed=failed, setup_s=setup_s,
                     e2e=e2e, compared=compared, memory_peak=peak,
                     records=records, notes=notes, control=control)


def _routes_by_layer(calls: list, L: int, steps: int) -> list:
    """Per layer, (slots, steps, k) expert ids on the host, from the
    recorded calls (one a layer a step, in order)."""
    if not calls:
        return None
    ids = torch.stack([x.cpu() for x in calls[:L * steps]])
    return [ids[l::L].transpose(0, 1) for l in range(L)]


def compare(c: H.Cell, gens: list, outputs: dict, notes: list):
    mix, m = c.mix, c.m
    lim = c.limits
    worst_gap, worst_route, failed, n_tok = 0.0, 0.0, 0, 0
    ctl_gap, ctl_route = 0.0, 0.0
    dev = c.device
    for gen in gens:
        rep = replay([(rid, p, n) for rid, p, n in gen["requests"]], outputs,
                     mix["slots"], gen["steps"], mix["eos_id"],
                     mix["max_seq"])
        if set(rep.finished) != gen["finished"]:
            rep.faults.append("the engine finished "
                              f"{sorted(gen['finished'])}, its rules "
                              f"{sorted(rep.finished)}")
        for f in rep.faults:
            notes.append("fault: " + f)
        failed += len(rep.faults)
        done = sorted(rid for rid in gen["finished"] if rid in rep.finished)
        if not done:
            continue
        P = max(rep.finished[rid] for rid in done) + 1
        at = np.zeros((mix["slots"], P), bool)
        want = []
        for rid in done:
            for j, (i, t) in enumerate(rep.served[rid]):
                at[i, t] = True
                want.append((i, t, outputs[rid][j]))
        rows = {(i, t): k for k, (i, t) in enumerate(zip(*np.nonzero(at)))}
        tokens = torch.from_numpy(rep.tokens[:, :P]).to(dev)
        at_t = torch.from_numpy(at).to(dev)
        routes = None if gen["routes"] is None else \
            [x[:, :P].to(dev) for x in gen["routes"]]
        order = torch.tensor([rows[(i, t)] for i, t, _ in want], device=dev)
        served = torch.tensor([tok for _, _, tok in want], device=dev)
        ref = X.reference(c, tokens, at_t, routes, "position")
        logits = ref["logits"][order]
        worst_gap = max(worst_gap, float(X.gap_sd(logits, served).max()))
        worst_route = max(worst_route, ref["route_margin"])
        n_tok += len(want)
        if X.beside(c):
            lo = X.control(c, tokens, at_t, routes, "position")
            ctl_gap = max(ctl_gap, float(X.gap_sd(
                logits, lo["logits"][order].argmax(1)).max()))
            ctl_route = max(ctl_route, lo.get("route_margin", 0.0))
        del ref
        H.free(c)
    notes.append(f"compared {n_tok} served tokens of "
                 f"{sum(len(g['finished']) for g in gens)} finished requests")
    compared = {"token_gap_sd": (worst_gap, lim["token_gap_sd"])}
    control = {}
    if m["family"] == "moe":
        compared["route_margin"] = (worst_route, lim["route_margin"])
    if X.beside(c):
        control = {"token_gap_sd": ctl_gap}
        if m["family"] == "moe":
            control["route_margin"] = ctl_route
    if n_tok == 0:
        failed += 1
        notes.append("fault: no request finished in the window")
    return compared, failed, control
