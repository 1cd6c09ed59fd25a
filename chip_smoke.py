#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA source in src/repro_torch/csrc (decode_attention,
     flash_attention, flash_attention_wgmma, ssd_scan, ssd_scan_tc), one
     nvcc each, started together;
  3. each kernel variant against its plain PyTorch version on the card,
     over the reference's test shapes and the shapes of SmolLM-360M,
     DeepSeek-Coder-33B, Mamba2-2.7B and Zamba2-7B, f32 and bf16; each
     case runs on the variant that `ops.variant` picks for it (flash:
     wgmma for bf16 at hd 64/128, fma otherwise; ssd_scan: tc for bf16,
     fma for f32);
  4. SmolLM-360M at full width in f32: token-by-token decode_step logits
     (decode kernel) against the forward pass (flash fma kernel), 2e-3;
  5. serving: SmolLM-360M at full width in bf16, 8 slots, 16 requests;
     then a bf16 prefill of B=2 x 2048 tokens (flash wgmma kernel),
     timed, against the eager path;
  6. Mamba2-2.7B at full width: f32 decode against forward (ssd_scan fma
     kernel), the f32 kernel engine against the plain engine, a bf16
     prefill of 2048 tokens (ssd_scan tc kernels), and serving in bf16,
     8 slots, 16 requests;
  7. the hybrid: Zamba2-7B's widths cut to 12 layers (two shared-attention
     slots), f32 decode against forward through the fma kernels;
  8. timings at the main paths' shapes: each variant, its plain version,
     and one PyTorch library call as a yardstick where one computes the
     same function (the port never calls it); decode_attention also at
     the full-context step's shape and at DeepSeek-Coder-33B's heads over
     a 16384-token cache, and at one split fewer and more than its rule
     picks.  `ms`, `plain_ms` and `library_ms` are device time per call
     (the kernels' durations from torch.profiler); `call_ms` is CUDA-event
     time over back-to-back calls, which the host's launch cost bounds at
     small shapes.
Phase 5 ends with a full-context SmolLM-360M decode step: bf16, 8 slots
of a 2048-token cache filled with seeded random K/V, position 2000; 32
steps timed, one profiled (device busy, idle share, decode_attention's
share), the first step's logits against the eager path.
Phases 4-5, 6 and 7 are the three main paths.  The launch counters are
zeroed just before each and read just after it; every kernel variant of a
path must have launched there, and the JSON line's `launches` is a
kernel's sum over the three (one ssd_scan call of either variant is three
launches).  The last two lines are a JSON object of per-kernel numbers,
with a `variants` entry per kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params, prefill)
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor-core bf16
              torch.float32: 67e12}       # f32 outside the tensor cores
DT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 2e-5, "bf16": 2e-2}         # tests/test_kernels.py
TOL_LONG_F32 = 1e-4                       # f32 at S >= 2000: longer sums
SSD_TOL = {"f32": 1e-4, "bf16": 3e-2}      # tests/test_kernels.py
# decode also against the output's scale: over a long cache |o| ~
# sqrt(e / len) is below TOL["bf16"], and a dropped split of a 16K cache
# moves o by more than 1e-3 an element, so max |out - ref| / max |ref|
# <= 1e-2 as well
DECODE_REL_TOL = 1e-2

# (B, H, Hkv, T, hd, length, window): the reference's DA_SHAPES, then
# SmolLM-360M serving (8 slots, max_seq 512), length > T included
DECODE_CASES = [
    (2, 4, 4, 128, 32, 100, 0), (1, 8, 2, 256, 64, 256, 0),
    (2, 4, 1, 64, 32, 1, 0), (1, 4, 4, 160, 32, 130, 0),
    (1, 4, 2, 256, 32, 200, 96),
    (8, 15, 5, 512, 64, 1, 0), (8, 15, 5, 512, 64, 200, 0),
    (8, 15, 5, 512, 64, 512, 0), (8, 15, 5, 512, 64, 700, 0),
    (8, 15, 5, 512, 64, 700, 128),
    (2, 32, 32, 256, 112, 1, 0), (2, 32, 32, 256, 112, 256, 0),
    (8, 32, 32, 512, 112, 300, 0),
    # the split: length 1 of a 16K cache (all splits but one empty);
    # SmolLM-360M's full 2048-token context (6 splits) with a length one
    # row past a split boundary in bf16 (385 = 6 tiles of 64 + 1: splits
    # of 2 tiles, the fourth holding one row, the last two empty), a
    # window inside one split and length > T; units = B * Hkv = 1056, so
    # one split; 12 q heads per kv head (two blocks of 8 heads); f32 and
    # bf16 at hd 256
    (2, 56, 8, 16384, 128, 1, 0), (8, 15, 5, 2048, 64, 385, 0),
    (8, 15, 5, 2048, 64, 1500, 20), (8, 15, 5, 2048, 64, 2500, 0),
    (33, 32, 32, 128, 112, 100, 0), (2, 96, 8, 1200, 128, 1150, 0),
    (2, 8, 2, 1100, 256, 1090, 0),
    (8, 56, 8, 16384, 128, 16384, 0),          # DeepSeek-Coder-33B, 16K
]
DEEPSEEK_16K = (8, 56, 8, 16384, 128, 16384, 0)
# the full-context decode step's attention: 8 slots x 2048, length 2001
FULL_CONTEXT = (8, 15, 5, 2048, 64, 2001, 0)
# (B, H, Hkv, Sq, Sk, hd, causal, window): the reference's FA_SHAPES, a
# row set with no visible key, then SmolLM-360M prompts
FLASH_CASES = [
    (1, 4, 4, 64, 64, 32, True, 0), (2, 8, 2, 96, 96, 64, True, 0),
    (1, 4, 1, 128, 128, 32, True, 0), (1, 2, 2, 80, 80, 32, True, 0),
    (1, 4, 2, 64, 64, 32, True, 24), (1, 2, 2, 48, 48, 16, False, 0),
    (1, 2, 2, 48, 16, 16, False, 8),
    (2, 15, 5, 2048, 2048, 64, True, 0), (2, 15, 5, 2000, 2000, 64, True, 0),
    (2, 15, 5, 2048, 2048, 64, True, 256),
    (2, 32, 32, 256, 256, 112, True, 32768),
    (1, 32, 32, 512, 512, 112, True, 128),
    (1, 56, 8, 2048, 2048, 128, True, 0),       # DeepSeek-Coder-33B's heads
    (1, 4, 2, 130, 130, 128, True, 40), (1, 2, 2, 48, 16, 64, False, 8),
]
SMOLLM_FLASH = (2, 15, 5, 2048, 2048, 64, True, 0)
# the eager path rounds scores to bf16 before its softmax (up to ~2 % per
# probability at |s| ~ 8) where the kernel keeps them f32; 32 layers
# compound that.  A mis-masked or mis-scaled tile moves logits by O(1).
PREFILL_REL_LIMIT = 0.1
# (b, s, h, p, n, chunk, strong decay): the reference's SSD_SHAPES,
# Mamba2-2.7B's and Zamba2-7B's shapes, and A = -16, dt = 0.1, where
# exp(cum_i - cum_j) above the diagonal overflows to +inf
SSD_CASES = [
    (1, 64, 4, 16, 16, 16, False), (2, 128, 8, 32, 32, 32, False),
    (1, 96, 2, 16, 64, 32, False), (1, 64, 8, 64, 16, 64, False),
    (2, 2048, 80, 64, 128, 128, False), (2, 512, 112, 64, 64, 128, False),
    (2, 512, 80, 64, 128, 128, True),
    # the main paths' f32 forwards at S=256: Mamba2-2.7B, Zamba2-7B
    (2, 256, 80, 64, 128, 128, False), (2, 256, 112, 64, 64, 128, False),
]
MAMBA_SHAPE = (2, 2048, 80, 64, 128, 128, False)
MAMBA_256 = (2, 256, 80, 64, 128, 128, False)
ZAMBA_256 = (2, 256, 112, 64, 64, 128, False)
# the full-context decode step against the eager path, which rounds its
# scores and probabilities to bf16 where the kernel keeps them f32; the
# same reasoning and limit as PREFILL_REL_LIMIT
DECODE_REL_LIMIT = 0.1


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def dev_us(event) -> float:
    return getattr(event, "self_device_time_total", None) \
        or getattr(event, "self_cuda_time_total", 0.0)


def device_kernels(fn, iters: int, warmup: int = 3) -> dict:
    """Device time per call by kernel name: the durations of the kernels
    the calls launched, from torch.profiler, over `iters` calls.  Unlike
    `cuda_ms` it leaves out the host's time between launches, which at
    small shapes is longer than the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # now and then the profiler hands back no kernel for a run (a 0 ms
    # reading): measure again rather than report it
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0:
                name = kernel_name(e.key)
                out[name] = out.get(name, 0.0) + dev_us(e) / 1e3 / iters
        if out:
            return out
    raise RuntimeError("torch.profiler recorded no kernel in three runs")


def device_ms(fn, iters: int) -> float:
    return sum(device_kernels(fn, iters).values())


def timed(fn, iters: int) -> tuple[float, float, dict]:
    """(device ms per call, ms per call by CUDA events over back-to-back
    calls, which includes the host's launch time where that is longer,
    device ms per call by kernel)."""
    kernels = device_kernels(fn, iters)
    return sum(kernels.values()), cuda_ms(fn, iters), kernels


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def decode_inputs(case, dtype, device, seed=0):
    B, H, Hkv, T, hd, length, window = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q = randn(gen, (B, H, hd), dtype, device)
    k = randn(gen, (B, Hkv, T, hd), dtype, device)
    v = randn(gen, (B, Hkv, T, hd), dtype, device)
    return q, k, v, torch.tensor(length, dtype=torch.int32, device=device)


def flash_inputs(case, dtype, device, seed=0):
    B, H, Hkv, Sq, Sk, hd, causal, window = case
    gen = torch.Generator(device=device).manual_seed(seed)
    return (randn(gen, (B, H, Sq, hd), dtype, device),
            randn(gen, (B, Hkv, Sk, hd), dtype, device),
            randn(gen, (B, Hkv, Sk, hd), dtype, device))


def ssd_inputs(case, dtype, device, seed=0):
    """The reference's SSD test inputs (x, B, C normal; dt uniform in
    [0.001, 0.1]; A uniform in [-2, -0.5]) or, with strong decay, A = -16
    and dt = 0.1."""
    b, s, h, p, n, chunk, strong = case
    gen = torch.Generator(device=device).manual_seed(seed)
    x = randn(gen, (b, s, h, p), dtype, device)
    if strong:
        dt = torch.full((b, s, h), 0.1, device=device)
        A = torch.full((h,), -16.0, device=device)
    else:
        dt = 0.001 + 0.099 * torch.rand((b, s, h), generator=gen,
                                        device=device)
        A = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=device))
    return (x, dt, A, randn(gen, (b, s, n), dtype, device),
            randn(gen, (b, s, n), dtype, device))


def compare(name, out, ref, tol) -> float:
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{name}: {m}")
    return float((out.float() - ref.float()).abs().max())


def decode_workspace_reuse(dtype, dname, device) -> None:
    """Calls of one shape share a cached workspace: two calls in a row
    with different lengths are both right, and each leaves the ticket
    counters at zero."""
    case = (8, 15, 5, 2048, 64, 2001, 0)
    q, k, v, _ = decode_inputs(case, dtype, device, seed=4)
    for length in (2001, 37, 1500):
        len_t = torch.tensor(length, dtype=torch.int32, device=device)
        out = da_ops.decode_attention(q, k, v, len_t)
        compare(f"decode reuse len={length} {dname}", out,
                decode_attention_ref(q, k, v, len_t), TOL[dname])
        for ws_key, (_, _, counters) in da_ops._WORKSPACES.items():
            if int(counters.abs().sum()) != 0:
                raise AssertionError(f"decode: ticket counters of {ws_key} "
                                     "not reset")
    log("kernel", f"decode_attention {dname}: three calls (len 2001, 37, "
        "1500) "
        f"on one cached workspace of {len(da_ops._WORKSPACES)}: right, "
        "counters back at 0")


def check_kernels(device) -> None:
    sms = _build.sm_count(device)
    for dname, dtype in DT.items():
        for case in DECODE_CASES:
            q, k, v, length = decode_inputs(case, dtype, device)
            window = case[-1]
            out = da_ops.decode_attention(q, k, v, length, window=window)
            ref = decode_attention_ref(q, k, v, length, window=window)
            torch.cuda.synchronize()
            err = compare(f"decode {case} {dname}", out, ref, TOL[dname])
            rel = err / max(float(ref.float().abs().max()), 1e-30)
            if rel > DECODE_REL_TOL:
                raise AssertionError(f"decode {case} {dname}: max |diff| / "
                                     f"max |ref| {rel}")
            B, H, Hkv, T = case[:4]
            rg = da_ops.heads_per_block(H // Hkv, dtype)
            units = B * Hkv * -(-(H // Hkv) // rg)
            ring = da_ops.ring_bytes(case[4], dtype)
            log("kernel", f"decode_attention {dname} (B,H,Hkv,T,hd,len,win)="
                f"{case}: max_abs_err {err:.3g} (rtol = atol = "
                f"{TOL[dname]}), relative to max |ref| {rel:.3g} (limit "
                f"{DECODE_REL_TOL}); {units} units x "
                f"{da_ops.num_splits(units, T, ring, sms)} splits)")
        decode_workspace_reuse(dtype, dname, device)
        for case in FLASH_CASES:
            q, k, v = flash_inputs(case, dtype, device)
            causal, window = case[6], case[7]
            var = fa_ops.variant(dtype, case[5])
            out = fa_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                              window=window)
            ref = fa_ops.PLAIN[var](q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            tol = TOL_LONG_F32 if dname == "f32" and case[3] >= 2000 \
                else TOL[dname]
            err = compare(f"flash {var} {case} {dname}", out, ref, tol)
            log("kernel", f"flash_attention {var} {dname} (B,H,Hkv,Sq,Sk,hd,"
                f"causal,win)={case}: max_abs_err {err:.3g} "
                f"(rtol = atol = {tol})")
        for case in SSD_CASES:
            x, dt, A, B, C = ssd_inputs(case, dtype, device)
            var = ssd_ops.variant(dtype, case[3], case[4], case[5])
            y = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=case[5])
            ref = ssd_ops.PLAIN[var](x, dt, A, B, C, case[5])
            torch.cuda.synchronize()
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"ssd_scan {case} {dname}: non-finite")
            err = compare(f"ssd {var} {case} {dname}", y, ref,
                          SSD_TOL[dname])
            f32_alg = float((y.float() - ssd_scan_ref(x, dt, A, B, C, case[5])
                             .float()).abs().max())
            log("kernel", f"ssd_scan {var} {dname} (b,s,h,p,n,chunk,strong)="
                f"{case}: max_abs_err {err:.3g} "
                f"(rtol = atol = {SSD_TOL[dname]}, "
                f"max |ref| {float(ref.float().abs().max()):.3g}; "
                f"against the f32 algorithm {f32_alg:.3g})")


# ---------------------------------------------------------------------------
# the main paths' checks: decode against forward, serving
# ---------------------------------------------------------------------------


def decode_vs_forward(cfg, params, device, B=2, S=64, seed=0):
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S))).to(device)
    ref, _, _ = forward(params, {"tokens": tokens}, cfg)
    cache = init_cache(cfg, B, S, device=device)
    outs = []
    for t in range(S):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg)
        outs.append(logits)
    dec = torch.stack(outs, dim=1)
    if not (torch.isfinite(dec).all() and torch.isfinite(ref).all()):
        raise AssertionError("non-finite logits")
    if dec.shape != (B, S, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(dec.shape)}")
    return compare("decode vs forward", dec, ref, 2e-3)



def make_requests(vocab, n=16, lo=32, hi=128, new=32, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    return [Request(rid=i, prompt=rng.integers(2, vocab, int(m)).tolist(),
                    max_new_tokens=new) for i, m in enumerate(lengths)]


def serve(cfg, params, scfg, requests, device):
    eng = ServingEngine(cfg, params, scfg, device=device)
    for r in requests:
        eng.submit(r)
    step_s = []
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        ts = time.perf_counter()
        eng.step_batch()                 # ends in a host copy of the argmax
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        if len(step_s) > 10_000:
            raise RuntimeError("serving did not drain")
    return eng, time.perf_counter() - t0, step_s


def report_serving(name, eng, requests, wall, step_s, weight_bytes, vocab,
                   new=32):
    """Check that every request finished with 1..new valid tokens, and
    print the serving metrics."""
    outs = [eng.finished[r.rid].output for r in requests
            if r.rid in eng.finished]
    if len(outs) != len(requests):
        raise AssertionError(f"{len(outs)}/{len(requests)} requests finished")
    for o in outs:
        if not (1 <= len(o) <= new and all(0 <= t < vocab for t in o)):
            raise AssertionError(f"bad output {o}")
    generated = sum(len(o) for o in outs)
    steps, slots = len(step_s), eng.scfg.slots
    log("serve", f"{name} full width bf16 ({weight_bytes} B of weights), "
        f"{slots} slots, max_seq {eng.scfg.max_seq}: {len(outs)}/"
        f"{len(requests)} requests finished, {generated} tokens generated "
        f"in {steps} steps, {wall:.3f} s")
    log("serve", f"{name}: {generated / wall:.1f} generated tokens/s, "
        f"{slots * steps / wall:.1f} slot-steps/s, p50 step "
        f"{1e3 * float(np.median(step_s)):.3f} ms, p99 step "
        f"{1e3 * float(np.percentile(step_s, 99)):.3f} ms, shared pos "
        f"{int(eng.cache['pos'])}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")


def engines_agree(cfg32, params32, device):
    """The f32 kernel engine gives the plain (eager) engine's tokens on
    the same small requests."""
    outs = []
    for impl in ("pallas", "xla"):
        small = make_requests(cfg32.vocab_size, n=2, lo=16, hi=16, new=8,
                              seed=1)
        eng, _, _ = serve(cfg32.scaled(attn_impl=impl), params32,
                          ServeConfig(slots=2, max_seq=64), small, device)
        outs.append({r: q.output for r, q in eng.finished.items()})
    if outs[0] != outs[1]:
        raise AssertionError(f"kernel engine {outs[0]} != plain {outs[1]}")
    return outs[0]


def zero_launches() -> None:
    da_ops.zero_launches()
    fa_ops.zero_launches()
    ssd_ops.zero_launches()


def read_launches(path: str, needed) -> dict:
    """Launches per kernel variant ("flash_attention.wgmma", ...) since
    the last zero_launches; every variant in `needed` must have run."""
    got = {}
    for name, mod in (("decode_attention", da_ops),
                      ("flash_attention", fa_ops), ("ssd_scan", ssd_ops)):
        for var, n in mod.launches_by_variant.items():
            got[f"{name}.{var}"] = n
        if sum(mod.launches_by_variant.values()) != mod.launches:
            raise AssertionError(f"{name}: variant counts do not sum")
    log(path, f"launches on this path: {got}")
    for name in needed:
        if got[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {path} "
                                 "path")
    return got


def free() -> None:
    """Return the memory of a finished phase's tensors to the card before
    the next model loads."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4-5: SmolLM-360M
# ---------------------------------------------------------------------------


def smollm_path(device):
    base = get_config("smollm-360m").scaled(attn_impl="pallas")
    cfg32 = base.scaled(dtype="float32")
    params32 = init_params(cfg32, seed=0, device=device)
    n_params = sum(t.numel() for t in leaves(params32))
    err = decode_vs_forward(cfg32, params32, device)
    log("decode-vs-forward", f"smollm-360m full width ({n_params} "
        f"params) f32 B=2 S=64: max_abs_err {err:.3g} "
        "(rtol = atol = 2e-3)")

    cfg16 = base.scaled(dtype="bfloat16")
    params16 = init_params(cfg16, seed=0, device=device)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in leaves(params16))
    requests = make_requests(cfg16.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng, wall, step_s = serve(cfg16, params16,
                              ServeConfig(slots=8, max_seq=512), requests,
                              device)
    report_serving("smollm-360m", eng, requests, wall, step_s, weight_bytes,
                   cfg16.vocab_size)
    toks = engines_agree(cfg32, params32, device)
    log("serve", f"smollm-360m f32 kernel engine tokens == plain engine "
        f"tokens: {toks}")
    dec_len = min(int(eng.cache["pos"]), 512)
    del params32, eng
    free()
    fc = full_context_decode(cfg16, params16, device)
    free()
    wall, rel, agree = timed_prefill(cfg16, params16, device, seed=3)
    log("prefill", f"smollm-360m full width bf16 B=2 S=2048: "
        f"{1e3 * wall:.3f} ms, {2 * 2048 / wall:.1f} prompt tokens/s; "
        f"against the eager path (bf16 scores, f32 softmax): max |diff| / "
        f"max |logit| {rel:.3g} (limit {PREFILL_REL_LIMIT}), top-1 "
        f"agreement {agree}")
    if rel > PREFILL_REL_LIMIT:
        raise AssertionError(f"prefill kernel vs eager: relative {rel}")
    return dec_len, fc


def timed_prefill(cfg16, params16, device, seed, S=2048):
    """A warm-up and a timed bf16 prefill of B=2 x S tokens through the
    kernels, then the eager path's on the same tokens.  Returns (seconds,
    max |diff| / max |logit|, top-1 agreement)."""
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg16.vocab_size, (2, S))).to(device)
    prefill(params16, {"tokens": tokens}, cfg16, S)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = prefill(params16, {"tokens": tokens}, cfg16, S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plain = prefill(params16, {"tokens": tokens},
                    cfg16.scaled(attn_impl="xla"), S)
    if last.shape != (2, cfg16.vocab_size) or not torch.isfinite(last).all():
        raise AssertionError(f"prefill logits {tuple(last.shape)} not finite")
    rel = float((last - plain).abs().max() / plain.abs().max())
    agree = float((last.argmax(-1) == plain.argmax(-1)).float().mean())
    where_the_time_goes(cfg16, params16, tokens, S)
    return wall, rel, agree


def kernel_name(key: str) -> str:
    """`ssd_chunk_scan_kernel` of a profiler key such as `void (anonymous
    namespace)::ssd_chunk_scan_kernel<...>(float const*, ...)`."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].split("<")[0].split("::")[-1][:48]


def profile_call(fn):
    """One call of `fn` under torch.profiler.  Returns (wall ms, device
    busy ms: the sum of the kernels' times, [(kernel name, ms, count)]
    largest first).  The profiler slows the host, so 1 - busy / wall is
    an upper bound for the idle share of an unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    # kernels only: an operator's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    kernels = sorted(((e.key, dev_us(e) / 1e3, e.count) for e in events),
                     key=lambda kv: kv[1], reverse=True)
    return wall_ms, sum(ms for _, ms, _ in kernels), kernels


def where_the_time_goes(cfg, params, tokens, S, top=8):
    """One more prefill under torch.profiler: the device's busy time
    against the call's wall time, and the kernels that take the most."""
    wall_ms, busy_ms, kernels = profile_call(
        lambda: prefill(params, {"tokens": tokens}, cfg, S))
    parts = ", ".join(f"{k[:48]} {ms:.3f} ms x{n}"
                      for k, ms, n in kernels[:top])
    log("prefill", f"{cfg.name} where the time goes (profiled call, "
        f"{wall_ms:.3f} ms wall): device busy {busy_ms:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; top kernels: {parts}")


def full_context_decode(cfg16, params16, device, slots=8, T=2048, pos=2000,
                        steps=32, seed=5):
    """SmolLM-360M's decode step at its published 2048-token context: 8
    slots of seeded random bf16 K/V, the shared position at `pos`.  The
    first step's logits against the eager path (on a clone of the cache),
    then `steps` timed steps (host clock, each ending in a synchronise)
    and one profiled step.  Returns the step's numbers."""
    cache = init_cache(cfg16, slots, T, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=gen,
                                      device=device).to(cache[name].dtype))
    cache["pos"].fill_(pos)
    rng = np.random.default_rng(seed)
    toks = [torch.from_numpy(rng.integers(0, cfg16.vocab_size, (slots, 1)))
            .to(device) for _ in range(steps + 2)]
    plain_cache = {k: v.clone() for k, v in cache.items()}
    plain, _ = decode_step(params16, plain_cache, toks[0],
                           cfg16.scaled(attn_impl="xla"))
    del plain_cache
    logits, cache = decode_step(params16, cache, toks[0], cfg16)
    if logits.shape != (slots, cfg16.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"full-context decode logits "
                             f"{tuple(logits.shape)} not finite")
    rel = float((logits - plain).abs().max() / plain.abs().max())
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    if rel > DECODE_REL_LIMIT:
        raise AssertionError(f"full-context decode vs eager: relative {rel}")
    step_s = []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = decode_step(params16, cache, toks[1 + t], cfg16)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    wall_ms, busy_ms, kernels = profile_call(
        lambda: decode_step(params16, cache, toks[-1], cfg16))
    da_ms = sum(ms for k, ms, _ in kernels if "decode_split_kernel" in k)
    out = dict(rel=rel, top1=agree, p50_ms=1e3 * float(np.median(step_s)),
               p99_ms=1e3 * float(np.percentile(step_s, 99)),
               profiled_wall_ms=wall_ms, busy_ms=busy_ms,
               idle_share=max(0.0, 1 - busy_ms / wall_ms),
               decode_attention_ms=da_ms,
               decode_attention_share=da_ms / busy_ms if busy_ms else 0.0)
    parts = ", ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, ms, n in kernels[:6])
    log("decode-2048", f"smollm-360m full width bf16, {slots} slots x {T} "
        f"cache, pos {pos}: first step against the eager path max |diff| / "
        f"max |logit| {rel:.3g} (limit {DECODE_REL_LIMIT}), top-1 agreement "
        f"{agree}; {steps} steps p50 {out['p50_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms; one profiled step {wall_ms:.3f} ms wall, "
        f"device busy {busy_ms:.3f} ms, idle share {out['idle_share']:.3f}, "
        f"decode_attention {da_ms:.3f} ms ({out['decode_attention_share']:.3f}"
        f" of busy); top kernels: {parts}")
    return out


# ---------------------------------------------------------------------------
# phase 6: Mamba2-2.7B
# ---------------------------------------------------------------------------


def mamba2_path(device):
    base = get_config("mamba2-2.7b").scaled(attn_impl="pallas")
    cfg32 = base.scaled(dtype="float32")
    params32 = init_params(cfg32, seed=0, device=device)
    n_params = sum(t.numel() for t in leaves(params32))
    err = decode_vs_forward(cfg32, params32, device, S=256)
    log("mamba2", f"decode-vs-forward: mamba2-2.7b full width ({n_params} "
        f"params) f32 B=2 S=256 (two chunks of 128): max_abs_err {err:.3g} "
        "(rtol = atol = 2e-3)")
    toks = engines_agree(cfg32, params32, device)
    log("mamba2", f"f32 kernel engine tokens == plain engine tokens: {toks}")
    del params32
    free()

    cfg16 = base.scaled(dtype="bfloat16")
    params16 = init_params(cfg16, seed=0, device=device)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in leaves(params16))
    wall, rel, agree = timed_prefill(cfg16, params16, device, seed=2)
    log("mamba2", f"prefill bf16 B=2 S=2048: {1e3 * wall:.3f} ms, "
        f"{2 * 2048 / wall:.1f} tokens/s; against the eager path (bf16 "
        f"casts of ssd_chunked): max |diff| / max |logit| {rel:.3g} "
        f"(limit 0.25), top-1 agreement {agree}")
    if rel > 0.25:
        raise AssertionError(f"prefill kernel vs eager: relative {rel}")

    requests = make_requests(cfg16.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng, wall, step_s = serve(cfg16, params16,
                              ServeConfig(slots=8, max_seq=512), requests,
                              device)
    ssm_bytes = sum(t.numel() * t.element_size()
                    for t in leaves(eng.cache["ssm"]))
    report_serving("mamba2-2.7b", eng, requests, wall, step_s, weight_bytes,
                   cfg16.vocab_size)
    log("mamba2", f"SSM cache at 8 slots: {ssm_bytes} B "
        f"(state {eng.cache['ssm']['state'].numel() * 2} B of bf16)")


# ---------------------------------------------------------------------------
# phase 7: the hybrid, Zamba2-7B widths at 12 layers
# ---------------------------------------------------------------------------


def hybrid_path(device):
    cfg = get_config("zamba2-7b").scaled(num_layers=12, attn_impl="pallas",
                                         dtype="float32")
    params = init_params(cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in leaves(params))
    err = decode_vs_forward(cfg, params, device, S=256)
    log("hybrid", f"decode-vs-forward: zamba2-7b widths, 12 layers "
        f"({n_params} params, shared attention after layers 6 and 12, "
        f"window {cfg.attn_window}) f32 B=2 S=256 max_seq 256: max_abs_err "
        f"{err:.3g} (rtol = atol = 2e-3)")


# ---------------------------------------------------------------------------
# phase 8: timings
# ---------------------------------------------------------------------------


def time_decode(case, dtype, device):
    B, H, Hkv, T, hd, length, window = case
    q, k, v, len_t = decode_inputs(case, dtype, device, seed=1)
    out = da_ops.decode_attention(q, k, v, len_t)
    err = compare("decode timing shape", out,
                  decode_attention_ref(q, k, v, len_t), 2e-2)
    ms, call_ms, _ = timed(lambda: da_ops.decode_attention(q, k, v, len_t),
                           200)
    plain = device_ms(lambda: decode_attention_ref(q, k, v, len_t),
                      50 if T <= 4096 else 5)
    L = min(length, T)
    library, library_call, _ = timed(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k[:, :, :L], v[:, :, :L], enable_gqa=True), 200)
    elt = q.element_size()
    nbytes = elt * (2 * B * H * hd + 2 * B * Hkv * L * hd) + 4
    b_ms, b_by = bound(nbytes, 4 * B * H * L * hd, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=library, call_ms=call_ms,
                library_call_ms=library_call)


def time_ssd(case, dtype, device, var, iters=20):
    """One ssd_scan variant at `case`, launched directly (so a variant can
    be timed outside its dispatch, as the fma kernel in bf16 for the
    earlier time), against that variant's plain version."""
    b, s, h, p, n, q, _ = case
    x, dt, A, B, C = ssd_inputs(case, dtype, device, seed=1)
    y = ssd_ops._launch(var, x, dt, A, B, C, q)
    err = compare("ssd timing shape", y, ssd_ops.PLAIN[var](x, dt, A, B, C, q),
                  SSD_TOL["f32" if dtype == torch.float32 else "bf16"])
    ms, call_ms, parts = timed(
        lambda: ssd_ops._launch(var, x, dt, A, B, C, q), iters)
    plain = device_ms(lambda: ssd_ops.PLAIN[var](x, dt, A, B, C, q), 5)
    elt = x.element_size()
    nbytes = elt * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h)
    nc = s // q
    # per (b, head, chunk) C . S^T and (weighted x)^T B (2 q p n each) and
    # the lower triangle of L x; per (b, chunk) the lower triangle of one
    # C B^T shared by the heads
    flops = b * h * nc * (4 * q * p * n + q * (q + 1) * p) \
        + b * nc * q * (q + 1) * n
    b_ms, b_by = bound(nbytes, flops, dtype)
    # no single PyTorch call computes the SSD scan
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, call_ms=call_ms,
                kernels_ms={k: round(v, 5) for k, v in parts.items()})


def time_flash(case, dtype, device, var, iters=50):
    B, H, Hkv, S, _, hd, causal, window = case
    q, k, v = flash_inputs(case, dtype, device, seed=1)
    out = fa_ops._launch(var, q, k, v, True, 0)
    err = compare("flash timing shape", out, fa_ops.PLAIN[var](q, k, v),
                  TOL_LONG_F32 if dtype == torch.float32 else TOL["bf16"])
    ms, call_ms, _ = timed(lambda: fa_ops._launch(var, q, k, v, True, 0),
                           iters)
    plain = device_ms(lambda: fa_ops.PLAIN[var](q, k, v), max(5, iters // 5))
    library, library_call, _ = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters)
    elt = q.element_size()
    nbytes = elt * (2 * B * H * S * hd + 2 * B * Hkv * S * hd)
    flops = 4 * B * H * hd * S * (S + 1) // 2        # visible (q, k) pairs
    b_ms, b_by = bound(nbytes, flops, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=library, call_ms=call_ms,
                library_call_ms=library_call)


def decode_split_neighbours(case, device) -> None:
    """decode_attention's device time at the split count ops.num_splits
    picks for `case` and at one split fewer and more: the rule against its
    neighbours."""
    B, H, Hkv, T, hd = case[:5]
    q, k, v, len_t = decode_inputs(case, torch.bfloat16, device, seed=1)
    rep = H // Hkv
    units = B * Hkv * -(-rep // da_ops.heads_per_block(rep, q.dtype))
    rule = da_ops.num_splits(units, T, da_ops.ring_bytes(hd, q.dtype),
                             _build.sm_count(device))
    times = {sp: device_ms(lambda: da_ops._launch(q, k, v, len_t, 0,
                                                  splits=sp), 100)
             for sp in (rule - 1, rule, rule + 1) if sp >= 1}
    log("timing", f"decode_attention bf16 (B,H,Hkv,T,hd,len)={case[:6]} "
        f"device ms by splits: {times}; the rule picks {rule}")


def decode_and_ssd_timings(device, dec_len: int) -> dict:
    """decode_attention at the serving shape, at the full-context step's
    shape and at DeepSeek-Coder-33B's heads over 16K tokens, each also at
    its neighbouring split counts; the f32 ssd_scan at its main-path shapes
    (S = 256, Mamba2-2.7B and Zamba2-7B) and at Mamba2-2.7B's S = 2048."""
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"decode": time_decode((8, 15, 5, 512, 64, dec_len, 0), bf16,
                                 device)}
    log("timing", f"decode_attention bf16 B=8 H=15 Hkv=5 T=512 hd=64 "
        f"len={dec_len}: {out['decode']}")
    out["decode_2048"] = time_decode(FULL_CONTEXT, bf16, device)
    log("timing", f"decode_attention bf16 B=8 H=15 Hkv=5 T=2048 hd=64 "
        f"len=2001 (the full-context step's): {out['decode_2048']}")
    out["decode_16k"] = time_decode(DEEPSEEK_16K, bf16, device)
    log("timing", f"decode_attention bf16 B=8 H=56 Hkv=8 T=16384 hd=128 "
        f"len=16384 (DeepSeek-Coder-33B's heads): {out['decode_16k']}")
    for case in ((8, 15, 5, 512, 64, dec_len, 0), FULL_CONTEXT,
                 DEEPSEEK_16K):
        decode_split_neighbours(case, device)
    free()
    for key, case in (("ssd_fma_256", MAMBA_256), ("ssd_fma_256_zamba",
                                                   ZAMBA_256),
                      ("ssd_fma_2048", MAMBA_SHAPE)):
        out[key] = time_ssd(case, f32, device, "fma")
        log("timing", f"ssd_scan fma f32 (b,s,h,p,n,chunk)={case[:6]}: "
            f"{out[key]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", f"{kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    log("build", f"{sorted(logs)} built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        (_build.BUILD_DIR / f"{name}.ptxas.log").write_text(text)
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        # ptxas's C751x/C752x notes: it serialized the kernel's wgmma
        serial = [ln for ln in text.splitlines()
                  if "wgmma.mma_async instructions are serialized" in ln]
        log("build", f"{name}: {len(spills)} ptxas lines with spills, "
            f"{len(serial)} with serialized wgmma (log in "
            f"build/torch_kernels/{name}.ptxas.log)")

    t0 = time.perf_counter()
    check_kernels(device)
    log("kernel", f"phase 3 took {time.perf_counter() - t0:.1f} s")

    # -- the main paths: the counters are zeroed before each, read after ---
    paths = {}
    for path, run, needed in (
            ("smollm", smollm_path,
             ("decode_attention.split", "flash_attention.fma",
              "flash_attention.wgmma")),
            ("mamba2", mamba2_path, ("ssd_scan.fma", "ssd_scan.tc")),
            ("hybrid", hybrid_path,
             ("decode_attention.split", "flash_attention.fma",
              "ssd_scan.fma"))):
        t0 = time.perf_counter()
        zero_launches()
        out = run(device)
        paths[path] = read_launches(path, needed)
        if path == "smollm":
            dec_len, full_ctx = out
        free()
        log(path, f"path took {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(p[k] for p in paths.values())
                for k in paths["smollm"]}
    log("timing", f"main-path launches per path: {paths}")

    # -- timings --------------------------------------------------------------
    bf16, f32 = torch.bfloat16, torch.float32
    tim = decode_and_ssd_timings(device, dec_len)
    for length in (1, 200, 512):
        log("timing", f"decode_attention bf16 len={length}: " + str(
            time_decode((8, 15, 5, 512, 64, length, 0), bf16, device)))
    # flash: the wgmma variant at SmolLM's bf16 prefill shape; the fma
    # variant at its own main-path shape (f32, phase 4's S=64) and, for the
    # time before the redesign, at the bf16 prefill shape
    fla = time_flash(SMOLLM_FLASH, bf16, device, "wgmma", iters=50)
    log("timing", f"flash_attention wgmma bf16 B=2 H=15 Hkv=5 S=2048 hd=64 "
        f"causal: {fla}")
    fla_fma = time_flash((2, 15, 5, 64, 64, 64, True, 0), f32, device, "fma",
                         iters=200)
    log("timing", f"flash_attention fma f32 B=2 H=15 Hkv=5 S=64 hd=64 "
        f"causal: {fla_fma}")
    for dtype in (bf16, f32):
        log("timing", f"flash_attention fma {dtype} B=2 H=15 Hkv=5 S=2048 "
            "hd=64 causal (bf16: the time before the redesign): " + str(
                time_flash(SMOLLM_FLASH, dtype, device, "fma", iters=20)))
    log("timing", "flash_attention wgmma bf16 B=1 H=56 Hkv=8 S=2048 hd=128 "
        "causal (DeepSeek-Coder-33B's heads): " + str(time_flash(
            (1, 56, 8, 2048, 2048, 128, True, 0), bf16, device, "wgmma",
            iters=20)))
    # ssd_scan: tc at Mamba2's bf16 prefill shape (three launches)
    ssd = time_ssd(MAMBA_SHAPE, bf16, device, "tc")
    log("timing", f"ssd_scan tc bf16 b=2 s=2048 h=80 p=64 n=128 chunk=128 "
        f"(three launches): {ssd}; library: none (no single PyTorch call "
        "computes the scan)")

    def variant(name, var, source, shape, timing):
        return dict(source=f"src/repro_torch/csrc/{source}",
                    launches=launches[f"{name}.{var}"], shape=shape,
                    **timing)

    fa_vars = {
        "wgmma": variant("flash_attention", "wgmma",
                         "flash_attention_wgmma.cu",
                         "bf16 B=2 H=15 Hkv=5 S=2048 hd=64 causal", fla),
        "fma": variant("flash_attention", "fma", "flash_attention.cu",
                       "f32 B=2 H=15 Hkv=5 S=64 hd=64 causal", fla_fma)}
    ssd_vars = {
        "tc": variant("ssd_scan", "tc", "ssd_scan_tc.cu",
                      "bf16 b=2 s=2048 h=80 p=64 n=128 chunk=128", ssd),
        "fma": variant("ssd_scan", "fma", "ssd_scan.cu",
                       "f32 b=2 s=256 h=80 p=64 n=128 chunk=128",
                       tim["ssd_fma_256"])}
    ssd_vars["fma"]["at_s2048"] = tim["ssd_fma_2048"]
    ssd_vars["fma"]["zamba2_s256"] = tim["ssd_fma_256_zamba"]
    da_vars = {"split": variant("decode_attention", "split",
                                "decode_attention.cu",
                                f"bf16 B=8 H=15 Hkv=5 T=512 hd=64 "
                                f"len={dec_len}", tim["decode"])}
    da_vars["split"]["full_context_shape"] = tim["decode_2048"]
    da_vars["split"]["deepseek_16k"] = tim["decode_16k"]
    da_vars["split"]["full_context_step"] = full_ctx
    kernels = [
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:67",
             launches=launches["decode_attention.split"], **tim["decode"],
             variants=da_vars),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention_wgmma.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:88",
             launches=sum(v["launches"] for v in fa_vars.values()), **fla,
             variants=fa_vars),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan_tc.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:76",
             launches=sum(v["launches"] for v in ssd_vars.values()), **ssd,
             variants=ssd_vars),
    ]
    log("done", f"chip_smoke took {time.perf_counter() - t_start:.1f} s "
        "after start-up")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
