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
     same function (the port never calls it).
Phases 4-5, 6 and 7 are the three main paths.  The launch counters are
zeroed just before each and read just after it; every kernel variant of a
path must have launched there, and the JSON line's `launches` is a
kernel's sum over the three (one ssd_scan tc call is three launches).
The last two lines are a JSON object of per-kernel numbers, with a
`variants` entry per kernel, and {"ok": true, "device": {...}}.
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
]
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
]
MAMBA_SHAPE = (2, 2048, 80, 64, 128, 128, False)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


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


def check_kernels(device) -> None:
    for dname, dtype in DT.items():
        for case in DECODE_CASES:
            q, k, v, length = decode_inputs(case, dtype, device)
            window = case[-1]
            out = da_ops.decode_attention(q, k, v, length, window=window)
            ref = decode_attention_ref(q, k, v, length, window=window)
            torch.cuda.synchronize()
            err = compare(f"decode {case} {dname}", out, ref, TOL[dname])
            log("kernel", f"decode_attention {dname} (B,H,Hkv,T,hd,len,win)="
                f"{case}: max_abs_err {err:.3g} "
                f"(rtol = atol = {TOL[dname]})")
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
    da_ops.launches = 0
    fa_ops.zero_launches()
    ssd_ops.zero_launches()


def read_launches(path: str, needed) -> dict:
    """Launches per kernel variant ("flash_attention.wgmma", ...) since
    the last zero_launches; every variant in `needed` must have run."""
    got = {"decode_attention.fma": da_ops.launches}
    for name, mod in (("flash_attention", fa_ops), ("ssd_scan", ssd_ops)):
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
    wall, rel, agree = timed_prefill(cfg16, params16, device, seed=3)
    log("prefill", f"smollm-360m full width bf16 B=2 S=2048: "
        f"{1e3 * wall:.3f} ms, {2 * 2048 / wall:.1f} prompt tokens/s; "
        f"against the eager path (bf16 scores, f32 softmax): max |diff| / "
        f"max |logit| {rel:.3g} (limit {PREFILL_REL_LIMIT}), top-1 "
        f"agreement {agree}")
    if rel > PREFILL_REL_LIMIT:
        raise AssertionError(f"prefill kernel vs eager: relative {rel}")
    return dec_len


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


def where_the_time_goes(cfg, params, tokens, S, top=8):
    """One more prefill under torch.profiler: the device's busy time (sum
    of the kernels' times) against the call's wall time, and the kernels
    that take the most.  The profiler slows the host, so the idle share
    printed is an upper bound for an unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens}, cfg, S)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    # kernels only: an operator's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    parts = ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                      for e in sorted(events, key=dev_us, reverse=True)[:top])
    log("prefill", f"{cfg.name} where the time goes (profiled call, "
        f"{wall_ms:.3f} ms wall): device busy {busy_ms:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; top kernels: {parts}")


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
    ms = cuda_ms(lambda: da_ops.decode_attention(q, k, v, len_t), 200)
    plain = cuda_ms(lambda: decode_attention_ref(q, k, v, len_t), 50)
    L = min(length, T)
    library = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k[:, :, :L], v[:, :, :L], enable_gqa=True), 200)
    elt = q.element_size()
    nbytes = elt * (2 * B * H * hd + 2 * B * Hkv * L * hd) + 4
    b_ms, b_by = bound(nbytes, 4 * B * H * L * hd, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=library)


def time_ssd(case, dtype, device, var, iters=20):
    """One ssd_scan variant at `case`, launched directly (so a variant can
    be timed outside its dispatch, as the fma kernel in bf16 for the
    earlier time), against that variant's plain version."""
    b, s, h, p, n, q, _ = case
    x, dt, A, B, C = ssd_inputs(case, dtype, device, seed=1)
    y = ssd_ops._launch(var, x, dt, A, B, C, q)
    err = compare("ssd timing shape", y, ssd_ops.PLAIN[var](x, dt, A, B, C, q),
                  SSD_TOL["f32" if dtype == torch.float32 else "bf16"])
    ms = cuda_ms(lambda: ssd_ops._launch(var, x, dt, A, B, C, q), iters)
    plain = cuda_ms(lambda: ssd_ops.PLAIN[var](x, dt, A, B, C, q), 5)
    elt = x.element_size()
    nbytes = elt * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h)
    nc = s // q
    # per (b, head, chunk) C.(state), (weighted x)^T B and M x; per
    # (b, chunk) one C B^T shared by the heads
    flops = b * h * nc * 3 * 2 * q * q * p + b * nc * 2 * q * q * n
    b_ms, b_by = bound(nbytes, flops, dtype)
    # no single PyTorch call computes the SSD scan
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def time_flash(case, dtype, device, var, iters=50):
    B, H, Hkv, S, _, hd, causal, window = case
    q, k, v = flash_inputs(case, dtype, device, seed=1)
    out = fa_ops._launch(var, q, k, v, True, 0)
    err = compare("flash timing shape", out, fa_ops.PLAIN[var](q, k, v),
                  TOL_LONG_F32 if dtype == torch.float32 else TOL["bf16"])
    ms = cuda_ms(lambda: fa_ops._launch(var, q, k, v, True, 0), iters)
    plain = cuda_ms(lambda: fa_ops.PLAIN[var](q, k, v), max(5, iters // 5))
    library = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters)
    elt = q.element_size()
    nbytes = elt * (2 * B * H * S * hd + 2 * B * Hkv * S * hd)
    flops = 4 * B * H * hd * S * (S + 1) // 2        # visible (q, k) pairs
    b_ms, b_by = bound(nbytes, flops, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=library)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
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
             ("decode_attention.fma", "flash_attention.fma",
              "flash_attention.wgmma")),
            ("mamba2", mamba2_path, ("ssd_scan.fma", "ssd_scan.tc")),
            ("hybrid", hybrid_path,
             ("decode_attention.fma", "flash_attention.fma",
              "ssd_scan.fma"))):
        t0 = time.perf_counter()
        zero_launches()
        out = run(device)
        paths[path] = read_launches(path, needed)
        if path == "smollm":
            dec_len = out
        free()
        log(path, f"path took {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(p[k] for p in paths.values())
                for k in paths["smollm"]}
    log("timing", f"main-path launches per path: {paths}")

    # -- timings --------------------------------------------------------------
    bf16, f32 = torch.bfloat16, torch.float32
    dec = time_decode((8, 15, 5, 512, 64, dec_len, 0), bf16, device)
    log("timing", f"decode_attention bf16 B=8 H=15 Hkv=5 T=512 hd=64 "
        f"len={dec_len}: {dec}")
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
    # ssd_scan: tc at Mamba2's bf16 prefill shape (three launches); fma in
    # f32 at the same shape and, for the time before the redesign, in bf16
    ssd = time_ssd(MAMBA_SHAPE, bf16, device, "tc")
    log("timing", f"ssd_scan tc bf16 b=2 s=2048 h=80 p=64 n=128 chunk=128 "
        f"(three launches): {ssd}; library: none (no single PyTorch call "
        "computes the scan)")
    ssd_fma = time_ssd(MAMBA_SHAPE, f32, device, "fma")
    log("timing", f"ssd_scan fma f32 b=2 s=2048 h=80 p=64 n=128 chunk=128: "
        f"{ssd_fma}")
    log("timing", "ssd_scan fma bf16 b=2 s=2048 h=80 p=64 n=128 chunk=128 "
        "(the time before the redesign): "
        + str(time_ssd(MAMBA_SHAPE, bf16, device, "fma")))

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
                       "f32 b=2 s=2048 h=80 p=64 n=128 chunk=128", ssd_fma)}
    da_vars = {"fma": variant("decode_attention", "fma",
                              "decode_attention.cu",
                              f"bf16 B=8 H=15 Hkv=5 T=512 hd=64 "
                              f"len={dec_len}", dec)}
    kernels = [
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:67",
             launches=launches["decode_attention.fma"], **dec,
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
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
