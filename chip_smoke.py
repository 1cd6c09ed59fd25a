#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA source in src/repro_torch/csrc, one nvcc each, in
     parallel;
  3. each kernel against its plain PyTorch version on the card, over the
     reference's test shapes and SmolLM-360M's shapes, f32 and bf16;
  4. SmolLM-360M at full width in f32: token-by-token decode_step logits
     (decode kernel) against the forward pass (flash kernel), within 2e-3;
  5. serving: SmolLM-360M at full width in bf16, 8 slots, 16 requests;
  6. timings at the main path's shapes: kernel, plain version, and one
     PyTorch library call as a yardstick (the port never calls it).
Phases 4 and 5 are the main path: the launch counters are zeroed just
before phase 4 and read just after phase 5, and every kernel must have
launched there.  The last two lines are a JSON object of per-kernel
numbers and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params)
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor-core bf16
              torch.float32: 67e12}       # f32 outside the tensor cores
DT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 2e-5, "bf16": 2e-2}         # tests/test_kernels.py
TOL_LONG_F32 = 1e-4                       # f32 at S >= 2000: longer sums

# (B, H, Hkv, T, hd, length, window): the reference's DA_SHAPES, then
# SmolLM-360M serving (8 slots, max_seq 512), length > T included
DECODE_CASES = [
    (2, 4, 4, 128, 32, 100, 0), (1, 8, 2, 256, 64, 256, 0),
    (2, 4, 1, 64, 32, 1, 0), (1, 4, 4, 160, 32, 130, 0),
    (1, 4, 2, 256, 32, 200, 96),
    (8, 15, 5, 512, 64, 1, 0), (8, 15, 5, 512, 64, 200, 0),
    (8, 15, 5, 512, 64, 512, 0), (8, 15, 5, 512, 64, 700, 0),
    (8, 15, 5, 512, 64, 700, 128),
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
]


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
                f"{case}: max_abs_err {err:.3g} (tol {TOL[dname]})")
        for case in FLASH_CASES:
            q, k, v = flash_inputs(case, dtype, device)
            causal, window = case[6], case[7]
            out = fa_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                              window=window)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            tol = TOL_LONG_F32 if dname == "f32" and case[3] >= 2000 \
                else TOL[dname]
            err = compare(f"flash {case} {dname}", out, ref, tol)
            log("kernel", f"flash_attention {dname} (B,H,Hkv,Sq,Sk,hd,causal,"
                f"win)={case}: max_abs_err {err:.3g} (tol {tol})")


# ---------------------------------------------------------------------------
# phase 4: full width, decode against forward
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


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# phase 6: timings
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


def time_flash(case, dtype, device, iters=50):
    B, H, Hkv, S, _, hd, causal, window = case
    q, k, v = flash_inputs(case, dtype, device, seed=1)
    out = fa_ops.flash_attention_bhsd(q, k, v, causal=causal)
    err = compare("flash timing shape", out, attention_ref(q, k, v),
                  TOL_LONG_F32 if dtype == torch.float32 else TOL["bf16"])
    ms = cuda_ms(lambda: fa_ops.flash_attention_bhsd(q, k, v), iters)
    plain = cuda_ms(lambda: attention_ref(q, k, v), max(5, iters // 5))
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
        log("build", f"{name}: {len(spills)} ptxas lines with spills "
            f"(log in build/torch_kernels/{name}.ptxas.log)")

    check_kernels(device)

    # -- the main path: phases 4 and 5 ----------------------------------------
    da_ops.launches = fa_ops.launches = 0
    base = get_config("smollm-360m").scaled(attn_impl="pallas")
    cfg32 = base.scaled(dtype="float32")
    params32 = init_params(cfg32, seed=0, device=device)
    n_params = sum(t.numel() for t in leaves(params32))
    err = decode_vs_forward(cfg32, params32, device)
    log("decode-vs-forward", f"smollm-360m full width ({n_params} "
        f"params) f32 B=2 S=64: max_abs_err {err:.3g} (tol 2e-3)")

    cfg16 = base.scaled(dtype="bfloat16")
    params16 = init_params(cfg16, seed=0, device=device)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in leaves(params16))
    requests = make_requests(cfg16.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng, wall, step_s = serve(cfg16, params16,
                              ServeConfig(slots=8, max_seq=512), requests,
                              device)
    launches = {"decode_attention": da_ops.launches,
                "flash_attention": fa_ops.launches}
    outs = [eng.finished[r.rid].output for r in requests
            if r.rid in eng.finished]
    generated = sum(len(o) for o in outs)
    if len(outs) != len(requests):
        raise AssertionError(f"{len(outs)}/{len(requests)} requests finished")
    for o in outs:
        if not (1 <= len(o) <= 32 and all(0 <= t < cfg16.vocab_size
                                          for t in o)):
            raise AssertionError(f"bad output {o}")
    steps = len(step_s)
    log("serve", f"smollm-360m full width bf16 ({weight_bytes} B "
        f"of weights), 8 slots, max_seq 512: "
        f"{len(outs)}/{len(requests)} requests finished, {generated} tokens "
        f"generated in {steps} steps, {wall:.3f} s")
    log("serve", f"{generated / wall:.1f} generated tokens/s, "
        f"{8 * steps / wall:.1f} slot-steps/s, p50 step "
        f"{1e3 * float(np.median(step_s)):.3f} ms, p99 step "
        f"{1e3 * float(np.percentile(step_s, 99)):.3f} ms, shared pos "
        f"{int(eng.cache['pos'])}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    log("serve", f"main-path launches (phases 4-5): {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # kernel engine against the plain (eager) engine, f32, same requests
    small = make_requests(cfg32.vocab_size, n=2, lo=16, hi=16, new=8, seed=1)
    kern, _, _ = serve(cfg32, params32, ServeConfig(slots=2, max_seq=64),
                       small, device)
    plain_small = make_requests(cfg32.vocab_size, n=2, lo=16, hi=16, new=8,
                                seed=1)
    plain, _, _ = serve(cfg32.scaled(attn_impl="xla"), params32,
                        ServeConfig(slots=2, max_seq=64), plain_small, device)
    k_out = {r: q.output for r, q in kern.finished.items()}
    p_out = {r: q.output for r, q in plain.finished.items()}
    if k_out != p_out:
        raise AssertionError(f"kernel engine {k_out} != plain {p_out}")
    log("serve", f"f32 kernel engine tokens == plain engine tokens: {k_out}")

    # -- timings --------------------------------------------------------------
    dec_len = min(int(eng.cache["pos"]), 512)
    dec = time_decode((8, 15, 5, 512, 64, dec_len, 0), torch.bfloat16, device)
    fla = time_flash((2, 15, 5, 64, 64, 64, True, 0), torch.float32, device,
                     iters=200)
    log("timing", f"decode_attention bf16 B=8 H=15 Hkv=5 T=512 hd=64 "
        f"len={dec_len}: {dec}")
    log("timing", f"flash_attention f32 B=2 H=15 Hkv=5 S=64 hd=64 causal: "
        f"{fla}")
    for length in (1, 200, 512):
        log("timing", f"decode_attention bf16 len={length}: " + str(
            time_decode((8, 15, 5, 512, 64, length, 0), torch.bfloat16,
                        device)))
    for dtype in (torch.bfloat16, torch.float32):
        log("timing", f"flash_attention {dtype} B=2 H=15 Hkv=5 S=2048 hd=64 "
            "causal: " + str(time_flash((2, 15, 5, 2048, 2048, 64, True, 0),
                                        dtype, device, iters=20)))

    kernels = [
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:67",
             launches=launches["decode_attention"], **dec),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:88",
             launches=launches["flash_attention"], **fla),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
