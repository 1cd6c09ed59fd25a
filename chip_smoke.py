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
     the full-context step's shape, at DeepSeek-Coder-33B's heads over
     a 16384-token cache, at the f32 shapes of phases 4 and 7, and at one
     split fewer and more than its rule picks.  `ms`, `plain_ms` and
     `library_ms` are device time per call (the kernels' durations from
     torch.profiler); `call_ms` is CUDA-event time over back-to-back
     calls, which the host's launch cost bounds at small shapes;
  9. training: SmolLM-360M at full width in bf16 (remat full, eager
     attention, AdamW) on the deterministic token stream, 4 x 2048
     tokens a step, 10 steps: loss and grad_norm per step (finite, the
     last loss below the first), p50 step time, tokens/s, peak memory,
     and one profiled step; the same start with remat "dots" (2 steps:
     step 1's loss identical, grad_norm within 1e-3) and with Adafactor
     (3 steps, the reference's factored-stat shapes); then one f32 step
     of its widths cut to 2 layers on the card against the same step on
     the CPU, for microbatches 1 and 2 and with int8 grad compression;
 10. the checkpoint store (the Paxos-replicated datastore on the host's
     simulator, holding the card's tensors): (a) with storage node 2
     crashed, commit the parameters phase 9(a) trained (SmolLM-360M at
     full width: bf16 weights, f32 norm scales) and print bytes, chunks,
     wall seconds, MB/s, sim.now and the host's RSS and max RSS, then
     the share of repr in a 16 MB commit under cProfile; (b) restore
     them by strong read into a tree from another seed on the card,
     every leaf equal; (c) engine A (8 slots, max_seq 512, refresh every
     8 batches, the store, end token id 0) serves phase 5's 16 requests
     on another seed's weights, then, after sim.run_for(2.0), 16 more,
     and must refresh to the commit through a timeline read; engine B,
     with no store, runs the same requests with its params set to the
     committed tensors at the same batch, and the tokens and KV caches of
     A and B must be equal (the shared cache position makes order
     matter); (d) a
     zombie copy of the store, whose manifest version a newer commit
     made stale, must be fenced by StaleTrainerError; (e) the reference
     example's ft-demo trainer (4 layers, d 128, vocab 2048, f32, AdamW
     lr 1e-3, seq 64 x batch 8) on the card: 10 steps, a commit, 5
     steps; the whole train state restored by strong read into a state
     from another seed and the same 5 steps, with losses and every leaf
     equal, under torch.use_deterministic_algorithms
     (CUBLAS_WORKSPACE_CONFIG is set before the first cuBLAS call);
     without it, two resumes and five embedding gradients are compared
     and reported;
 11. the moe family and int8 weights (Phi-3.5-MoE, Kimi-K2): (a)
     Phi-3.5-MoE at full width cut to 2 layers, f32, weights drawn with
     numpy from a seed and carried over by params_from_numpy: a B=2, S=64
     forward through flash fma against the eager path and the CPU's
     forward on the same weights (2e-4; routes that differ between card
     and CPU counted), then 16 decode steps through the split kernel
     against the eager decode (2e-4); (b) Phi-3.5-MoE at full width and
     full depth with int8 weights (`init_quantized_params`, one layer at
     a time) and bf16 activations: its weight bytes against bf16's,
     phase 5's 16 requests served (8 slots, max_seq 512), one step from
     the served cache against the eager path (0.1 of the largest logit),
     then the int8 wk/wv codes and scales and the f32 router of all 32
     layers (new draws) committed to the checkpoint store and taken in
     by a timeline refresh: bit-equal, and the tokens and caches of a
     directly swapped engine; (c) its bf16 prefill of B=2 x 2048 tokens
     through flash wgmma: prompt tokens/s, against the eager path, and a
     profile split into dequantisation, expert GEMMs, dispatch and
     attention; (d) Kimi-K2 at full width cut to 1 layer, dense bf16: a
     B=1, S=256 forward through flash wgmma and 8 decode steps at B=8
     through the split kernel, each against the eager path;
 12. the paper's §9 workload engine (`repro_torch.workload`, the op
     stream sampled on the card, the cluster on the host's simulator):
     (a) an OpStream over 10,000,000 zipfian keys (theta 0.99, a 40 MB
     f32 CDF on the card): sampled ops/s at batch 8192 with and without
     the copy to the host, the rank-1 key's share over 2^20 ops within
     5 % of 1/H, and the card's transform against the CPU's on the same
     2^20 uniforms (ranks, ops, sizes exact; gaps rtol 1e-6); (b) Fig. 8
     at the reference bench's --quick configuration (1000 keys, 16
     clients, 3 s; `benchmarks/spinnaker_bench.py` base_spec/base_cfg):
     Spinnaker strong and timeline, Cassandra quorum and eventual, each
     arm's p50/p99, throughput, host seconds, simulated ops per host
     second and seconds in `OpStream._refill`, then the three claim
     ratios held to the envelope (read/quorum <= 1.05, write p50 <= 1.30,
     throughput >= 0.95); (c) Fig. 9 at --quick: range 0's leader killed
     at 2 s, restarted at 6 s of 8; writes must resume, and the recovery
     window is printed.
Phase 3 also checks, and phase 8 times, phase 11's attention shapes:
Phi-3.5-MoE's 32/8 heads at hd 128 (bf16 decode over 8 x 512 cached
tokens, the bf16 2048-token prefill, and the f32 shapes of 11(a)) and
Kimi-K2's 64/8 heads at hd 128 in bf16.
Phase 5 ends with a full-context SmolLM-360M decode step: bf16, 8 slots
of a 2048-token cache filled with seeded random K/V, position 2000; 32
steps timed, one profiled (device busy, idle share, decode_attention's
share), the first step's logits against the eager path.
Phases 4-5, 6 and 7 are the three serving main paths, phase 9 the
training path, phase 10 the store path (commit, restore, serve with
refresh, resume), phase 11 the moe path, phase 12 the workload path.
The launch counters are zeroed just before each and read just after it;
every kernel variant of a serving path must have launched there,
decode_attention on the store path's engine, decode and both flash
variants on the moe path, and none on the training path (the kernels
are forward-only, so training takes the eager attention path, as the
reference's does) or on the workload path (no model runs there).  The
JSON line's `launches` is a kernel's sum over the paths (one ssd_scan
call of either variant is three launches).  The last two lines are a
JSON object of per-kernel numbers, with a `variants` entry per kernel,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import cProfile
import gc
import json
import os
import pstats
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import (SpinnakerCheckpointStore,  # noqa: E402
                                    StaleTrainerError, StoreConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.dist.compression import quantize_codes  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params, prefill)
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import dense_init  # noqa: E402
from repro_torch.models.model import init_quantized_params  # noqa: E402
from repro_torch.models.quant import is_quantized, quantize_weight  # noqa
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from repro_torch.train.optim import OptimizerConfig  # noqa: E402
from repro_torch.train.step import (TrainConfig,  # noqa: E402
                                    init_train_state, loss_and_grads,
                                    make_train_step)
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,  # noqa: E402
                              tree_map)
from repro_torch.workload import (ExperimentConfig,  # noqa: E402
                                  WorkloadSpec, run_cassandra_workload,
                                  run_spinnaker_workload)
from repro_torch.workload import generators as wl_gen  # noqa: E402

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
    # phase 11: Phi-3.5-MoE serving (8 x 512, mid length) and 11(a)'s f32
    # decode (B=2, T=16, lengths 1..16); Kimi-K2's 64/8 heads (11(d))
    (8, 32, 8, 512, 128, 256, 0), (2, 32, 8, 16, 128, 8, 0),
    (8, 64, 8, 16, 128, 8, 0),
]
DEEPSEEK_16K = (8, 56, 8, 16384, 128, 16384, 0)
# the full-context decode step's attention: 8 slots x 2048, length 2001
FULL_CONTEXT = (8, 15, 5, 2048, 64, 2001, 0)
# the f32 decode steps of the decode-vs-forward phases, at half their
# cache (each runs lengths 1..T): SmolLM-360M's B=2 T=64 (phase 4),
# Zamba2-7B's shared attention B=2 T=256 (phase 7)
DECODE_F32_SMOLLM = (2, 15, 5, 64, 64, 32, 0)
DECODE_F32_ZAMBA = (2, 32, 32, 256, 112, 128, 0)
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
    # phase 11: Phi-3.5-MoE's prefill (11(c)) and 11(a)'s f32 forward;
    # Kimi-K2's forward (11(d))
    (2, 32, 8, 2048, 2048, 128, True, 0), (2, 32, 8, 64, 64, 128, True, 0),
    (1, 64, 8, 256, 256, 128, True, 0),
]
PHI_DECODE, PHI_DECODE_F32, KIMI_DECODE = DECODE_CASES[-3:]
PHI_FLASH, PHI_FLASH_F32, KIMI_FLASH = FLASH_CASES[-3:]
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


def drain(eng, on_batch=None) -> list[float]:
    """Step `eng` until its queue and slots are empty; returns each step's
    host seconds (ending in a synchronise).  `on_batch(eng)` runs after
    every step."""
    step_s = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        ts = time.perf_counter()
        eng.step_batch()                 # ends in a host copy of the argmax
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        if on_batch is not None:
            on_batch(eng)
        if len(step_s) > 10_000:
            raise RuntimeError("serving did not drain")
    return step_s


def serve(cfg, params, scfg, requests, device):
    eng = ServingEngine(cfg, params, scfg, device=device)
    for r in requests:
        eng.submit(r)
    t0 = time.perf_counter()
    step_s = drain(eng)
    return eng, time.perf_counter() - t0, step_s


def report_serving(name, eng, requests, wall, step_s, weight_bytes, vocab,
                   new=32, what="full width bf16") -> dict:
    """Check that every request finished with 1..new valid tokens, and
    print and return the serving metrics."""
    outs = [eng.finished[r.rid].output for r in requests
            if r.rid in eng.finished]
    if len(outs) != len(requests):
        raise AssertionError(f"{len(outs)}/{len(requests)} requests finished")
    for o in outs:
        if not (1 <= len(o) <= new and all(0 <= t < vocab for t in o)):
            raise AssertionError(f"bad output {o}")
    generated = sum(len(o) for o in outs)
    steps, slots = len(step_s), eng.scfg.slots
    log("serve", f"{name} {what} ({weight_bytes} B of weights), "
        f"{slots} slots, max_seq {eng.scfg.max_seq}: {len(outs)}/"
        f"{len(requests)} requests finished, {generated} tokens generated "
        f"in {steps} steps, {wall:.3f} s")
    log("serve", f"{name}: {generated / wall:.1f} generated tokens/s, "
        f"{slots * steps / wall:.1f} slot-steps/s, p50 step "
        f"{1e3 * float(np.median(step_s)):.3f} ms, p99 step "
        f"{1e3 * float(np.percentile(step_s, 99)):.3f} ms, shared pos "
        f"{int(eng.cache['pos'])}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    return dict(finished=len(outs), submitted=len(requests),
                generated=generated, steps=steps,
                tokens_per_s=generated / wall,
                p50_ms=1e3 * float(np.median(step_s)),
                p99_ms=1e3 * float(np.percentile(step_s, 99)),
                max_memory_allocated=torch.cuda.max_memory_allocated())


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
    n_params = sum(t.numel() for t in tree_leaves(params32))
    err = decode_vs_forward(cfg32, params32, device)
    log("decode-vs-forward", f"smollm-360m full width ({n_params} "
        f"params) f32 B=2 S=64: max_abs_err {err:.3g} "
        "(rtol = atol = 2e-3)")

    cfg16 = base.scaled(dtype="bfloat16")
    params16 = init_params(cfg16, seed=0, device=device)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params16))
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
    largest first, [(operator, its own kernels' ms, count)] largest
    first).  The profiler slows the host, so 1 - busy / wall is an upper
    bound for the idle share of an unprofiled call."""
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
    ops = sorted(((e.key, dev_us(e) / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and dev_us(e) > 0),
                 key=lambda kv: kv[1], reverse=True)
    return wall_ms, sum(ms for _, ms, _ in kernels), kernels, ops


def where_the_time_goes(cfg, params, tokens, S, top=8):
    """One more prefill under torch.profiler: the device's busy time
    against the call's wall time, and the kernels that take the most."""
    wall_ms, busy_ms, kernels, _ = profile_call(
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
    wall_ms, busy_ms, kernels, _ = profile_call(
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
    n_params = sum(t.numel() for t in tree_leaves(params32))
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
                       for t in tree_leaves(params16))
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
                    for t in tree_leaves(eng.cache["ssm"]))
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
    n_params = sum(t.numel() for t in tree_leaves(params))
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
    for key, case, what in (("decode_f32_t64", DECODE_F32_SMOLLM,
                             "phase 4's, SmolLM-360M, 2048 launches"),
                            ("decode_f32_t256", DECODE_F32_ZAMBA,
                             "phase 7's, Zamba2-7B widths, 512 launches")):
        out[key] = time_decode(case, f32, device)
        log("timing", f"decode_attention f32 (B,H,Hkv,T,hd,len)={case[:6]} "
            f"({what}, lengths 1..T; timed at T/2): {out[key]}")
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


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 10
# card against CPU, f32 with TF32 off: the reference's own limits
# (tests/test_elastic_and_microbatch.py:33-38 for the new params)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_PARAM_TOL = 1e-5, 1e-4, 2e-5


def clone(tree):
    return tree_map(torch.clone, tree)


def train_steps(cfg, tcfg, state, batches, timed=False):
    """Run `batches` through train_step from `state` (donated).  Returns
    (state, losses, grad_norms, per-step seconds, host clock around each
    step ending in a synchronise)."""
    step = make_train_step(cfg, tcfg)
    losses, gnorms, secs = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if timed:
            log("train", f"step {int(m['step'])}: loss {losses[-1]:.6f} "
                f"grad_norm {gnorms[-1]:.6f} ({1e3 * secs[-1]:.3f} ms)")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"non-finite loss or grad_norm: {losses} "
                             f"{gnorms}")
    return state, losses, gnorms, secs


def adafactor_shapes_ok(params, stats) -> int:
    """The reference's factored stats (optim.py:101-110): vr over
    shape[:-1] and vc over shape[:-2] + shape[-1:] where both trailing
    dims are >= 128, else a full v.  Returns the factored leaves."""
    def check(p, st):
        shape = tuple(p.shape)
        if len(shape) >= 2 and min(shape[-2:]) >= 128:
            want = {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
        else:
            want = {"v": shape}
        got = {k: tuple(v.shape) for k, v in st.items()}
        if got != want or any(v.dtype != torch.float32 for v in st.values()):
            raise AssertionError(f"adafactor stats {got} for a {shape} "
                                 f"leaf, want {want} in f32")
        return "vr" in want
    return sum(tree_leaves(tree_map(check, params, stats)))


def train_path(device):
    """Phase 9 (a)-(c): SmolLM-360M at full width, bf16, remat full, eager
    attention, AdamW at lr 3e-4, wd 0.1, clip 1.0, on 10 batches of the
    deterministic mixture stream (4 x 2048 tokens).  Returns the metrics
    and the parameters (a) trained."""
    cfg = get_config("smollm-360m").scaled(attn_impl="xla",
                                           remat_policy="full")
    opt = OptimizerConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0)
    tcfg = TrainConfig(optimizer=opt)
    B, S = 4, 2048
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=0,
                                    mixture_docs=True), 0)
    batches = [stream.batch_at(s) for s in range(TRAIN_STEPS)]
    start = init_train_state(cfg, tcfg, seed=0, device=device)
    n_params = sum(t.numel() for t in tree_leaves(start["params"]))
    log("train", f"smollm-360m full width ({n_params} params, {cfg.dtype}, "
        f"remat {cfg.remat_policy}, attn {cfg.attn_impl}, AdamW lr {opt.lr} "
        f"wd {opt.weight_decay} clip {opt.grad_clip}), B={B} S={S}, "
        f"{TRAIN_STEPS} steps")

    # (a) 10 steps
    free()
    torch.cuda.reset_peak_memory_stats()
    state, losses, gnorms, secs = train_steps(cfg, tcfg, clone(start),
                                              batches, timed=True)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(secs[1:]))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    wall_ms, busy_ms, kernels, ops = profile_call(
        lambda: make_train_step(cfg, tcfg)(state, batches[0]))
    trained = state["params"]            # phase 10 commits them
    del state
    top = ", ".join(f"{kernel_name(k)} {ms:.3f} ms x{n}"
                    for k, ms, n in kernels[:6])
    parts = ", ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in ops[:10])
    out = dict(p50_ms=1e3 * p50, tokens_per_s=B * S / p50,
               max_memory_allocated=peak, loss_first=losses[0],
               loss_last=losses[-1], profiled_wall_ms=wall_ms,
               busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms))
    log("train", f"(a) loss {losses[0]:.6f} -> {losses[-1]:.6f}; p50 step "
        f"(steps 2-{TRAIN_STEPS}) {out['p50_ms']:.3f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s, max_memory_allocated {peak} "
        f"B; one profiled step {wall_ms:.3f} ms wall, device busy "
        f"{busy_ms:.3f} ms, idle share {out['idle_share']:.3f}; top "
        f"kernels: {top}; operators by their own kernels' device time: "
        f"{parts}")

    # (b) remat "dots" from the same start, 2 steps
    free()
    torch.cuda.reset_peak_memory_stats()
    _, dlosses, dgnorms, _ = train_steps(
        cfg.scaled(remat_policy="dots"), tcfg, clone(start), batches[:2])
    dots_peak = torch.cuda.max_memory_allocated()
    if dlosses[0] != losses[0]:
        raise AssertionError(f"dots step-1 loss {dlosses[0]} != full "
                             f"{losses[0]}")
    rel = abs(dgnorms[0] - gnorms[0]) / gnorms[0]
    if rel > 1e-3:
        raise AssertionError(f"dots grad_norm {dgnorms[0]} vs {gnorms[0]}")
    log("train", f"(b) remat dots: step-1 loss {dlosses[0]:.6f} identical "
        f"to full's; grad_norm {dgnorms[0]:.6f} vs {gnorms[0]:.6f} "
        f"(relative {rel:.3g}, limit 1e-3); max_memory_allocated dots "
        f"{dots_peak} B, full {peak} B")
    out.update(dots_max_memory_allocated=dots_peak)

    # (c) Adafactor, 3 steps
    free()
    acfg = TrainConfig(optimizer=OptimizerConfig(name="adafactor"))
    astate = init_train_state(cfg, acfg, seed=0, device=device)
    astate, alosses, _, _ = train_steps(cfg, acfg, astate, batches[:3])
    factored = adafactor_shapes_ok(astate["params"], astate["opt"]["stats"])
    log("train", f"(c) adafactor 3 steps: losses {alosses}; "
        f"{factored} factored leaves of "
        f"{len(tree_leaves(astate['params']))}, stat shapes as the "
        "reference's")
    del start, astate
    free()
    return out, trained


def train_card_vs_cpu(cfg, device, B, S, seed=0, lr=1e-3) -> dict:
    """One f32 train step (microbatches 1 and 2, and with int8 grad
    compression) from the same state on the card and on the CPU: loss
    within 1e-5 relative, grad_norm within 1e-4, new params within rtol =
    atol = 2e-5.  First the grads themselves: each leaf within 2e-4 of
    its max |g| (the whole-model tolerance), and the int8 round trip of
    the same grads equal on both devices.

    Two mechanisms move a new parameter by more than 2e-5 while the grads
    agree, and each out-of-limit element must be one of them (it is
    counted and its values printed; any other fails): Adam's first step
    is lr * g / (|g| + eps), which turns f32 noise in a near-zero grad
    (|g| <= NEAR_ZERO = 100 eps on both devices) into a visible update;
    and with compression, an int8 code that differs between the card's
    grads and the CPU's (noise across a rounding boundary)."""
    cfg = cfg.scaled(dtype="float32", attn_impl="xla")
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=seed), 0)
    batch = stream.batch_at(0)
    opt = OptimizerConfig(lr=lr)
    host = init_train_state(cfg, TrainConfig(optimizer=opt), seed=seed,
                            device="cpu")
    card = train_state_from_numpy(train_state_to_numpy(host), device)
    near_zero, flips = grads_card_vs_cpu(cfg, card, host, batch,
                                         100 * opt.eps)
    report = {}
    for name, tcfg in (
            ("microbatches 1", TrainConfig(optimizer=opt)),
            ("microbatches 2", TrainConfig(optimizer=opt, microbatches=2)),
            ("grad_compression", TrainConfig(optimizer=opt,
                                             grad_compression=True))):
        step = make_train_step(cfg, tcfg)
        new_c, m_c = step(clone(card), batch)
        new_h, m_h = step(clone(host), batch)
        l_c, l_h = float(m_c["loss"]), float(m_h["loss"])
        g_c, g_h = float(m_c["grad_norm"]), float(m_h["grad_norm"])
        if abs(l_c - l_h) > TRAIN_LOSS_RTOL * abs(l_h):
            raise AssertionError(f"{name}: loss card {l_c} cpu {l_h}")
        if abs(g_c - g_h) > TRAIN_GNORM_RTOL * abs(g_h):
            raise AssertionError(f"{name}: grad_norm card {g_c} cpu {g_h}")
        worst, amplified, flipped = 0.0, 0, 0
        for (path, ph), pc in zip(tree_leaves_with_path(new_h["params"]),
                                  tree_leaves(new_c["params"])):
            pc = pc.cpu()
            err = (pc - ph).abs()
            bad = err > TRAIN_PARAM_TOL + TRAIN_PARAM_TOL * ph.abs()
            worst = max(worst, float(err.max()))
            if not bad.any():
                continue
            explained = near_zero[path]["mask"]
            if tcfg.grad_compression:
                explained = explained | flips[path]
            unexplained = bad & ~explained
            if unexplained.any():
                idx = unexplained.nonzero()[:4].tolist()
                raise AssertionError(
                    f"{name}: elements of {path} outside rtol = atol = "
                    f"{TRAIN_PARAM_TOL} at {idx}, not at a near-zero grad "
                    f"or an int8 code flip: card "
                    f"{pc[unexplained][:4].tolist()} cpu "
                    f"{ph[unexplained][:4].tolist()}")
            n_amp = int((bad & near_zero[path]["mask"]).sum())
            amplified += n_amp
            flipped += int(bad.sum()) - n_amp
            idx = bad.nonzero()[:3]
            grad = near_zero[path]
            log("train", f"(d) {name}: {int(bad.sum())} elements of {path} "
                f"outside the limit ({n_amp} at a near-zero grad), up to "
                f"{float(err[bad].max()):.3g}; e.g. at {idx.tolist()}: new "
                f"param card {[float(pc[tuple(i)]) for i in idx]} cpu "
                f"{[float(ph[tuple(i)]) for i in idx]}, grad card "
                f"{[float(grad['card'][tuple(i)]) for i in idx]} cpu "
                f"{[float(grad['cpu'][tuple(i)]) for i in idx]}")
        report[name] = dict(loss_card=l_c, loss_cpu=l_h, grad_norm_card=g_c,
                            grad_norm_cpu=g_h, max_param_err=worst,
                            at_near_zero_grads=amplified,
                            at_code_flips=flipped)
        log("train", f"(d) {name}: loss card {l_c:.8f} cpu {l_h:.8f}; "
            f"grad_norm card {g_c:.8f} cpu {g_h:.8f}; new params max |card "
            f"- cpu| {worst:.3g} (rtol = atol = {TRAIN_PARAM_TOL}); outside "
            f"it: {amplified} elements at a near-zero grad, {flipped} at an "
            "int8 code flip")
    return report


def grads_card_vs_cpu(cfg, card, host, batch, near):
    """The step's grads on both devices, from the same params and batch:
    each leaf within 2e-4 of its max |g|, and the int8 round trip of the
    CPU's grads equal (codes, values, residuals) on card and CPU.  Returns
    ({leaf path: {"mask": |g| <= near on both, "card", "cpu"}},
    {leaf path: where the int8 codes of the card's own grads differ from
    the CPU's})."""
    hb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, gh = loss_and_grads(host["params"], hb, cfg)
    device = card["step"].device
    _, _, gc = loss_and_grads(card["params"],
                              {k: v.to(device) for k, v in hb.items()}, cfg)
    near_zero, flips, n_near, n_flips, n = {}, {}, 0, 0, 0
    for (path, g_h), g_c in zip(tree_leaves_with_path(gh), tree_leaves(gc)):
        g_cc = g_c.cpu()
        scale = float(g_h.abs().max())
        if float((g_cc - g_h).abs().max()) > 2e-4 * scale:
            raise AssertionError(f"grads of {path} differ between card and "
                                 f"CPU by more than 2e-4 of {scale}")
        near_zero[path] = dict(mask=(g_h.abs() <= near) & (g_cc.abs() <= near),
                               card=g_cc, cpu=g_h)
        deq_h, q_h, res_h = quantize_codes(g_h)
        deq_c, q_c, res_c = quantize_codes(g_h.to(device))
        if not (torch.equal(q_c.cpu(), q_h) and torch.equal(deq_c.cpu(), deq_h)
                and torch.equal(res_c.cpu(), res_h)):
            raise AssertionError(f"int8 round trip of {path} differs between "
                                 "the card and the CPU on the same grads")
        flips[path] = quantize_codes(g_c)[1].cpu() != q_h
        n_near += int(near_zero[path]["mask"].sum())
        n_flips += int(flips[path].sum())
        n += q_h.numel()
    log("train", f"(d) grads: every leaf within 2e-4 of its max |g| on card "
        f"and CPU; {n_near} of {n} elements at |g| <= {near:g} on both; "
        "the int8 round trip of the same grads equal on card and CPU; the "
        f"card's own grads give {n_flips} different int8 codes")
    return near_zero, flips

# ---------------------------------------------------------------------------
# phase 10: commit, restore, serve with refresh; trainer crash and resume
# ---------------------------------------------------------------------------


def max_rss() -> int:
    """The host process's peak resident set so far, in bytes (Linux
    reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss() -> int:
    """The host process's resident set now, in bytes (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def trees_equal(a, b) -> bool:
    """Same leaf names, dtypes and values (`torch.equal`)."""
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def repr_share(leaf) -> tuple[float, float]:
    """One leaf committed to a fresh store under cProfile: the share of
    the profiled host time spent in `repr` (the journal's `record_digest`
    renders every log record, chunk bytes included, on every replica),
    and that time in seconds.  cProfile slows Python calls, not repr."""
    store = SpinnakerCheckpointStore(StoreConfig())
    prof = cProfile.Profile()
    prof.runcall(store.save, 1, {"leaf": leaf})
    stats = pstats.Stats(prof)
    in_repr = sum(v[2] for k, v in stats.stats.items()
                  if k[2] == "<built-in method builtins.repr>")
    return in_repr / stats.total_tt, stats.total_tt


@contextlib.contextmanager
def deterministic_algorithms():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def serve_two_waves(eng, between, on_batch,
                    **req_kw) -> tuple[list, float, list]:
    """Phase 5's 16 requests (or `make_requests(**req_kw)`), drained;
    `between()`; as many more from another seed, drained.  Returns
    (requests, wall seconds, per-step seconds)."""
    first = make_requests(eng.cfg.vocab_size, **req_kw)
    second = make_requests(eng.cfg.vocab_size, **{**req_kw, "seed": 1})
    for r in second:
        r.rid += len(first)
    step_s = []
    t0 = time.perf_counter()
    for i, wave in enumerate((first, second)):
        if i:
            between()
        for r in wave:
            eng.submit(r)
        step_s += drain(eng, on_batch)
    return first + second, time.perf_counter() - t0, step_s


def commit_restore_serve(device, store, params) -> dict:
    """Phase 10 (a)-(d) over SmolLM-360M's full-width parameters, the ones
    phase 9(a) trained (bf16 weights, f32 norm scales)."""
    cfg = get_config("smollm-360m").scaled(attn_impl="pallas")
    nbytes = tree_bytes(params)

    # (a) commit at full width with storage node 2 down
    store.crash_storage_node(2)
    store.sim.run_for(3.0)
    rss_before, max_rss_before = rss(), max_rss()
    t0 = time.perf_counter()
    manifest = store.save(10, params)
    commit_s = time.perf_counter() - t0
    if store.latest_step() != 10:
        raise AssertionError("the commit at step 10 is not the manifest's")
    chunks = sum(e["nchunks"] for e in manifest["index"])
    out = dict(bytes=nbytes, chunks=chunks, commit_s=commit_s,
               commit_mb_per_s=nbytes / commit_s / 1e6,
               sim_now_after_commit=store.sim.now,
               rss_before_commit=rss_before, rss_after_commit=rss(),
               max_rss_before_commit=max_rss_before,
               max_rss_after_commit=max_rss())
    log("store", f"(a) smollm-360m full width: {len(manifest['index'])} "
        f"leaves, {nbytes} B in {chunks} chunks of {store.cfg.chunk_bytes} B "
        f"committed with storage node 2 down in {commit_s:.3f} s wall, "
        f"{out['commit_mb_per_s']:.3f} MB/s; sim.now {store.sim.now:.6f} s; "
        f"host RSS {rss_before} B before the commit, "
        f"{out['rss_after_commit']} B after (max RSS {max_rss_before} B "
        f"before, {out['max_rss_after_commit']} B after)")
    leaf = params["embed"][:8192]
    share, total = repr_share(leaf)
    out.update(repr_share=share)
    log("store", f"(a) where a commit's host time goes: "
        f"{leaf.numel() * leaf.element_size()} B of embed committed under "
        f"cProfile in {total:.3f} s, {share:.3f} of it in repr")

    # (b) strong restore into a fresh tree on the card from another seed
    like = init_params(cfg, seed=1, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, restored = store.restore_tree(like)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    del like
    if step != 10 or not trees_equal(restored, params) or any(
            t.device.type != device.type for t in tree_leaves(restored)):
        raise AssertionError("the strong restore differs from the commit")
    del restored
    log("store", f"(b) strong restore of step {step} into a seed-1 tree on "
        f"the card: {out['restore_s']:.3f} s wall, "
        f"{nbytes / out['restore_s'] / 1e6:.3f} MB/s; every leaf equal to "
        "the committed one, dtypes the same")

    # (c) engine A refreshes from the store with timeline reads while
    # serving; engine B, with no store, swaps in the committed tensors at
    # the same batch
    start = init_params(cfg, seed=2, device=device)
    # ten steps of training make the stream's EOS (id 1) every prompt's
    # greedy first token; the end token here is id 0, which the stream
    # never holds, so each request decodes its 32 tokens
    scfg = ServeConfig(slots=8, max_seq=512, refresh_every_batches=8,
                       eos_id=0)
    eng_a = ServingEngine(cfg, start, scfg, store=store, device=device)
    refreshed_at = []

    def watch(eng):
        if eng.weights_step == 10 and not refreshed_at:
            refreshed_at.append(eng.batches_run)
    torch.cuda.reset_peak_memory_stats()
    reqs_a, wall, step_s = serve_two_waves(
        eng_a, lambda: store.sim.run_for(2.0), watch)
    if not refreshed_at:
        raise AssertionError(f"engine A did not refresh to step 10 "
                             f"(weights_step {eng_a.weights_step})")
    at = refreshed_at[0]
    report_serving("smollm-360m refreshed from the store", eng_a, reqs_a,
                   wall, step_s, nbytes, cfg.vocab_size)
    if not trees_equal(eng_a.params, params):
        raise AssertionError("engine A's refreshed params differ from the "
                             "commit")

    def swap(eng):
        if eng.batches_run == at:
            eng.params = params
    eng_b = ServingEngine(cfg, start, scfg, device=device)
    reqs_b, _, step_b = serve_two_waves(eng_b, lambda: None, swap)
    toks_a = {r.rid: r.output for r in reqs_a}
    toks_b = {r.rid: r.output for r in reqs_b}
    if toks_a != toks_b:
        bad = [rid for rid in toks_a if toks_a[rid] != toks_b[rid]]
        raise AssertionError(f"engine A's tokens differ from engine B's for "
                             f"requests {bad}")
    # the trained weights give few distinct tokens; the caches hold every
    # step's K/V, so equal caches show equal computation throughout
    if not trees_equal(eng_a.cache, eng_b.cache):
        raise AssertionError("engine A's KV cache differs from engine B's")
    out.update(refresh_batch=at, refresh_step_ms=1e3 * step_s[at - 1],
               serve_p50_ms=1e3 * float(np.median(step_s)),
               no_store_p50_ms=1e3 * float(np.median(step_b)))
    distinct = len({t for o in toks_a.values() for t in o})
    log("store", f"(c) engine A refreshed to step 10 through a timeline "
        f"read at batch {at} (that step {out['refresh_step_ms']:.3f} ms); "
        f"its {len(toks_a)} requests' tokens ({distinct} distinct ids) and "
        f"its KV cache equal engine B's, whose params were swapped to the "
        f"committed tensors at batch {at}; p50 step A {out['serve_p50_ms']:.3f} ms, "
        f"B {out['no_store_p50_ms']:.3f} ms")
    del eng_a, eng_b, start

    # (d) a zombie trainer with a stale manifest version is fenced out
    zombie = object.__new__(SpinnakerCheckpointStore)
    zombie.__dict__.update(store.__dict__)    # its view: step 10's version
    tiny = {"final_norm": params["final_norm"]}
    store.save(11, tiny)                      # the live trainer moves on
    try:
        zombie.save(12, tiny)
    except StaleTrainerError as e:
        fenced = str(e)
    else:
        raise AssertionError("the zombie's commit was not fenced")
    if store.latest_step() != 11:
        raise AssertionError("the zombie moved the manifest")
    log("store", f"(d) zombie (manifest v{zombie._manifest_version}) "
        f"fenced: {fenced}; the manifest stays at step 11")
    return out


FT_DEMO = ModelConfig(name="ft-demo", family="dense", num_layers=4,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=2048, dtype="float32", remat=False)


def embedding_grad_results(device, runs=5) -> int:
    """Distinct results of the embedding lookup's gradient (the backward
    of `embed[tokens]`: an accumulating index_put_ over repeated ids) at
    (e)'s shapes over `runs` identical calls, under the current setting
    of torch.use_deterministic_algorithms."""
    gen = torch.Generator(device=device).manual_seed(0)
    embed = torch.randn(FT_DEMO.vocab_size, FT_DEMO.d_model, device=device,
                        generator=gen)
    tokens = torch.randint(0, FT_DEMO.vocab_size, (8, 64), device=device,
                           generator=gen)
    up = torch.randn(8, 64, FT_DEMO.d_model, device=device, generator=gen)
    seen = set()
    for _ in range(runs):
        e = embed.detach().requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(e[tokens], e, up)
        seen.add(g.cpu().numpy().tobytes())
    return len(seen)


def trainer_crash_resume(device) -> dict:
    """Phase 10(e): the reference example's ft-demo run on the card, 10
    steps, a commit to a store of its own (a store's manifest fence
    belongs to one run), 5 steps; the whole train state restored by strong
    read into a state from another seed, and the same 5 steps: losses
    and every leaf equal."""
    store = SpinnakerCheckpointStore(StoreConfig())
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
    stream = TokenStream(DataConfig(vocab_size=FT_DEMO.vocab_size,
                                    seq_len=64, global_batch=8, seed=0), 0)
    step_fn = make_train_step(FT_DEMO, tcfg)

    def run(state, start, n):
        losses = []
        for s in range(start, start + n):
            state, m = step_fn(state, stream.batch_at(s))
            losses.append(float(m["loss"]))
        return state, losses

    def resume():
        like = init_train_state(FT_DEMO, tcfg, seed=99, device=device)
        step, restored = store.restore_tree(like)
        return run(restored, step, 5)

    with deterministic_algorithms():
        state, first = run(init_train_state(FT_DEMO, tcfg, seed=0,
                                            device=device), 0, 10)
        store.save(10, state)
        ref_state, ref_losses = run(state, 10, 5)
        del state
        resumed, losses = resume()
        det_grads = embedding_grad_results(device)
    if losses != ref_losses or not trees_equal(resumed, ref_state):
        raise AssertionError(f"resumed losses {losses} != uninterrupted "
                             f"{ref_losses}, or the states differ")
    # without deterministic algorithms (other kernels for some ops): two
    # resumes against each other, reported and not held
    (s1, l1), (s2, l2) = resume(), resume()
    out = dict(losses=first + losses, state_bytes=tree_bytes(ref_state),
               free_resumes_equal=l1 == l2 and trees_equal(s1, s2),
               embedding_grad_results=embedding_grad_results(device),
               embedding_grad_results_deterministic=det_grads)
    log("store", f"(e) ft-demo ({out['state_bytes']} B of train state) on "
        f"the card: 10 steps, commit, 5 steps; restored by strong read into "
        f"a seed-99 state, the same 5 steps give equal losses {losses} and "
        f"an equal state (deterministic algorithms on).  Without them: two "
        f"resumes equal each other: {out['free_resumes_equal']}; the "
        f"embedding gradient gives {out['embedding_grad_results']} distinct "
        f"results in 5 calls ({det_grads} with them)")
    return out


# ---------------------------------------------------------------------------
# phase 11: the moe family and int8 weights
# ---------------------------------------------------------------------------

PHI = "phi3.5-moe-42b-a6.6b"
KIMI = "kimi-k2-1t-a32b"
MOE_TOL = 2e-4      # the reference's whole-model tolerance with attention
# numpy draws, in parallel threads: each block has its own stream
DRAW_BLOCK = 1 << 26


def numpy_moe_params(cfg: ModelConfig, seed: int) -> dict:
    """The moe family's f32 parameter tree at `cfg`'s widths, drawn with
    numpy from `seed`: normal with std 1/sqrt(fan_in) (embeddings 0.02),
    norm scales 1.  Every block of DRAW_BLOCK values has its own stream
    (`SeedSequence.spawn`), so the values do not depend on the threads."""
    from concurrent.futures import ThreadPoolExecutor
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    HD, KV = cfg.num_heads * cfg.resolved_head_dim, \
        cfg.num_kv_heads * cfg.resolved_head_dim
    E, Fd = cfg.num_experts, cfg.moe_d_ff
    drawn = {  # name: (shape, std)
        "embed": ((V, D), 0.02), "unembed": ((D, V), 0.02),
        "layers/attn/wq": ((L, D, HD), D ** -0.5),
        "layers/attn/wk": ((L, D, KV), D ** -0.5),
        "layers/attn/wv": ((L, D, KV), D ** -0.5),
        "layers/attn/wo": ((L, HD, D), HD ** -0.5),
        "layers/moe/router": ((L, D, E), D ** -0.5),
        "layers/moe/w_gate": ((L, E, D, Fd), D ** -0.5),
        "layers/moe/w_up": ((L, E, D, Fd), D ** -0.5),
        "layers/moe/w_down": ((L, E, Fd, D), Fd ** -0.5)}
    flat = {"final_norm/scale": np.ones(D, np.float32),
            "layers/attn_norm/scale": np.ones((L, D), np.float32),
            "layers/mlp_norm/scale": np.ones((L, D), np.float32)}
    tasks = []
    for name, (shape, std) in drawn.items():
        flat[name] = np.empty(shape, np.float32)
        view = flat[name].reshape(-1)
        for lo in range(0, view.size, DRAW_BLOCK):
            tasks.append((view[lo:lo + DRAW_BLOCK], np.float32(std)))
    seeds = np.random.SeedSequence(seed).spawn(len(tasks))

    def draw(i):
        out, std = tasks[i]
        np.random.default_rng(seeds[i]).standard_normal(out=out,
                                                        dtype=np.float32)
        out *= std
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        list(ex.map(draw, range(len(tasks))))
    tree: dict = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


@contextlib.contextmanager
def recorded_routes():
    """Each `moe._route` call's expert ids (T, K) and, on the host, its top
    K+1 probabilities, in call (layer) order."""
    route, calls = moe_mod._route, []

    def spy(params, xf, cfg):
        out = route(params, xf, cfg)
        probs = torch.softmax(xf.float() @ params["router"].float(), -1)
        top = torch.sort(probs, dim=-1, descending=True,
                         stable=True).values
        calls.append((out[1], top[:, :cfg.experts_per_token + 1].cpu()))
        return out
    moe_mod._route = spy
    try:
        yield calls
    finally:
        moe_mod._route = route


@contextlib.contextmanager
def pinned_routes(recorded):
    """`moe._route` made to take, call by call, the expert ids that
    `recorded_routes` recorded (gates: its own probabilities at those
    ids, renormalised), so that two runs whose router inputs differ by
    rounding dispatch the same tokens to the same experts and differ
    only continuously.  Yields the list of each call's count of tokens
    whose own route differed from the recorded one."""
    route, flips = moe_mod._route, []

    def pinned(params, xf, cfg):
        _, ids, aux = route(params, xf, cfg)
        want = recorded[len(flips)][0]
        flips.append(int((ids != want).any(-1).sum()))
        probs = torch.softmax(xf.float() @ params["router"].float(), -1)
        gate = probs.gather(1, want)
        return gate / gate.sum(-1, keepdim=True), want, aux
    moe_mod._route = pinned
    try:
        yield flips
    finally:
        moe_mod._route = route


def kernel_vs_eager(fn, cfg) -> tuple:
    """`fn(cfg)` through the kernels, then on the eager path with the
    kernel run's routes pinned.  Returns (kernel output, eager output,
    tokens whose route the eager run would have flipped, summed over the
    layers)."""
    with recorded_routes() as routes:
        out = fn(cfg)
    with pinned_routes(routes) as flips:
        ref = fn(cfg.scaled(attn_impl="xla"))
    return out, ref, sum(flips)


def dense_bytes(tree) -> int:
    """The bytes of `tree` with every int8 weight held as bf16 instead."""
    def walk(node):
        if is_quantized(node):
            return 2 * node["q"].numel()
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return node.numel() * node.element_size()
    return walk(tree)


def launches_now() -> dict:
    return {"decode_attention.split": da_ops.launches_by_variant["split"],
            **{f"flash_attention.{k}": v
               for k, v in fa_ops.launches_by_variant.items()}}


def launches_since(before: dict) -> dict:
    now = launches_now()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def step_vs_eager(cfg, params, cache, tokens) -> tuple[float, float, int]:
    """One decode step from clones of `cache` through the kernels and on
    the eager path (routes pinned, `kernel_vs_eager`): (max |diff| / max
    |logit|, top-1 agreement, route flips)."""
    def step(c):
        clone = {k: v.clone() for k, v in cache.items()}
        return decode_step(params, clone, tokens, c)[0]
    out, ref, flips = kernel_vs_eager(step, cfg)
    if not torch.isfinite(out).all():
        raise AssertionError("decode logits not finite")
    return (float((out - ref).abs().max() / ref.abs().max()),
            float((out.argmax(-1) == ref.argmax(-1)).float().mean()), flips)


def phi_f32_card_vs_cpu(device) -> dict:
    """11(a): Phi-3.5-MoE at full width, 2 layers, f32, numpy weights."""
    cfg = get_config(PHI).scaled(num_layers=2, dtype="float32",
                                 attn_impl="pallas")
    t0 = time.perf_counter()
    tree = numpy_moe_params(cfg, seed=0)
    draw_s = time.perf_counter() - t0
    smoke = init_params(get_config(PHI).scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=64, num_experts=4, moe_d_ff=32), device="cpu")
    if [n for n, _ in tree_leaves_with_path(tree)] != \
            [n for n, _ in tree_leaves_with_path(smoke)]:
        raise AssertionError("the numpy tree is not init_params's tree")
    params = params_from_numpy(tree, device)
    host = params_from_numpy(tree, "cpu")
    del tree
    nbytes = tree_bytes(params)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    with recorded_routes() as card_routes:
        out, aux, _ = forward(params, {"tokens": tokens.to(device)}, cfg)
    eager, eager_aux, _ = forward(params, {"tokens": tokens.to(device)},
                                  cfg.scaled(attn_impl="xla"))
    t0 = time.perf_counter()
    with recorded_routes() as cpu_routes:
        ref, ref_aux, _ = forward(host, {"tokens": tokens},
                                  cfg.scaled(attn_impl="xla"))
    cpu_s = time.perf_counter() - t0
    if out.shape != (2, 64, cfg.vocab_size) or not torch.isfinite(out).all():
        raise AssertionError("11(a) forward logits not finite")
    flipped, gaps = 0, []
    K = cfg.experts_per_token
    for (ids_c, _), (ids_h, top_h) in zip(card_routes, cpu_routes):
        bad = (ids_c.cpu() != ids_h).any(-1)
        flipped += int(bad.sum())
        gaps += (top_h[bad, K - 1] - top_h[bad, K]).tolist()
    out_c = out.cpu()
    err_eager = compare("11(a) forward vs eager", out, eager, MOE_TOL)
    err_cpu = compare("11(a) forward vs the CPU", out_c, ref, MOE_TOL)
    aux_err = abs(float(aux) - float(ref_aux))
    if aux_err > 1e-6 or abs(float(aux) - float(eager_aux)) > 1e-6:
        raise AssertionError(f"11(a) aux card {float(aux)} eager "
                             f"{float(eager_aux)} cpu {float(ref_aux)}")
    log("moe", f"(a) {PHI} full width, 2 layers, f32 ({nbytes} B, numpy "
        f"draws {draw_s:.1f} s), B=2 S=64 through flash fma: max_abs_err "
        f"{err_eager:.3g} against the eager path, {err_cpu:.3g} against "
        f"the CPU's forward ({cpu_s:.1f} s) (rtol = atol = {MOE_TOL}); aux "
        f"{float(aux):.8f} (cpu {float(ref_aux):.8f}); (token, layer) "
        f"routes differing between card and CPU: {flipped} of "
        f"{2 * 64 * cfg.num_layers}"
        + (f", their K-th minus (K+1)-th probability {gaps}" if gaps else ""))
    del host, out, eager, ref, out_c
    cache_k = init_cache(cfg, 2, 16, device=device)
    cache_e = init_cache(cfg, 2, 16, device=device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))).to(
        device)
    worst = 0.0
    for t in range(16):
        lk, cache_k = decode_step(params, cache_k, toks[:, t:t + 1], cfg)
        le, cache_e = decode_step(params, cache_e, toks[:, t:t + 1],
                                  cfg.scaled(attn_impl="xla"))
        worst = max(worst, compare(f"11(a) decode step {t}", lk, le,
                                   MOE_TOL))
    log("moe", f"(a) 16 decode steps (B=2, max_seq 16) through the split "
        f"kernel against the eager decode: max_abs_err {worst:.3g} (rtol = "
        f"atol = {MOE_TOL})")
    return dict(bytes=nbytes, err_eager=err_eager, err_cpu=err_cpu,
                routes_flipped=flipped, decode_err=worst)


def phi_int8_refresh(cfg, params, device) -> dict:
    """11(b), the store: new int8 wk/wv (codes and scales) and f32 router
    leaves for all layers, committed; engine A refreshes to them through
    a timeline read while serving, engine B swaps them in directly at the
    same batch.  A's params equal the swapped tree, and A's and B's
    tokens and caches are equal."""
    gen = torch.Generator(device=device).manual_seed(1)
    L, D = cfg.num_layers, cfg.d_model
    KV = cfg.num_kv_heads * cfg.resolved_head_dim
    new = {"layers": {
        "attn": {w: quantize_weight(dense_init(gen, (L, D, KV), 1,
                                               torch.bfloat16, device))
                 for w in ("wk", "wv")},
        "moe": {"router": dense_init(gen, (L, D, cfg.num_experts), 1,
                                     torch.float32, device)}}}
    nbytes = tree_bytes(new)
    store = SpinnakerCheckpointStore(StoreConfig())
    t0 = time.perf_counter()
    manifest = store.save(1, new)
    commit_s = time.perf_counter() - t0
    store.sim.run_for(2.0)                  # followers apply the commit
    lay = params["layers"]
    swapped = {**params, "layers": {
        **lay, "attn": {**lay["attn"], **new["layers"]["attn"]},
        "moe": {**lay["moe"], **new["layers"]["moe"]}}}
    scfg = ServeConfig(slots=8, max_seq=512, refresh_every_batches=8,
                       eos_id=0)
    waves = dict(n=8, lo=8, hi=16, new=8)
    eng_a = ServingEngine(cfg, params, scfg, store=store, device=device)
    refreshed_at = []

    def watch(eng):
        if eng.weights_step == 1 and not refreshed_at:
            refreshed_at.append(eng.batches_run)
    reqs_a, wall, step_a = serve_two_waves(eng_a, lambda: None, watch,
                                           **waves)
    if not refreshed_at or not trees_equal(eng_a.params, swapped):
        raise AssertionError("engine A did not refresh to the commit, or "
                             "its params differ from the committed leaves")
    at = refreshed_at[0]

    def swap(eng):
        if eng.batches_run == at:
            eng.params = swapped
    eng_b = ServingEngine(cfg, params, scfg, device=device)
    reqs_b, _, step_b = serve_two_waves(eng_b, lambda: None, swap, **waves)
    toks_a = {r.rid: r.output for r in reqs_a}
    if toks_a != {r.rid: r.output for r in reqs_b} or \
            not trees_equal(eng_a.cache, eng_b.cache):
        raise AssertionError("engine A's tokens or cache differ from B's")
    out = dict(bytes=nbytes, chunks=sum(e["nchunks"]
                                        for e in manifest["index"]),
               commit_s=commit_s, commit_mb_per_s=nbytes / commit_s / 1e6,
               refresh_batch=at, refresh_step_ms=1e3 * step_a[at - 1],
               p50_ms=1e3 * float(np.median(step_a)),
               no_store_p50_ms=1e3 * float(np.median(step_b)))
    log("moe", f"(b) store: the int8 wk/wv codes and scales and the f32 "
        f"router of all {L} layers ({nbytes} B in {out['chunks']} chunks) "
        f"committed in {commit_s:.3f} s ({out['commit_mb_per_s']:.3f} "
        f"MB/s); engine A refreshed through a timeline read at batch {at} "
        f"(that step {out['refresh_step_ms']:.3f} ms), its params equal "
        f"the swapped tree bit for bit, and its {len(toks_a)} requests' "
        f"tokens and its KV cache equal engine B's, swapped directly at "
        f"batch {at}; p50 step A {out['p50_ms']:.3f} ms, B "
        f"{out['no_store_p50_ms']:.3f} ms")
    del eng_a, eng_b, swapped, new
    return out


def labelled_profile(fn, labels) -> tuple[float, float, dict]:
    """One call of `fn` under torch.profiler, with each (module, name,
    label) of `labels` wrapped in a record_function range.  Each kernel
    counts for the nearest enclosing label ("other" outside all).
    Returns (wall ms, device busy ms, {label: device ms})."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def wrap(fn_, label):
        def wrapped(*a, **k):
            with record_function(label):
                return fn_(*a, **k)
        return wrapped
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in labels]
    for (mod, name, fn_), (_, _, label) in zip(saved, labels):
        setattr(mod, name, wrap(fn_, label))
    names = {label for _, _, label in labels}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for mod, name, fn_ in saved:
            setattr(mod, name, fn_)
    parts: dict = {}
    for e in prof.events():
        if not getattr(e, "kernels", None):
            continue
        p = e
        while p is not None and p.name not in names:
            p = p.cpu_parent
        label = p.name if p is not None else "other"
        parts[label] = parts.get(label, 0.0) + \
            sum(k.duration for k in e.kernels) / 1e3
    return wall_ms, sum(parts.values()), parts


def phi_int8_prefill(cfg, params, device) -> dict:
    """11(c): the int8 Phi-3.5-MoE's bf16 prefill, B=2 x 2048 tokens: a
    warm-up and a timed call, the kernels against the eager path (routes
    pinned), the top kernels and a profile by part."""
    S = 2048
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, S))).to(device)

    def run(c):
        return prefill(params, {"tokens": tokens}, c, S)
    run(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    last, plain, flips = kernel_vs_eager(run, cfg)
    if last.shape != (2, cfg.vocab_size) or not torch.isfinite(last).all():
        raise AssertionError("11(c) prefill logits not finite")
    rel = float((last - plain).abs().max() / plain.abs().max())
    agree = float((last.argmax(-1) == plain.argmax(-1)).float().mean())
    if rel > PREFILL_REL_LIMIT:
        raise AssertionError(f"11(c) prefill kernel vs eager: relative {rel}")
    where_the_time_goes(cfg, params, tokens, S)
    labels = [(layers_mod, "wcast", "dequantisation"),
              (moe_mod, "wcast", "dequantisation"),
              (moe_mod, "_experts", "expert GEMMs"),
              (model_mod, "moe_ffn", "dispatch"),
              (model_mod, "attention", "attention")]
    wall_ms, busy_ms, parts = labelled_profile(lambda: run(cfg), labels)
    out = dict(ms=1e3 * wall, prompt_tokens_per_s=2 * S / wall, rel=rel,
               top1=agree, route_flips=flips, profiled_wall_ms=wall_ms,
               busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms),
               parts_ms={k: round(v, 3) for k, v in sorted(
                   parts.items(), key=lambda kv: -kv[1])})
    log("moe", f"(c) {PHI} int8 prefill bf16 B=2 S={S} through flash "
        f"wgmma: {out['ms']:.3f} ms, {out['prompt_tokens_per_s']:.1f} prompt "
        f"tokens/s; against the eager path (its routes pinned to the "
        f"kernel run's; {flips} (token, layer) routes would have flipped) "
        f"max |diff| / max |logit| {rel:.3g} (limit {PREFILL_REL_LIMIT}), "
        f"top-1 agreement {agree}; one labelled profiled call "
        f"{wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms, idle share "
        f"{out['idle_share']:.3f}; device ms by part (dispatch: route, "
        f"sort, tables, gather, gating, combine; attention: its "
        f"projections' GEMMs and the kernel; other: norms, embedding, "
        f"unembedding): {out['parts_ms']}")
    return out


def phi_int8_path(device) -> dict:
    """11(b) and (c): Phi-3.5-MoE at full width and depth, int8 weights."""
    cfg = get_config(PHI).scaled(attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_quantized_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nbytes, bf16 = tree_bytes(params), dense_bytes(params)
    log("moe", f"(b) {PHI} full width and depth ({cfg.num_layers} layers), "
        f"int8 weights built one layer at a time in {build_s:.1f} s: "
        f"{nbytes} B of weights, against {bf16} B in bf16; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    requests = make_requests(cfg.vocab_size)
    before = launches_now()
    torch.cuda.reset_peak_memory_stats()
    eng, wall, step_s = serve(cfg, params, ServeConfig(slots=8, max_seq=512),
                              requests, device)
    launched = launches_since(before)
    if launched != {"decode_attention.split": cfg.num_layers * len(step_s)}:
        raise AssertionError(f"serving launched {launched}, not "
                             f"{cfg.num_layers} decodes a step")
    out = report_serving(PHI, eng, requests, wall, step_s, nbytes,
                         cfg.vocab_size, what="full width and depth, int8 "
                         "weights, bf16 activations")
    out.update(weight_bytes=nbytes, bf16_weight_bytes=bf16, build_s=build_s,
               decode_launches=launched["decode_attention.split"])
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (8, 1))).to(device)
    rel, agree, flips = step_vs_eager(cfg, params, eng.cache, tokens)
    if rel > DECODE_REL_LIMIT:
        raise AssertionError(f"11(b) decode vs eager: relative {rel}")
    log("moe", f"(b) {launched['decode_attention.split']} decode launches "
        f"({cfg.num_layers} x {len(step_s)} steps); one more step from the "
        f"served cache (pos {int(eng.cache['pos'])}) against the eager path "
        f"on the same int8 weights (routes pinned; {flips} would have "
        f"flipped): max |diff| / max |logit| {rel:.3g} (limit "
        f"{DECODE_REL_LIMIT}), top-1 agreement {agree}")
    out.update(step_rel=rel, step_top1=agree, step_route_flips=flips)
    del eng
    free()
    out["store"] = phi_int8_refresh(cfg, params, device)
    free()
    out["prefill"] = phi_int8_prefill(cfg, params, device)
    return out


def kimi_one_layer(device) -> dict:
    """11(d): Kimi-K2 at full width, 1 layer, dense bf16."""
    cfg = get_config(KIMI).scaled(num_layers=1, attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=device)
    nbytes = tree_bytes(params)
    init_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))).to(
        device)
    out, ref, flips = kernel_vs_eager(
        lambda c: forward(params, {"tokens": tokens}, c)[0], cfg)
    if not torch.isfinite(out).all():
        raise AssertionError("11(d) forward logits not finite")
    rel = float((out - ref).abs().max() / ref.abs().max())
    agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    if rel > PREFILL_REL_LIMIT:
        raise AssertionError(f"11(d) forward vs eager: relative {rel}")
    del out, ref
    cache = init_cache(cfg, 8, 16, device=device)
    worst, agrees, step_flips = 0.0, [], []
    for t in range(8):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1))).to(
            device)
        r, a, f = step_vs_eager(cfg, params, cache, tok)
        worst, agrees, step_flips = max(worst, r), agrees + [a], \
            step_flips + [f]
        _, cache = decode_step(params, cache, tok, cfg)
    if worst > DECODE_REL_LIMIT:
        raise AssertionError(f"11(d) decode vs eager: relative {worst}")
    log("moe", f"(d) {KIMI} full width, 1 layer, bf16 ({nbytes} B, init "
        f"peak {init_peak} B): B=1 S=256 forward through flash wgmma against "
        f"the eager path (routes pinned; {flips} tokens would have flipped) "
        f"max |diff| / max |logit| {rel:.3g} (limit {PREFILL_REL_LIMIT}), "
        f"top-1 agreement {agree}; 8 decode steps at B=8 through the split "
        f"kernel, each against the eager step (routes pinned; flips "
        f"{step_flips}): relative {worst:.3g} at most (limit "
        f"{DECODE_REL_LIMIT}), top-1 agreement {agrees}")
    return dict(bytes=nbytes, forward_rel=rel, forward_route_flips=flips,
                decode_rel=worst, decode_route_flips=step_flips)


def moe_path(device) -> dict:
    """Phase 11 (a)-(d), each part's kernel launches counted."""
    out, parts = {}, {}
    for key, run in (("a", phi_f32_card_vs_cpu), ("bc", phi_int8_path),
                     ("d", kimi_one_layer)):
        before = launches_now()
        out[key] = run(device)
        parts[key] = launches_since(before)
        free()
    log("moe", f"launches by part: {parts}")
    out["launches_by_part"] = parts
    return out


def moe_attention_timings(device) -> dict:
    """Phase 8 at phase 11's attention shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for key, case, dtype, what in (
            ("decode_phi", PHI_DECODE, bf16, "Phi-3.5-MoE serving"),
            ("decode_phi_f32", PHI_DECODE_F32, f32,
             "11(a), lengths 1..16, at T/2"),
            ("decode_kimi", KIMI_DECODE, bf16, "Kimi-K2, 11(d)")):
        out[key] = time_decode(case, dtype, device)
        log("timing", f"decode_attention {dtype} (B,H,Hkv,T,hd,len)="
            f"{case[:6]} ({what}): {out[key]}")
    for key, case, dtype, var, what in (
            ("flash_phi", PHI_FLASH, bf16, "wgmma",
             "Phi-3.5-MoE prefill, 11(c)"),
            ("flash_phi_f32", PHI_FLASH_F32, f32, "fma", "11(a)"),
            ("flash_kimi", KIMI_FLASH, bf16, "wgmma", "Kimi-K2, 11(d)")):
        out[key] = time_flash(case, dtype, device, var, iters=20)
        log("timing", f"flash_attention {var} {dtype} (B,H,Hkv,S,hd)="
            f"{case[:4] + case[5:6]} causal ({what}): {out[key]}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the paper's §9 workload engine, the op stream on the card


ZIPF_KEYS = 10_000_000
# benchmarks/spinnaker_bench.py's --quick configuration (base_spec,
# base_cfg), copied because that file imports the JAX package; the full
# one has 5000 keys, 32 clients, 2 s warm-up and 15 s measured
QUICK_SPEC = dict(num_keys=1000, key_dist="zipfian", zipf_theta=0.99,
                  read_frac=0.80, write_frac=0.15, rmw_frac=0.03,
                  cond_frac=0.02, value_size=4096)
QUICK_CFG = dict(n_nodes=5, disk="ssd", n_clients=16, ranges_per_node=8,
                 warmup=0.5, duration=3.0, preload_cap=1000)
LEADER_KILL = """
at {t_kill}s crash leader of 0
at {t_back}s restart crashed
"""
# the paper's claims with the reference bench's slack
# (spinnaker_bench.py CLAIM_TARGETS): strong reads at or under quorum
# reads, writes within 30 % of eventual ones, throughput within 5 %
CLAIM_TARGETS = {"read_vs_quorum_ratio_max": 1.05,
                 "write_p50_ratio_max": 1.30,
                 "throughput_ratio_min": 0.95}


@contextlib.contextmanager
def refill_clock():
    """Host seconds and count of every OpStream._refill in the block (the
    card's sampling, its one copy to the host and the host's scramble)."""
    spent = {"refill_s": 0.0, "refills": 0}
    inner = wl_gen.OpStream._refill

    def timed(self):
        t0 = time.perf_counter()
        inner(self)
        spent["refill_s"] += time.perf_counter() - t0
        spent["refills"] += 1

    wl_gen.OpStream._refill = timed
    try:
        yield spent
    finally:
        wl_gen.OpStream._refill = inner


def generator_at_scale(device, n_ops=1 << 20) -> dict:
    """12(a): a zipfian stream over ZIPF_KEYS keys (theta 0.99, a 40 MB f32
    CDF on `device`): sampling rate, the rank-1 key's share against 1/H,
    and the transform on `device` against the CPU's on the same draws."""
    spec = WorkloadSpec(num_keys=ZIPF_KEYS, key_dist="zipfian",
                        zipf_theta=0.99)
    t0 = time.perf_counter()
    s = wl_gen.OpStream(spec, seed=0, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if s._cdf.device.type != "cuda" or s._mult <= 1:
        raise AssertionError("the CDF is not on the card, or no scramble")
    for _ in range(8):        # warm-up (first touch of the CDF's pages)
        s._refill()
    refills = n_ops // s.batch
    keys = []
    t0 = time.perf_counter()
    for _ in range(refills):
        s._refill()
        keys.append(s._keys)
    refill_s = time.perf_counter() - t0
    # the scramble is a bijection taking rank 0 to key `_offset`
    hot = int(np.count_nonzero(np.concatenate(keys) == s._offset))
    t0 = time.perf_counter()
    for _ in range(refills):
        wl_gen._sample_batch(s._gen, s._cdf, s._mix_cdf, ZIPF_KEYS,
                             spec.value_size, s._vmin, s._vmax, s.batch)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    h = float(np.sum(np.arange(1, ZIPF_KEYS + 1, dtype=np.float64)
                     ** -0.99))
    share, want = hot / (refills * s.batch), 1.0 / h
    out = {"keys": ZIPF_KEYS, "cdf_bytes": s._cdf.numel() * 4,
           "build_s": build_s, "batch": s.batch,
           "ops_per_s": refills * s.batch / refill_s,
           "ops_per_s_without_copy": refills * s.batch / device_s,
           "rank1_share": share, "one_over_h": want}
    log("workload", f"12(a) {out}")
    if abs(share / want - 1) > 0.05:
        raise AssertionError(f"rank-1 share {share} not within 5 % of "
                             f"1/H = {want}")
    # the transform on the card against the plain one on the CPU
    gen = torch.Generator(device=device).manual_seed(1)
    draws = [torch.rand(n_ops, generator=gen, device=device)
             for _ in range(3)]
    mix = s._mix_cdf
    card = wl_gen.sample_transform(draws[0], draws[1], None, draws[2],
                                   s._cdf, mix, ZIPF_KEYS, 4096)
    host = wl_gen.sample_transform(*(d.cpu() for d in draws[:2]), None,
                                   draws[2].cpu(), s._cdf.cpu(), mix.cpu(),
                                   ZIPF_KEYS, 4096)
    for name, a, b in zip(("ranks", "ops", "sizes"), card, host):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"card and CPU {name} differ: "
                                 f"{int((a.cpu() != b).sum())} of {n_ops}")
    torch.testing.assert_close(card[3].cpu(), host[3], rtol=1e-6, atol=1e-7)
    out["gaps_max_abs_diff"] = float((card[3].cpu() - host[3]).abs().max())
    out["gaps_bit_equal_share"] = float(
        (card[3].cpu() == host[3]).double().mean())
    log("workload", f"12(a) card transform == CPU transform on {n_ops} "
        f"draws (ranks, ops, sizes exact; gaps max |diff| "
        f"{out['gaps_max_abs_diff']:.3g}, bit-equal share "
        f"{out['gaps_bit_equal_share']:.4f})")
    return out


def fig8_quick(**cfg_kw) -> dict:
    """12(b): the four Fig. 8 arms at the quick configuration and the
    three claim ratios, each held to its envelope.  `cfg_kw` goes to
    every arm's ExperimentConfig (the card run passes none)."""
    log("workload", "12(b) Fig. 8 at the reference bench's --quick "
        "configuration (1000 keys, 16 clients, 0.5 s warm-up, 3 s "
        "measured), a cut of the full one (5000 keys, 32 clients, 15 s) "
        "made for the script's time")
    spec = WorkloadSpec(**QUICK_SPEC)
    arms = {}
    for name, run, kw in (
            ("spinnaker_strong", run_spinnaker_workload,
             {"consistent_reads": True}),
            ("spinnaker_timeline", run_spinnaker_workload,
             {"consistent_reads": False, "monotonic": True}),
            ("cassandra_quorum", run_cassandra_workload, {"quorum": True}),
            ("cassandra_eventual", run_cassandra_workload,
             {"quorum": False})):
        cfg = ExperimentConfig(seed=0, **QUICK_CFG, **cfg_kw)
        t0 = time.perf_counter()
        with refill_clock() as clock:
            r = run(spec, cfg, **kw)
        host_s = time.perf_counter() - t0
        arms[name] = r
        log("workload", f"  {name}: reads p50={r['reads']['p50_ms']:.4f} "
            f"p99={r['reads']['p99_ms']:.4f} ms, writes "
            f"p50={r['writes']['p50_ms']:.4f} p99={r['writes']['p99_ms']:.4f}"
            f" ms, throughput {r['throughput']:.1f} ops/s; host {host_s:.2f}"
            f" s, {r['total_ops']} sim ops, "
            f"{r['total_ops'] / host_s:.1f} sim ops per host s, "
            f"refills {clock['refills']} in {clock['refill_s']:.4f} s")
        r["host_s"], r["refill"] = host_s, dict(clock)
    sp, cq = arms["spinnaker_strong"], arms["cassandra_quorum"]
    ce = arms["cassandra_eventual"]
    claims = {
        "read_vs_quorum_ratio": sp["reads"]["p50_ms"]
        / max(cq["reads"]["p50_ms"], 1e-9),
        "write_p50_ratio": sp["writes"]["p50_ms"]
        / max(ce["writes"]["p50_ms"], 1e-9),
        "throughput_ratio": sp["throughput"] / max(ce["throughput"], 1e-9)}
    log("workload", f"12(b) claim ratios {claims}; envelope "
        f"{CLAIM_TARGETS}")
    tg = CLAIM_TARGETS
    if not (claims["read_vs_quorum_ratio"] <= tg["read_vs_quorum_ratio_max"]
            and claims["write_p50_ratio"] <= tg["write_p50_ratio_max"]
            and claims["throughput_ratio"] >= tg["throughput_ratio_min"]):
        raise AssertionError(f"claim ratios outside the envelope: {claims}")
    return {"claims": claims, "arms": arms}


def fig9_quick(**cfg_kw) -> dict:
    """12(c): Fig. 9 at --quick (the bench's run_failover: seed 1, 8 s, the
    leader of range 0 killed at 2 s, restarted at 6 s, strong reads):
    writes must resume with no operator."""
    cfg = ExperimentConfig(**{**QUICK_CFG, "seed": 1, "duration": 8.0,
                              "window": 0.5, **cfg_kw})
    t_kill, t_back = 2.0, cfg.duration * 0.75
    t0 = time.perf_counter()
    with refill_clock() as clock:
        r = run_spinnaker_workload(
            WorkloadSpec(**QUICK_SPEC), cfg, consistent_reads=True,
            schedule=LEADER_KILL.format(t_kill=t_kill, t_back=t_back))
    host_s = time.perf_counter() - t0
    post = [w for w in r["timeline"]["write"] if w["t_start"] > t_kill]
    resumed = [w for w in post if w["throughput"] > 0]
    out = {"fault_events": r["fault_events"],
           "writes_resumed": bool(resumed),
           "recovery_window_start_s_after_kill":
               resumed[0]["t_start"] - t_kill if resumed else None,
           "post_kill_peak_write_tput": max(
               (w["throughput"] for w in post), default=0.0),
           "write_tput_by_window": [w["throughput"]
                                    for w in r["timeline"]["write"]],
           "host_s": host_s, "total_ops": r["total_ops"],
           "refill": dict(clock)}
    log("workload", f"12(c) Fig. 9 --quick: {out}")
    if not resumed:
        raise AssertionError("writes did not resume after the leader kill")
    return out


def workload_path(device) -> dict:
    """Phase 12 (a)-(c)."""
    return {"generator": generator_at_scale(device), "fig8": fig8_quick(),
            "fig9": fig9_quick()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # cuBLAS reads this at its first call; phase 10(e) needs it to run
    # under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    moe_tim = moe_attention_timings(device)
    free()
    # ssd_scan: tc at Mamba2's bf16 prefill shape (three launches)
    ssd = time_ssd(MAMBA_SHAPE, bf16, device, "tc")
    log("timing", f"ssd_scan tc bf16 b=2 s=2048 h=80 p=64 n=128 chunk=128 "
        f"(three launches): {ssd}; library: none (no single PyTorch call "
        "computes the scan)")

    # -- phase 9: training, which launches no kernel -------------------------
    t0 = time.perf_counter()
    zero_launches()
    train, trained = train_path(device)
    train["card_vs_cpu"] = train_card_vs_cpu(
        get_config("smollm-360m").scaled(num_layers=2), device, B=2, S=256)
    paths["train"] = read_launches("train", ())
    if any(paths["train"].values()):
        raise AssertionError("a kernel was launched on the training path")
    log("train", f"phase 9 took {time.perf_counter() - t0:.1f} s: {train}")
    free()

    # -- phase 10: the checkpoint store, then serving with refresh ----------
    t0 = time.perf_counter()
    zero_launches()
    store = SpinnakerCheckpointStore(StoreConfig())
    ckpt = commit_restore_serve(device, store, trained)
    del trained
    free()
    ckpt["resume"] = trainer_crash_resume(device)
    paths["store"] = read_launches("store", ("decode_attention.split",))
    log("store", f"phase 10 took {time.perf_counter() - t0:.1f} s: {ckpt}")
    free()

    # -- phase 11: the moe family and int8 weights ----------------------------
    t0 = time.perf_counter()
    zero_launches()
    moe = moe_path(device)
    paths["moe"] = read_launches("moe", ("decode_attention.split",
                                         "flash_attention.wgmma",
                                         "flash_attention.fma"))
    log("moe", f"phase 11 took {time.perf_counter() - t0:.1f} s: {moe}")
    free()

    # -- phase 12: the §9 workload engine, which launches no kernel ---------
    t0 = time.perf_counter()
    zero_launches()
    workload = workload_path(device)
    paths["workload"] = read_launches("workload", ())
    if any(paths["workload"].values()):
        raise AssertionError("a kernel was launched on the workload path")
    log("workload", f"phase 12 took {time.perf_counter() - t0:.1f} s: "
        f"claims {workload['fig8']['claims']}, writes resumed "
        f"{workload['fig9']['writes_resumed']}")
    free()
    launches = {k: sum(p[k] for p in paths.values())
                for k in paths["smollm"]}
    log("timing", f"main-path launches per path: {paths}")

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
    fa_vars["wgmma"]["phi_prefill"] = moe_tim["flash_phi"]
    fa_vars["wgmma"]["kimi"] = moe_tim["flash_kimi"]
    fa_vars["fma"]["phi_f32"] = moe_tim["flash_phi_f32"]
    ssd_vars["fma"]["at_s2048"] = tim["ssd_fma_2048"]
    ssd_vars["fma"]["zamba2_s256"] = tim["ssd_fma_256_zamba"]
    da_vars = {"split": variant("decode_attention", "split",
                                "decode_attention.cu",
                                f"bf16 B=8 H=15 Hkv=5 T=512 hd=64 "
                                f"len={dec_len}", tim["decode"])}
    da_vars["split"]["full_context_shape"] = tim["decode_2048"]
    da_vars["split"]["deepseek_16k"] = tim["decode_16k"]
    da_vars["split"]["full_context_step"] = full_ctx
    da_vars["split"]["f32_smollm_t64"] = tim["decode_f32_t64"]
    da_vars["split"]["f32_zamba2_t256"] = tim["decode_f32_t256"]
    da_vars["split"]["phi_serving"] = moe_tim["decode_phi"]
    da_vars["split"]["phi_f32_t16"] = moe_tim["decode_phi_f32"]
    da_vars["split"]["kimi"] = moe_tim["decode_kimi"]
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
