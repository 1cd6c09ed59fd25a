"""What the benchmark takes from the program (`repro_torch`, from the
checkout's `src/`): its configuration by name, its parameter tree built
from the benchmark's draws through the program's own quantisation, its
entry points, its launch counters and the functions the trace labels.
Imported only once a run has checked for a card (or a CPU test asks)."""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import torch

from . import weights as W

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import mamba2 as mamba2_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.quant import quantize_tree  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

KERNEL_OPS = {"decode_attention": da_ops, "flash_attention": fa_ops,
              "ssd_scan": ssd_ops}


def config(conf: dict, smoke: bool = False):
    """The program's ModelConfig the configuration file names, with the
    dtype and kernel path it states (`attn_impl="pallas"`: the CUDA
    kernels; on CPU tensors their plain versions) and, at full size, the
    numbers it sets apart from the program's config (`overrides`)."""
    prog = conf["program"]
    base = (smoke_config if smoke else get_config)(prog["config"])
    if not smoke:
        base = base.scaled(**prog.get("overrides", {}))
    return base.scaled(attn_impl=prog["attn_impl"], dtype=prog["dtype"])


def build_params(weights: str, m: dict, seed: int, device) -> dict:
    """The program's parameter tree from the benchmark's draws, one layer
    at a time into the (L, ...) stacks; `weights` "int8" through the
    program's `quantize_tree`, so the dense stack never exists at once."""
    int8 = weights == "int8"
    params = W.top(m, seed, device)
    L = m["num_layers"]
    for i in range(L):
        layer = W.layer(m, seed, i, device)
        if int8:
            layer = quantize_tree(layer)
        if i == 0:
            params["layers"] = tree_map(
                lambda t: t.new_empty((L,) + t.shape), layer)
        tree_map(lambda s, t: s[i].copy_(t), params["layers"], layer)
        del layer
    return params


@contextlib.contextmanager
def recorded_routes():
    """Each `moe._route` call's expert ids (a device tensor, (T, k)), in
    call order, kept by reference: no copy, no wait."""
    route, calls = moe_mod._route, []

    def spy(params, xf, cfg, group=None):
        out = route(params, xf, cfg, group)
        calls.append(out[1])
        return out
    moe_mod._route = spy
    try:
        yield calls
    finally:
        moe_mod._route = route


class RecordedProjections:
    """The inputs and outputs of the projections (`linear` calls: in_proj
    and out_proj) of the program's Mamba2 block at chosen calls of the
    block (`mamba2_block` in prefill, `mamba2_decode` in serving), cut
    by `take` (serving's sampled slots, or prefill's sampled positions);
    copies on the device, made at the chosen calls only.  `want(call)`
    maps the block call's index since `calls` was last set to a key, or
    None to pass it by; `kept[key]` is the list of (input, output)."""

    def __init__(self, decode: bool, want, take):
        self.name = "mamba2_decode" if decode else "mamba2_block"
        self.want, self.take, self.calls, self.kept = want, take, 0, {}

    def __enter__(self):
        real = getattr(model_mod, self.name)

        def spy(*a):
            key = self.want(self.calls)
            self.calls += 1
            if key is None:
                return real(*a)
            lin, got = mamba2_mod.linear, []

            def recorded(w, x):
                y = lin(w, x)
                got.append((self.take(x).clone(), self.take(y).clone()))
                return y
            mamba2_mod.linear = recorded
            try:
                return real(*a)
            finally:
                mamba2_mod.linear = lin
                self.kept[key] = got
        self._real = real
        setattr(model_mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(model_mod, self.name, self._real)


# (module, attribute, label): the names each caller binds
LABELS = [(layers_mod, "wcast", "wcast"), (moe_mod, "wcast", "wcast"),
          (engine_mod, "decode_step", "decode_step"),
          (model_mod, "attention_decode", "attention_decode"),
          (model_mod, "attention", "attention"),
          (model_mod, "moe_ffn", "moe_ffn"),
          (model_mod, "mamba2_decode", "mamba2_decode"),
          (model_mod, "mamba2_block", "mamba2_block"),
          (model_mod, "_unembed", "unembed")]


@contextlib.contextmanager
def labelled():
    """Each function of `LABELS` wrapped in a `record_function` range of
    its label, for the traced slice only."""
    from torch.profiler import record_function

    def wrap(fn, label):
        def wrapped(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return wrapped
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in LABELS]
    for (mod, name, fn), (_, _, label) in zip(saved, LABELS):
        setattr(mod, name, wrap(fn, label))
    try:
        yield {label for _, _, label in LABELS}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def launches() -> dict:
    """The program's launch counters, by kernel variant."""
    return {f"{k}.{var}": n for k, mod in KERNEL_OPS.items()
            for var, n in mod.launches_by_variant.items()}
