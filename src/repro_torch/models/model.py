"""Model assembly in PyTorch, dense family; a port of
`repro/models/model.py`.

embedding -> stacked layers (a Python loop over the leading L axis, in
place of `lax.scan`) -> norm -> tied or separate unembedding.  Parameters
keep the reference's tree, so `repro_torch.convert` carries weights across
both ways.  The moe, ssm and hybrid families come with later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from ..device import resolve
from .config import ModelConfig
from .layers import (attention, attention_decode, embed_init, init_attention,
                     init_mlp, init_rmsnorm, mlp, rms_norm)

_LATER = {"moe": "the MoE/int8 slice", "ssm": "the Mamba2/ssd_scan slice",
          "hybrid": "the Mamba2/ssd_scan slice"}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER.get(cfg.family, 'a later slice')}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's distributions (truncated
    normal, std 1/sqrt(fan_in); embeddings std 0.02), drawn from a
    `torch.Generator` seeded with `seed` on `device`.  The values differ
    from `repro.models.init_params`; convert those to compare."""
    _check_family(cfg)
    dev = resolve(device)
    dt = _dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D = (cfg.num_layers,), cfg.d_model
    params: dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, D), dt, dev),
        "final_norm": init_rmsnorm(D, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (D, cfg.vocab_size), dt, dev)
    params["layers"] = {
        "attn_norm": init_rmsnorm(D, dev, L),
        "attn": init_attention(gen, cfg, dt, dev, L),
        "mlp_norm": init_rmsnorm(D, dev, L),
        "mlp": init_mlp(gen, D, cfg.d_ff, dt, dev, L),
    }
    return params


def _layer_slice(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _unembed(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits in the model dtype (the reference's einsum), not yet f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w.to(h.dtype)


# ---------------------------------------------------------------------------
# forward (train / prefill trunk)
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Returns (h (B,S,D), positions (B,S), loss_mask (B,S))."""
    dt = _dtype(cfg)
    if cfg.modality == "vlm":
        tokens = batch["tokens"]                      # (B, S - P)
        patches = batch["patches"].to(dt)             # (B, P, D)
        te = params["embed"][tokens].to(dt)
        h = torch.cat([patches, te], dim=1)
        mask = torch.cat([torch.zeros(patches.shape[:2], dtype=torch.bool,
                                      device=h.device),
                          torch.ones(tokens.shape, dtype=torch.bool,
                                     device=h.device)], dim=1)
    elif cfg.modality == "audio" and cfg.frame_embed:
        h = batch["frames"].to(dt)                    # (B, S, D)
        mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    else:
        h = params["embed"][batch["tokens"]].to(dt)
        mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    return h, positions, mask


def forward(params: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence forward.  Returns (logits (B,S,V) f32, aux_loss,
    loss_mask)."""
    _check_family(cfg)
    h, positions, mask = _embed_inputs(params, batch, cfg)
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        h = h + attention(lp["attn"],
                          rms_norm(lp["attn_norm"], h, cfg.norm_eps),
                          cfg, positions)
        h = h + mlp(lp["mlp"], rms_norm(lp["mlp_norm"], h, cfg.norm_eps),
                    cfg.activation)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = _unembed(params, cfg, h).to(DTYPES[cfg.logit_dtype])
    return logits, 0.0, mask


def prefill(params: dict, batch: dict, cfg: ModelConfig, max_seq: int):
    """Last-token logits of the full-prompt forward (the reference's
    `prefill`, which leaves the KV cache to the serving engine)."""
    logits, _aux, _mask = forward(params, batch, cfg)
    return logits[:, -1]


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    """{"pos": 0-d int32, "k"/"v": (L, batch, Hkv, max_seq, hd)} on
    `device`."""
    _check_family(cfg)
    dev = resolve(device)
    dt = dtype or _dtype(cfg)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1) integer (or (B,1,D) frames for
    audio).  Returns (logits (B, V) f32, new_cache).

    The K/V tensors are updated in place (no copy of the whole cache per
    step): the returned cache shares them with `cache` and carries
    pos + 1.
    """
    _check_family(cfg)
    dt = _dtype(cfg)
    pos = cache["pos"]
    if cfg.modality == "audio" and cfg.frame_embed:
        h = tokens.to(dt)
    else:
        h = params["embed"][tokens].to(dt)            # (B,1,D)
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        x = rms_norm(lp["attn_norm"], h, cfg.norm_eps)
        a, _, _ = attention_decode(lp["attn"], x, cfg, cache["k"][i],
                                   cache["v"][i], pos)
        h = h + a
        h = h + mlp(lp["mlp"], rms_norm(lp["mlp_norm"], h, cfg.norm_eps),
                    cfg.activation)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = _unembed(params, cfg, h)
    return logits[:, 0].float(), dict(cache, pos=pos + 1)
