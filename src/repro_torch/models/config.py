"""Model configuration: one dataclass covers all ten assigned families
(dense / MoE / SSM / hybrid / VLM / audio backbones)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: Optional[int] = None  # explicit (Gemma: 256); default D/H
    modality: str = "text"          # text | vlm | audio
    activation: str = "swiglu"      # swiglu | geglu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert hidden size
    shared_expert_d_ff: int = 0     # DeepSeek/Kimi-style always-on expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- SSM (Mamba2 / SSD) ------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # -- hybrid (Zamba2): one shared attention block every k SSM blocks ---------
    attn_every: int = 0
    # hybrid long-context: shared-attention KV is windowed to this many
    # positions (the Mamba2 backbone carries the full context)
    attn_window: int = 0

    # -- modality stubs -----------------------------------------------------------
    num_patches: int = 0            # VLM: prepended patch-embedding positions
    frame_embed: bool = False       # audio: inputs are precomputed frame embeds

    # -- numerics / execution ------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save non-batch matmuls)
    attn_impl: str = "xla"          # xla | pallas | xla_chunked
    moe_impl: str = "gspmd"         # gspmd | shard_map (explicit all-to-all)
    decode_attn_impl: str = "xla"   # xla | shard_map (hd-sharded psum)
    logit_dtype: str = "float32"
    scan_layers: bool = True        # False: unrolled (cost-analysis mode)

    # ---------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (drives roofline MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        n = V * D                                   # embeddings
        if not self.tie_embeddings:
            n += V * D                               # unembed
        per_layer = 0
        if self.family in ("dense", "moe"):
            qkv = D * (self.num_heads * hd) + 2 * D * (self.num_kv_heads * hd)
            attn = qkv + (self.num_heads * hd) * D
            per_layer += attn + 2 * D               # norms
            if self.is_moe:
                expert = 3 * D * self.moe_d_ff
                per_layer += self.num_experts * expert + D * self.num_experts
                if self.shared_expert_d_ff:
                    per_layer += 3 * D * self.shared_expert_d_ff
            else:
                per_layer += 3 * D * F
        elif self.family == "ssm":
            per_layer += self._ssm_block_params()
        elif self.family == "hybrid":
            per_layer += self._ssm_block_params()
        n += L * per_layer
        if self.family == "hybrid" and self.attn_every:
            # one shared attention+MLP block (weights shared across slots)
            qkv = D * (self.num_heads * hd) + 2 * D * (self.num_kv_heads * hd)
            n += qkv + (self.num_heads * hd) * D + 3 * D * F + 2 * D
        return n

    def _ssm_block_params(self) -> int:
        D, Din = self.d_model, self.d_inner
        N, H = self.ssm_state, self.ssm_heads
        G = self.ssm_groups
        in_proj = D * (2 * Din + 2 * G * N + H)
        conv = (Din + 2 * G * N) * self.ssm_conv_width
        out = Din * D
        return in_proj + conv + out + Din + 2 * H + 2 * D  # norms, A, D, dt_bias

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (for 6·N_active·D flops)."""
        if not self.is_moe:
            return self.param_count()
        D, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        qkv = D * (self.num_heads * hd) + 2 * D * (self.num_kv_heads * hd)
        per_layer = qkv + (self.num_heads * hd) * D + 2 * D
        per_layer += self.experts_per_token * 3 * D * self.moe_d_ff
        per_layer += D * self.num_experts  # router
        if self.shared_expert_d_ff:
            per_layer += 3 * D * self.shared_expert_d_ff
        return n + L * per_layer
