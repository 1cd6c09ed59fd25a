"""Operations (multiply and add counted as two) and bytes of the kernels
and model steps the benchmark's cells run.  Each input byte is counted
read once and each output byte written once; attention and the scan
count the (query, key) pairs a causal mask leaves, the lower triangles.

The model's FLOPs count what the result needs: every matmul weight a
token uses (the k experts it is routed to, not all), attention over the
visible keys, the SSD scan's lower-triangle work, and the unembedding
at the positions whose logits are used (the last one of a prefill, every
slot of a decode step).  The embedding is a lookup and counts nothing.
"""

from __future__ import annotations


def flash_causal(B, H, Hkv, S, hd, elt=2) -> tuple[float, float]:
    """(flops, bytes) of one causal flash-attention call."""
    flops = 4 * B * H * hd * S * (S + 1) // 2
    nbytes = elt * (2 * B * H * S * hd + 2 * B * Hkv * S * hd)
    return float(flops), float(nbytes)


def decode_attention(B, H, Hkv, length, hd, elt=2) -> tuple[float, float]:
    """(flops, bytes) of one decode-attention call over `length` cached
    rows of every one of B rows: q read and o written, K and V read."""
    flops = 4 * B * H * length * hd
    nbytes = elt * (2 * B * H * hd + 2 * B * Hkv * length * hd) + 4
    return float(flops), float(nbytes)


def ssd_scan(b, s, h, p, n, q, elt=2) -> tuple[float, float]:
    """(flops, bytes) of one chunked SSD scan call (all its launches):
    per (b, head, chunk) C . S^T and (weighted x)^T B (2 q p n each) and
    the lower triangle of L x; per (b, chunk) the lower triangle of one
    C B^T that the heads share.  Bytes: x in and y out, B and C, dt and
    A in float32."""
    nc = s // q
    flops = b * h * nc * (4 * q * p * n + q * (q + 1) * p) \
        + b * nc * q * (q + 1) * n
    nbytes = elt * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h)
    return float(flops), float(nbytes)


def layer_matmul_params(m: dict) -> int:
    """Matmul weights one token uses in one layer."""
    D = m["d_model"]
    if m["family"] in ("dense", "moe"):
        H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        n = 2 * D * H * hd + 2 * D * Hkv * hd
        if m["family"] == "moe":
            n += D * m["num_experts"]                       # router
            n += m["experts_per_token"] * 3 * D * m["moe_d_ff"]
        else:
            n += 3 * D * m["d_ff"]
        return n
    Din = m["ssm_expand"] * D
    N, P = m["ssm_state"], m["ssm_head_dim"]
    return D * (2 * Din + 2 * N + Din // P) + Din * D


def prefill_flops(m: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill of B rows of S tokens (last-position
    logits)."""
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    f = 2.0 * layer_matmul_params(m) * B * S * L
    if m["family"] in ("dense", "moe"):
        f += L * flash_causal(B, m["num_heads"], m["num_kv_heads"], S,
                              m["head_dim"])[0]
    else:
        Din = m["ssm_expand"] * D
        f += L * ssd_scan(B, S, Din // m["ssm_head_dim"], m["ssm_head_dim"],
                          m["ssm_state"], m["ssm_chunk"])[0]
        f += L * 2.0 * m["ssm_conv_width"] * (Din + 2 * m["ssm_state"]) \
            * B * S
    return f + 2.0 * D * V * B


def decode_token_flops(m: dict, length: int) -> float:
    """Model FLOPs of one slot's token in a decode step whose attention
    reads `length` cached rows (the recurrent update for Mamba2)."""
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    f = 2.0 * layer_matmul_params(m) * L + 2.0 * D * V
    if m["family"] in ("dense", "moe"):
        f += L * 4.0 * m["num_heads"] * m["head_dim"] * length
    else:
        Din = m["ssm_expand"] * D
        # decay and input outer product into the state, C . state
        f += L * (6.0 * Din * m["ssm_state"]
                  + 2.0 * m["ssm_conv_width"] * (Din + 2 * m["ssm_state"]))
    return f
