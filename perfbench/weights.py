"""Model weights drawn from a seed, one layer at a time, for both sides.

The benchmark makes the weights; the program and the reference each get
the same dense draws and derive what they need from them (the program its
int8 codes and scales through its own `quantize_tree`, the reference its
own quantisation).  A layer is drawn by one generator seeded from (seed,
layer) in one large normal draw, cut into the layer's matrices, each
scaled by 1/sqrt(fan_in) and cast to the served dtype, so layer i can be
drawn again alone, in any order, and comes out the same on one device.

The tree is the program's parameter layout, which is the JAX package's:
matmul weights stored (in, out), a layer's leaves named as there.
Embeddings have std 0.02; norm scales are ones; Mamba2's A, D and dt
follow the Mamba2 paper's initialisation (A = -linspace(1, 16, H), D = 1,
dt log-uniform in [1e-3, 1e-1] held as softplus^-1 in `dt_bias`).
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one (seed, stream): stream 0 holds the embeddings,
    stream i + 1 layer i."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + 7919 * stream + 1)
                  % (1 << 63))
    return g


def _matrices(m: dict) -> list[tuple]:
    """(path, shape, fan_in) of one layer's matrices, in draw order."""
    D = m["d_model"]
    if m["family"] in ("dense", "moe"):
        H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        out = [(("attn", "wq"), (D, H * hd), D),
               (("attn", "wk"), (D, Hkv * hd), D),
               (("attn", "wv"), (D, Hkv * hd), D),
               (("attn", "wo"), (H * hd, D), H * hd)]
        if m["family"] == "moe":
            E, F = m["num_experts"], m["moe_d_ff"]
            out += [(("moe", "router"), (D, E), D),
                    (("moe", "w_gate"), (E, D, F), D),
                    (("moe", "w_up"), (E, D, F), D),
                    (("moe", "w_down"), (E, F, D), F)]
        else:
            F = m["d_ff"]
            out += [(("mlp", "w_gate"), (D, F), D),
                    (("mlp", "w_up"), (D, F), D),
                    (("mlp", "w_down"), (F, D), F)]
        return out
    if m["family"] == "ssm":
        Din, N, H, K = ssm_dims(m)[:4]
        conv = Din + 2 * N
        return [(("mamba", "in_proj"), (D, 2 * Din + 2 * N + H), D),
                (("mamba", "conv_w"), (K, conv), K),
                (("mamba", "out_proj"), (Din, D), Din)]
    raise ValueError(f"no weights for family {m['family']!r}")


def ssm_dims(m: dict) -> tuple[int, int, int, int, int]:
    """(d_inner, state, heads, conv width, head dim); one B/C group."""
    Din = m["ssm_expand"] * m["d_model"]
    return (Din, m["ssm_state"], Din // m["ssm_head_dim"],
            m["ssm_conv_width"], m["ssm_head_dim"])


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def layer(m: dict, seed: int, i: int, device) -> dict:
    """Layer i's dense parameters in the served dtype (router, norms and
    Mamba2's scalars in float32), as the program's tree holds one layer."""
    dt = DTYPES[m["dtype"]]
    mats = _matrices(m)
    total = sum(math.prod(s) for _, s, _ in mats)
    extra = ssm_dims(m)[2] if m["family"] == "ssm" else 0   # dt's draws
    g = generator(seed, i + 1, device)
    z = torch.randn(total + extra, generator=g, device=device)
    D = m["d_model"]
    f32 = dict(dtype=torch.float32, device=device)
    tree: dict = {}
    at = 0
    for path, shape, fan_in in mats:
        n = math.prod(shape)
        w = z[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        at += n
        if path[-1] == "router":
            _set(tree, path, w.clone())
        elif path[-1] == "conv_w":
            _set(tree, path, w.mul_(0.5).to(dt))
        else:
            _set(tree, path, w.to(dt))
    if m["family"] in ("dense", "moe"):
        tree["attn_norm"] = {"scale": torch.ones(D, **f32)}
        tree["mlp_norm"] = {"scale": torch.ones(D, **f32)}
        return tree
    Din, N, H = ssm_dims(m)[:3]
    u = torch.special.ndtr(z[at:at + H].float())      # uniform from normal
    lo, hi = math.log(1e-3), math.log(1e-1)
    dtv = torch.exp(lo + (hi - lo) * u)
    tree["mamba"].update(
        conv_b=torch.zeros(Din + 2 * N, **f32),
        dt_bias=torch.log(torch.expm1(dtv)),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        D=torch.ones(H, **f32),
        norm={"scale": torch.ones(Din, **f32)})
    tree["norm"] = {"scale": torch.ones(D, **f32)}
    return tree


def top(m: dict, seed: int, device) -> dict:
    """Embedding, final norm and (untied) unembedding."""
    dt = DTYPES[m["dtype"]]
    V, D = m["vocab_size"], m["d_model"]
    g = generator(seed, 0, device)
    n = V * D * (1 if m["tie_embeddings"] else 2)
    z = torch.randn(n, generator=g, device=device).mul_(0.02)
    out = {"embed": z[:V * D].view(V, D).to(dt),
           "final_norm": {"scale": torch.ones(D, dtype=torch.float32,
                                              device=device)}}
    if not m["tie_embeddings"]:
        out["unembed"] = z[V * D:].view(D, V).to(dt)
    return out
