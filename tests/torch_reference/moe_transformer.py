"""A plain PyTorch float32 DeepSeek-V3 decoder (the block of
Moonlight-16B-A3B) for the port's tests.  It imports nothing of the port.

Written from DeepSeek-V3's ``modeling_deepseek.py``: RMSNorm; multi-head
latent attention without query compression, RoPE applied after gathering
each head's interleaved pairs into halves, causal softmax; SwiGLU for the
first ``first_k_dense_replace`` layers; then expert layers whose sigmoid
router picks the top ``num_experts_per_tok`` of ``scores + bias`` over all
``n_routed_experts``, weighs them by their normalised scores times
``routed_scaling_factor``, and adds every held expert's SwiGLU for the
tokens routed to it (experts not in ``held`` add nothing) and the shared
experts' SwiGLU.  Parameter names and shapes are the port's (matrices
``(out, in)``); ``params[...]`` may be any tensors, so autograd gives the
gradient.
"""

import math

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return w * x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps)


def swiglu(x, gate, up, down):
    g = x @ gate.t()
    return (g * torch.sigmoid(g) * (x @ up.t())) @ down.t()


def rope(x, theta):
    """``x`` ``(..., length, d)``, positions from 0."""
    n, d = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(n, dtype=torch.float32)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    x = torch.stack([x[..., 0::2], x[..., 1::2]], dim=-2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def attention(p, pre, x, cfg):
    """``x`` ``(batch, length, hidden)``."""
    b, n, _ = x.shape
    nh, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    q = (x @ p[pre + "q_proj"].t()).view(b, n, nh, dn + dr).transpose(1, 2)
    a = x @ p[pre + "kv_a_proj"].t()
    c, k_pe = a[..., :cfg["kv_lora_rank"]], a[..., cfg["kv_lora_rank"]:]
    kv = (rms(c, p[pre + "kv_a_norm"], cfg["rms_norm_eps"])
          @ p[pre + "kv_b_proj"].t()).view(b, n, nh, dn + dv).transpose(1, 2)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg["rope_theta"])], -1)
    k_pe = rope(k_pe, cfg["rope_theta"])[:, None].expand(b, nh, n, dr)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    s = q @ k.transpose(-1, -2) / math.sqrt(dn + dr)
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), -math.inf)
    o = torch.softmax(s, dim=-1) @ kv[..., dn:]
    return o.transpose(1, 2).reshape(b, n, nh * dv) @ p[pre + "o_proj"].t()


def shared(p, pre, x):
    """The shared experts' SwiGLU."""
    return swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"],
                  p[pre + "shared_down"])


def routed(p, pre, x, cfg, held, bias):
    """The held experts' part of an expert layer on ``x`` ``(..., hidden)``;
    expert ``held[j]``'s weights are ``p[pre + "experts_*"][j]``."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(x @ p[pre + "router"].t())
    idx = torch.topk(scores.detach() + bias, k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for j, e in enumerate(held):
        weight = (w * (idx == e)).sum(-1, keepdim=True)
        out = out + weight * swiglu(x, p[pre + "experts_gate"][j],
                                    p[pre + "experts_up"][j],
                                    p[pre + "experts_down"][j])
    return out


def logits(p, tokens, cfg, held, bias=None):
    """``(batch, length, vocab)`` logits of integer ``tokens``."""
    n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    if bias is None:
        bias = torch.zeros(n_moe, cfg["n_routed_experts"])
    eps = cfg["rms_norm_eps"]
    x = p["embed"][tokens]
    for layer in range(cfg["num_hidden_layers"]):
        pre = "l{}.".format(layer)
        x = x + attention(p, pre, rms(x, p[pre + "attn_norm"], eps), cfg)
        h = rms(x, p[pre + "ffn_norm"], eps)
        if layer < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, p[pre + "gate"], p[pre + "up"], p[pre + "down"])
        else:
            m = layer - cfg["first_k_dense_replace"]
            x = x + routed(p, pre, h, cfg, held, bias[m]) + shared(p, pre, h)
    return rms(x, p["norm"], eps) @ p["head"].t()


def cost(p, tokens, targets, n_tokens, cfg, held, bias=None):
    """``n_tokens`` times the mean next-token cross-entropy."""
    z = logits(p, tokens, cfg, held, bias)
    return n_tokens * F.cross_entropy(z.reshape(-1, z.shape[-1]),
                                      targets.reshape(-1))
