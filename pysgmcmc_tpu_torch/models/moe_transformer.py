"""A DeepSeek-V3 decoder with a share of the routed experts, as an ``(init,
apply)`` pair (the block of Moonlight-16B-A3B, :data:`MOONLIGHT_16B_A3B`).

The layers follow DeepSeek-V3's modelling code (``modeling_deepseek.py``
beside the published checkpoints), in float32:

- RMSNorm ``w * x / sqrt(mean(x^2) + eps)``, computed in float32.
- Multi-head latent attention with no query compression (``q_lora_rank``
  null): ``q = x W_q`` splits per head into ``qk_nope_head_dim`` and
  ``qk_rope_head_dim`` columns; ``[c, k_pe] = x W_kva`` with ``c`` of
  ``kv_lora_rank`` columns and one ``k_pe`` shared by every head; ``[k_nope,
  v] = RMSNorm(c) W_kvb`` per head; RoPE on ``q_pe`` and ``k_pe`` as that code
  applies it (each head's interleaved pairs first gathered into halves, then
  ``x cos + rotate_half(x) sin`` with ``inv_freq = theta^(-2i / d)``);
  causal softmax attention of ``[q_nope, q_pe]`` on ``[k_nope, k_pe]``
  scaled by ``(qk_nope_head_dim + qk_rope_head_dim)^-1/2``; ``o W_o``.
- Pre-norm residual blocks: ``x + attn(norm(x))``, then ``x +
  ffn(norm(x))``, the first ``first_k_dense_replace`` with a SwiGLU of
  width ``intermediate_size``, the others an expert layer.
- The expert layer: sigmoid scores ``s = sigmoid(x W_r)`` over all
  ``n_routed_experts`` (in float32); each token takes the
  ``num_experts_per_tok`` largest ``s + e_score_correction_bias``, weighs
  them by their ``s`` normalised over the chosen ones (``norm_topk_prob``)
  times ``routed_scaling_factor``, and adds ``sum_e w_e SwiGLU_e(x)`` (width
  ``moe_intermediate_size``) and the shared experts' SwiGLU (width
  ``n_shared_experts * moe_intermediate_size``).  Group-limited routing
  with one group (``n_group`` = ``topk_group`` = 1) chooses among all
  experts, which is this top-k.
- A final RMSNorm and an untied head to the vocabulary's logits.

Where this departs from the published model:

- Expert parallelism's share: the layer holds the routed experts
  ``held_experts`` (ids of the router's outputs).  The router routes over
  all of them; only the held experts are computed, for the tokens routed to
  them, dropless (no capacity: every assignment is computed, whatever the
  imbalance), and what the absent experts would add is left out: the partial
  result that one chip of the deployment computes before its exchange, and
  that goes on to the next layer.  The shared experts are added once.
- ``e_score_correction_bias`` is a buffer outside the parameters:
  ``correction_bias`` ``(expert layers, n_routed_experts)``, zero unless the
  caller gives one (a deployment's load balancer sets it; ``apply`` reads
  it at every call).
- ``vocab_size`` is the slice's: the embedding and the head cover the
  slice's ids ``0 .. vocab_size - 1`` only.
- The weights are drawn, not loaded: ``N(0, initializer_range^2)`` for
  every matrix and embedding row, ones for the norms.

Parameters are a dict of tensors in a fixed order (the lanes drivers' row
layout follows it): ``embed``, then for layer ``i`` the names ``l{i}.``
``attn_norm``, ``q_proj``, ``kv_a_proj``, ``kv_a_norm``, ``kv_b_proj``,
``o_proj``, ``ffn_norm`` and either ``gate``, ``up``, ``down`` (dense) or
``router``, ``experts_gate``, ``experts_up``, ``experts_down`` (the held
experts stacked, in ``held_experts`` order), ``shared_gate``,
``shared_up``, ``shared_down``; then ``norm`` and ``head``.  Matrices are
``(out, in)`` as ``torch.nn.functional.linear`` takes them.

Spans (:mod:`pysgmcmc_tpu_torch.utils.tracing`, while a profiler records,
each over both passes): ``moe.route`` (scores, top-k, the sort by expert
and the gather of the held experts' tokens, with the one wait for the
tokens per expert on the host), ``moe.experts`` (the held experts' products
and the weighted scatter back to the tokens), ``moe.shared`` and
``mla.attention`` (the attention core).  The counter
``moe.held_assignments`` adds each expert layer's assignments that land on
held experts.

Examples
--------
>>> import torch
>>> cfg = dict(MOONLIGHT_16B_A3B, hidden_size=16, intermediate_size=24,
...            moe_intermediate_size=8, n_routed_experts=4,
...            num_experts_per_tok=2, num_hidden_layers=2,
...            num_attention_heads=2, kv_lora_rank=8, qk_nope_head_dim=4,
...            qk_rope_head_dim=4, v_head_dim=4, vocab_size=32)
>>> init, apply = moe_transformer(cfg, held_experts=[1, 3], device="cpu")
>>> params = init(torch.Generator().manual_seed(0))
>>> tuple(params["l1.experts_up"].shape)
(2, 8, 16)
>>> apply(params, torch.zeros(3, 5, dtype=torch.int64)).shape
torch.Size([3, 5, 32])
"""

import math

import torch
import torch.nn.functional as F

from pysgmcmc_tpu_torch.utils import tracing

# Moonlight-16B-A3B's config.json (moonshotai/Moonlight-16B-A3B, DeepSeek-V3
# architecture): the keys that shape the network
MOONLIGHT_16B_A3B = dict(
    hidden_size=2048, intermediate_size=11264, moe_intermediate_size=1408,
    n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
    routed_scaling_factor=2.446, norm_topk_prob=True, scoring_func="sigmoid",
    topk_method="noaux_tc", n_group=1, topk_group=1, first_k_dense_replace=1,
    moe_layer_freq=1, num_hidden_layers=27, num_attention_heads=16,
    q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, rope_theta=50000.0,
    rms_norm_eps=1e-5, hidden_act="silu", attention_bias=False,
    vocab_size=163840, initializer_range=0.02)

# what this module implements of the keys that could say otherwise
_REQUIRED = dict(scoring_func="sigmoid", topk_method="noaux_tc",
                 q_lora_rank=None, moe_layer_freq=1, hidden_act="silu",
                 attention_bias=False)


def _check(config):
    for key, want in _REQUIRED.items():
        if config.get(key, want) != want:
            raise ValueError("moe_transformer: {}={!r} is not implemented "
                             "(only {!r})".format(key, config[key], want))
    if config.get("n_group", 1) != config.get("topk_group", 1):
        raise ValueError("moe_transformer: group-limited routing over fewer "
                         "groups than there are is not implemented")
    if config.get("rope_scaling") is not None:
        raise ValueError("moe_transformer: rope_scaling is not implemented")


def rms_norm(x, weight, eps):
    """RMSNorm in float32."""
    x = x.float()
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def swiglu(x, gate, up, down):
    """``(silu(x gate^T) * (x up^T)) down^T``."""
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def shared_experts(x, gate, up, down):
    """The shared experts' SwiGLU, added to every token once."""
    return swiglu(x, gate, up, down)


def rope_table(length, dim, theta, device):
    """``(cos, sin)`` ``(length, dim)`` of positions ``0 .. length - 1``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device)
                                .float() / dim))
    freqs = torch.outer(torch.arange(length, device=device).float(),
                        inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rope(x, cos, sin):
    """DeepSeek-V3's RoPE on ``x`` ``(..., length, dim)``: the interleaved
    pairs gathered into halves, then ``x cos + rotate_half(x) sin``."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def causal_attention(q, k, v):
    """Causal softmax attention ``(..., heads, length, dim)``, scaled by
    ``q``'s head size to the power -1/2."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          scale=q.shape[-1] ** -0.5)


def _attention(p, pre, x, cfg, cos, sin):
    nh, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    length = x.shape[-2]
    lead = x.shape[:-2]
    q = F.linear(x, p[pre + "q_proj"]).unflatten(-1, (nh, dn + dr))
    q_nope, q_pe = q.transpose(-3, -2).split([dn, dr], dim=-1)
    c, k_pe = F.linear(x, p[pre + "kv_a_proj"]).split(
        [cfg["kv_lora_rank"], dr], dim=-1)
    kv = F.linear(rms_norm(c, p[pre + "kv_a_norm"], cfg["rms_norm_eps"]),
                  p[pre + "kv_b_proj"]).unflatten(-1, (nh, dn + dv))
    k_nope, v = kv.transpose(-3, -2).split([dn, dv], dim=-1)
    q_pe = rope(q_pe, cos, sin)
    k_pe = rope(k_pe.unsqueeze(-3), cos, sin)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(*lead, nh, length, dr)], dim=-1)
    o = tracing.traced("mla.attention", causal_attention, q, k, v)
    return F.linear(o.transpose(-3, -2).flatten(-2), p[pre + "o_proj"])


def held_map(held_experts, n_experts, device):
    """``(n_experts,)`` int64: each expert's index among ``held_experts``,
    -1 where it is not held."""
    held = torch.as_tensor(list(held_experts), dtype=torch.int64)
    if held.numel() == 0 or len(set(held.tolist())) != held.numel() \
            or held.min() < 0 or held.max() >= n_experts:
        raise ValueError("held_experts must be distinct ids in [0, {}); got "
                         "{}".format(n_experts, held.tolist()))
    out = torch.full((n_experts,), -1, dtype=torch.int64)
    out[held] = torch.arange(held.numel())
    return out.to(device)


def route(x, router, bias, held, top_k, scale, normalise):
    """Route the tokens ``x`` ``(T, hidden)`` over every expert and gather
    the held experts' assignments, sorted by expert.

    ``held`` is :func:`held_map`'s.  Returns ``(idx, weights, tokens,
    counts, xs)``: each token's chosen experts ``(T, top_k)``; the held
    assignments' weights ``(A,)`` and tokens ``(A,)``, grouped by expert in
    ``held`` order; the assignments of each held expert, a CPU int64 tensor
    (the layer's one wait for the card); and the assigned tokens' rows
    ``(A, hidden)``."""
    scores = torch.sigmoid(F.linear(x.float(), router.float()))
    idx = torch.topk(scores.detach() + bias, top_k, dim=-1).indices
    weights = scores.gather(-1, idx)
    if normalise:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = (weights * scale).reshape(-1)
    n_held = int((held >= 0).sum())
    local = held[idx].reshape(-1)
    local = torch.where(local >= 0, local, n_held)  # the absent ones last
    order = torch.argsort(local, stable=True)
    counts = torch.bincount(local, minlength=n_held + 1).cpu()[:n_held]
    order = order[:int(counts.sum())]
    tokens = order // top_k
    tracing.count("moe.held_assignments", order.numel())
    return idx, weights[order], tokens, counts, x[tokens]


def held_expert_outputs(xs, weights, tokens, counts, gate, up, down,
                        n_tokens):
    """``sum_e w_e SwiGLU_e(x)`` over the held assignments, scattered back
    to ``(n_tokens, hidden)`` rows: one SwiGLU per held expert over its
    tokens, ``counts`` (a list) of them each."""
    outs = [swiglu(x_e, gate[e], up[e], down[e])
            for e, x_e in enumerate(torch.split(xs, counts)) if counts[e]]
    out = xs.new_zeros((n_tokens, xs.shape[-1]))
    if not outs:
        return out
    return out.index_add(0, tokens, torch.cat(outs) * weights[:, None])


def moe_ffn(p, pre, x, cfg, held, bias):
    """The expert layer on ``x`` ``(..., hidden)`` with the held experts of
    :func:`held_map` ``held`` and the router's correction ``bias``."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    _, weights, tokens, counts, xs = tracing.traced(
        "moe.route", lambda x, router: route(
            x, router, bias, held, cfg["num_experts_per_tok"],
            cfg["routed_scaling_factor"], cfg["norm_topk_prob"]),
        x, p[pre + "router"])
    counts = counts.tolist()
    routed = tracing.traced(
        "moe.experts", lambda xs, w, g, u, d: held_expert_outputs(
            xs, w, tokens, counts, g, u, d, x.shape[0]),
        xs, weights, p[pre + "experts_gate"], p[pre + "experts_up"],
        p[pre + "experts_down"])
    shared = tracing.traced(
        "moe.shared", shared_experts, x, p[pre + "shared_gate"],
        p[pre + "shared_up"], p[pre + "shared_down"])
    return (routed + shared).reshape(shape)


def param_shapes(cfg, n_held):
    """``{name: shape}`` of the parameters in their order (module
    docstring)."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    kvb = nh * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"])
    i_moe = cfg["moe_intermediate_size"]
    i_shared = cfg["n_shared_experts"] * i_moe
    shapes = {"embed": (cfg["vocab_size"], h)}
    for layer in range(cfg["num_hidden_layers"]):
        pre = "l{}.".format(layer)
        shapes.update({
            pre + "attn_norm": (h,), pre + "q_proj": (nh * dq, h),
            pre + "kv_a_proj": (r + dr, h), pre + "kv_a_norm": (r,),
            pre + "kv_b_proj": (kvb, r),
            pre + "o_proj": (h, nh * cfg["v_head_dim"]),
            pre + "ffn_norm": (h,)})
        if layer < cfg["first_k_dense_replace"]:
            i = cfg["intermediate_size"]
            shapes.update({pre + "gate": (i, h), pre + "up": (i, h),
                           pre + "down": (h, i)})
        else:
            shapes.update({
                pre + "router": (cfg["n_routed_experts"], h),
                pre + "experts_gate": (n_held, i_moe, h),
                pre + "experts_up": (n_held, i_moe, h),
                pre + "experts_down": (n_held, h, i_moe),
                pre + "shared_gate": (i_shared, h),
                pre + "shared_up": (i_shared, h),
                pre + "shared_down": (h, i_shared)})
    shapes.update(norm=(h,), head=(cfg["vocab_size"], h))
    return shapes


def moe_transformer(config, held_experts=None, correction_bias=None, *,
                    device="cuda"):
    """The decoder of ``config`` (the keys of :data:`MOONLIGHT_16B_A3B`;
    ``n_routed_experts`` is the router's width, ``num_hidden_layers`` the
    layers built, ``vocab_size`` the slice's) holding the routed experts
    ``held_experts`` (default: all) of each expert layer, with the routers'
    ``correction_bias`` (a float32 ``(expert layers, n_routed_experts)``
    tensor on ``device``, read at every call; default zeros), as ``(init,
    apply)``.

    ``init(generator, batch_shape=())`` draws the parameters on ``device``
    (the card unless ``"cpu"`` is asked for) from the ``torch.Generator``,
    in their order, with leading axes ``batch_shape``; ``apply(params,
    tokens)`` maps integer ``(..., length)`` token ids (one sequence a row,
    positions from 0) to ``(..., length, vocab_size)`` logits, for
    parameters without leading axes.
    """
    cfg = dict(MOONLIGHT_16B_A3B)
    cfg.update(config)
    _check(cfg)
    n_experts = cfg["n_routed_experts"]
    if held_experts is None:
        held_experts = range(n_experts)
    held = held_map(held_experts, n_experts, device)
    first_moe = cfg["first_k_dense_replace"]
    if correction_bias is None:
        correction_bias = torch.zeros(
            (max(0, cfg["num_hidden_layers"] - first_moe), n_experts),
            dtype=torch.float32, device=device)
    shapes = param_shapes(cfg, len(list(held_experts)))
    std = cfg["initializer_range"]
    tables = {}

    def init(generator, batch_shape=()):
        params = {}
        for name, shape in shapes.items():
            leaf = torch.empty(tuple(batch_shape) + shape, device=device)
            if name == "norm" or name.endswith("_norm"):
                params[name] = leaf.fill_(1.0)
            else:
                params[name] = leaf.normal_(0.0, std, generator=generator)
        return params

    def apply(params, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        length = tokens.shape[-1]
        if length not in tables:
            tables[length] = rope_table(length, cfg["qk_rope_head_dim"],
                                        cfg["rope_theta"], device)
        cos, sin = tables[length]
        eps = cfg["rms_norm_eps"]
        x = F.embedding(tokens, params["embed"])
        for layer in range(cfg["num_hidden_layers"]):
            pre = "l{}.".format(layer)
            x = x + _attention(params, pre, rms_norm(
                x, params[pre + "attn_norm"], eps), cfg, cos, sin)
            h = rms_norm(x, params[pre + "ffn_norm"], eps)
            if layer < cfg["first_k_dense_replace"]:
                x = x + swiglu(h, params[pre + "gate"], params[pre + "up"],
                               params[pre + "down"])
            else:
                x = x + moe_ffn(params, pre, h, cfg, held,
                                correction_bias[layer - first_moe])
        return F.linear(rms_norm(x, params["norm"], eps), params["head"])

    return init, apply


def n_params(config, n_held):
    """The parameters of :func:`moe_transformer` holding ``n_held``
    experts of each expert layer."""
    cfg = dict(MOONLIGHT_16B_A3B)
    cfg.update(config)
    return sum(math.prod(s) for s in param_shapes(cfg, n_held).values())


__all__ = ["MOONLIGHT_16B_A3B", "held_map", "moe_ffn", "moe_transformer",
           "n_params", "param_shapes", "route"]
