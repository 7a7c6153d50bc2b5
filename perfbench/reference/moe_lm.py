"""The DeepSeek-V3 decoder of a chip's expert-parallel share (Moonlight-16B-A3B's
block), its next-token cost and gradient, and SGHMC's sampling rule, in plain
PyTorch and float32.  Nothing here imports the program.

The network (as DeepSeek-V3's ``modeling_deepseek.py`` writes it): RMSNorm in
float32; multi-head latent attention without query compression (``q = x
W_q``, ``[c, k_pe] = x W_kva``, ``[k_nope, v] = RMSNorm(c) W_kvb`` per head,
RoPE on ``q_pe`` and the shared ``k_pe`` after gathering each head's
interleaved pairs into halves, causal softmax of ``[q_nope, q_pe] .
[k_nope, k_pe] / sqrt(d_qk)``, ``o W_o``); pre-norm residual blocks, the
first ``first_k_dense_replace`` with a SwiGLU, the others an expert layer:
sigmoid scores over every routed expert, the top ``num_experts_per_tok`` of
``scores + correction bias``, their scores normalised and scaled by
``routed_scaling_factor``, the held experts' SwiGLUs for the tokens routed
to them (the absent experts' part left out, as one chip of the deployment
computes it), plus the shared experts; a final RMSNorm and the head over the
vocabulary slice.  Parameters are named and ordered as the program lays a
chain's row out (its ``models/moe_transformer.py`` docstring), matrices
``(out, in)``.

The cost of a window of sequences is ``N`` times the mean next-token
cross-entropy over its tokens; :func:`cost_and_grad` sums it one sequence at
a time (the cost is a sum over sequences, so the blocks are exact), taking
the gradient by autograd through these plain operations.  ``routes`` gives
each expert layer's chosen experts (the program's): top-k is not continuous
in the scores, and two programs whose scores part by rounding choose
differently where two scores tie within it, so the gradient is compared on
the program's choice, and :func:`cost_and_grad` reports how far that choice
lies from its own top-k (``route_gap``: the largest amount by which a chosen
expert's ``score + bias`` falls short of the k-th largest).

``precision="bf16"`` rounds both operands of every product (the routers',
the attention's and every projection's) to bfloat16 and keeps float32
everywhere else: the benchmark's lower-precision control.  ``"float32"`` is
the reference; on the card it needs TF32 off.
"""

import math

import torch
import torch.nn.functional as F

from perfbench.reference import stream

NOISE = 1


def param_shapes(cfg, n_held):
    """``{name: shape}`` in the row's order."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, i_moe = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    i_sh = cfg["n_shared_experts"] * i_moe
    out = {"embed": (cfg["vocab_size"], h)}
    for layer in range(cfg["num_hidden_layers"]):
        p = "l%d." % layer
        out[p + "attn_norm"] = (h,)
        out[p + "q_proj"] = (nh * (dn + dr), h)
        out[p + "kv_a_proj"] = (r + dr, h)
        out[p + "kv_a_norm"] = (r,)
        out[p + "kv_b_proj"] = (nh * (dn + dv), r)
        out[p + "o_proj"] = (h, nh * dv)
        out[p + "ffn_norm"] = (h,)
        if layer < cfg["first_k_dense_replace"]:
            i = cfg["intermediate_size"]
            out[p + "gate"], out[p + "up"], out[p + "down"] = \
                (i, h), (i, h), (h, i)
        else:
            out[p + "router"] = (cfg["n_routed_experts"], h)
            out[p + "experts_gate"] = (n_held, i_moe, h)
            out[p + "experts_up"] = (n_held, i_moe, h)
            out[p + "experts_down"] = (n_held, h, i_moe)
            out[p + "shared_gate"] = (i_sh, h)
            out[p + "shared_up"] = (i_sh, h)
            out[p + "shared_down"] = (h, i_sh)
    out["norm"] = (h,)
    out["head"] = (cfg["vocab_size"], h)
    return out


def leaves(row, shapes):
    """The leaves of a chain's flat row ``(P,)``, as views."""
    out, off = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        out[name] = row[off:off + size].reshape(shape)
        off += size
    return out


def rounded(x, precision):
    """``x`` rounded to ``precision`` (``"bf16"``: to nearest even), held
    in float32."""
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def mm(a, b, precision):
    """``a @ b`` with both operands at ``precision``."""
    return torch.matmul(rounded(a, precision), rounded(b, precision))


def linear(x, w, precision):
    return mm(x, w.t(), precision)


def norm(x, w, eps):
    return w * (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps))


def swiglu(x, gate, up, down, precision):
    a = linear(x, gate, precision)
    return linear(a * torch.sigmoid(a) * linear(x, up, precision), down,
                  precision)


def rope_tables(length, dim, theta, device):
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device).float()
                           / dim))
    ang = torch.outer(torch.arange(length, device=device).float(), inv)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rope(x, cos, sin):
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]],
                               dim=-1) * sin


def attention(p, pre, x, cfg, cos, sin, precision):
    """One sequence ``x`` ``(length, hidden)``."""
    nh, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    n = x.shape[0]
    q = linear(x, p[pre + "q_proj"], precision).reshape(n, nh, dn + dr)
    q = q.permute(1, 0, 2)
    a = linear(x, p[pre + "kv_a_proj"], precision)
    c, k_pe = a[:, :cfg["kv_lora_rank"]], a[:, cfg["kv_lora_rank"]:]
    kv = linear(norm(c, p[pre + "kv_a_norm"], cfg["rms_norm_eps"]),
                p[pre + "kv_b_proj"], precision).reshape(n, nh, dn + dv)
    kv = kv.permute(1, 0, 2)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], dim=-1)
    k_pe = rope(k_pe, cos, sin).unsqueeze(0).expand(nh, n, dr)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    s = mm(q, k.transpose(1, 2), precision) / math.sqrt(dn + dr)
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
    o = mm(w, kv[..., dn:], precision).permute(1, 0, 2).reshape(n, nh * dv)
    return linear(o, p[pre + "o_proj"], precision)


def experts(p, pre, x, cfg, held, bias, precision, chosen=None):
    """One sequence's expert layer; returns ``(out, chosen, gap)``: the
    chosen experts ``(length, k)`` (``chosen``, or the own top-k) and the
    largest shortfall of a chosen expert's ``score + bias`` below the k-th
    largest (``inf`` where a token names an expert twice)."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(linear(x, p[pre + "router"], precision))
    choice = scores.detach() + bias
    kth = torch.topk(choice, k, dim=-1).values[:, -1]
    if chosen is None:
        chosen = torch.topk(choice, k, dim=-1).indices
    short = (kth - choice.gather(-1, chosen).min(dim=-1).values).clamp(min=0)
    twice = (torch.sort(chosen, dim=-1).values.diff(dim=-1) == 0).any(-1)
    gap = float(torch.where(twice, float("inf"), short).max())
    w = scores.gather(-1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for j, e in enumerate(held):
        token, slot = torch.nonzero(chosen == e, as_tuple=True)
        if token.numel():
            y = swiglu(x[token], p[pre + "experts_gate"][j],
                       p[pre + "experts_up"][j], p[pre + "experts_down"][j],
                       precision)
            out = out.index_add(0, token, y * w[token, slot][:, None])
    shared = swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"],
                    p[pre + "shared_down"], precision)
    return out + shared, chosen, gap


def forward(p, tokens, cfg, held, bias, precision="float32", routes=None,
            scores=None):
    """One sequence's logits ``(length, vocab)``, each expert layer's chosen
    experts, and the largest route shortfall; each expert layer's router
    scores ``(length, n_experts)`` are appended to the list ``scores``
    where one is given."""
    eps = cfg["rms_norm_eps"]
    cos, sin = rope_tables(tokens.shape[0], cfg["qk_rope_head_dim"],
                           cfg["rope_theta"], tokens.device)
    x = p["embed"][tokens.long()]
    chosen, gap = [], 0.0
    for layer in range(cfg["num_hidden_layers"]):
        pre = "l%d." % layer
        x = x + attention(p, pre, norm(x, p[pre + "attn_norm"], eps), cfg,
                          cos, sin, precision)
        h = norm(x, p[pre + "ffn_norm"], eps)
        if layer < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, p[pre + "gate"], p[pre + "up"],
                           p[pre + "down"], precision)
            continue
        m = layer - cfg["first_k_dense_replace"]
        if scores is not None:
            scores.append(torch.sigmoid(linear(h, p[pre + "router"],
                                               precision)))
        out, pick, g = experts(p, pre, h, cfg, held, bias[m], precision,
                               None if routes is None else routes[m])
        x = x + out
        chosen.append(pick)
        gap = max(gap, g)
    logits = linear(norm(x, p["norm"], eps), p["head"], precision)
    return logits, chosen, gap


def cost_and_grad(row, shapes, tokens, targets, n_tokens, cfg, held, bias,
                  precision="float32", routes=None):
    """The window's cost (``N`` times the mean cross-entropy over
    ``tokens`` ``(batch, length)``) and its gradient by leaf, one sequence
    at a time, at the flat row ``row``; with each expert layer's chosen
    experts, ``(batch * length, k)`` (``routes``, or the own), and the
    largest route shortfall."""
    params = {name: leaf.detach().requires_grad_()
              for name, leaf in leaves(row, shapes).items()}
    grads = {name: torch.zeros_like(leaf) for name, leaf in params.items()}
    scale = float(n_tokens) / tokens.numel()
    n = tokens.shape[1]
    cost, gap, chosen = 0.0, 0.0, []
    for b in range(tokens.shape[0]):
        mine = None if routes is None else [r[b * n:(b + 1) * n]
                                            for r in routes]
        with torch.enable_grad():
            logits, pick, g = forward(params, tokens[b], cfg, held, bias,
                                      precision, mine)
            loss = scale * F.cross_entropy(logits, targets[b].long(),
                                           reduction="sum")
        for name, grad in zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)):
            if grad is not None:
                grads[name] += grad
        cost += float(loss)
        gap = max(gap, g)
        chosen.append(pick)
    routes = [torch.cat([c[m] for c in chosen]) for m in range(len(chosen[0]))]
    return cost, grads, routes, gap


def normals(seed, step, columns):
    """The Box-Muller normals of chain 0 at absolute ``step`` for the row's
    ``columns`` (int64): element ``e`` takes its quarter of draw ``e // 4``
    (purpose 1), words (x, y) for ``e % 4`` in {0, 1}, (z, w) for {2, 3}."""
    words = stream.philox(0, step & stream.MASK32, columns >> 2, NOISE, seed)
    second = (columns & 2) != 0
    u1 = stream.uniform(torch.where(second, words[2], words[0]))
    u2 = stream.uniform(torch.where(second, words[3], words[1]))
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = 2.0 * math.pi * u2
    return torch.where((columns & 1) != 0, r * torch.sin(t), r * torch.cos(t))


def sghmc_step(theta, v, minv, grad, eta, eps, scale_grad, mdecay,
               prior_scale):
    """SGHMC's sampling step with a frozen ``minv``: ``v' = v - eps^2 minv
    (grad + prior_scale theta) - mdecay v + sqrt(max(2 es^2 mdecay minv -
    es^4, 1e-16)) eta``, ``theta' = theta + v'``, ``es = eps /
    sqrt(scale_grad)``."""
    es = eps / math.sqrt(scale_grad)
    sigma = torch.sqrt(torch.clamp(2.0 * es * es * mdecay * minv - es ** 4,
                                   min=1e-16))
    v_new = v - eps * eps * minv * (grad + prior_scale * theta) \
        - mdecay * v + sigma * eta
    return theta + v_new, v_new
