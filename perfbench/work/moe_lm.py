"""The work of one chain's SGHMC sampling step on the DeepSeek-V3 decoder of
``perfbench/configs/moonlight16b-ep8.json``, counted from the algorithm and
the shapes (a multiply-add is two operations).

Products, each layer's forward, weight-gradient and input-gradient pass (the
input gradient reaches the embedding, so every layer takes it): every
matrix outside the routed experts (the attention's projections, the
routers, the shared experts, the dense SwiGLU, the head) at every token;
the attention core, ``q k^T`` and ``p v`` over the causal pairs ``i >= j``
of every head and sequence, forward and its two backward products each;
the held experts' three matrices at each assignment routed to them, which
only the program's counter knows.  Bytes of the sampling update B7: theta,
v, minv and the gradient read once, theta and v written once, float32.
"""


def _layers(cfg):
    dense = cfg["first_k_dense_replace"]
    return dense, cfg["num_hidden_layers"] - dense


def token_macs(cfg):
    """Multiply-adds of the matrices every token passes (no routed
    expert, no attention core)."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    attn = h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv) \
        + nh * dv * h
    shared = 3 * h * cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    router = h * cfg["router_experts"]
    dense, moe = _layers(cfg)
    return (dense * (attn + 3 * h * cfg["intermediate_size"])
            + moe * (attn + shared + router) + h * cfg["vocab_size"])


def attention_products(cfg, batch, length):
    """Operations of the attention core of one step, both passes."""
    pairs = batch * cfg["num_attention_heads"] * length * (length + 1) // 2
    width = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] \
        + cfg["v_head_dim"]
    return 3 * 2 * pairs * width * cfg["num_hidden_layers"]


def expert_products(cfg, assignments):
    """Operations of the held experts' products for ``assignments``
    (tokens times chosen held experts, over the expert layers), both
    passes."""
    return 3 * 2 * assignments * 3 * cfg["hidden_size"] \
        * cfg["moe_intermediate_size"]


def step_products(cfg, batch, length):
    """Operations of one step's products outside the routed experts."""
    return 3 * 2 * batch * length * token_macs(cfg) \
        + attention_products(cfg, batch, length)


def work(tc_flops=0, f32_flops=0, nbytes=0):
    return dict(tc_flops=tc_flops, f32_flops=f32_flops, bytes=nbytes)


def update_bytes(n_params):
    """Bytes of one B7 step over a chain's ``n_params`` (float32)."""
    return 6 * 4 * n_params
