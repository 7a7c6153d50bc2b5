"""The heteroscedastic tanh regression network of Springenberg et al. 2016
and its SG-MCMC and SVGD updates, in plain PyTorch and float32.

A chain's parameters are one flat vector in the order of
:func:`perfbench.reference.stream.param_offsets`.  The cost of a chain on a
minibatch of ``B`` points is ``-(sum_b (-(f_b - y_b)^2 / (2 exp(s)) - s / 2)
/ B + log N(s; log 1e-6, 0.01) / N)``, ``f`` the network's mean output and
``s`` the log-variance bias; the Gaussian weight prior enters the gradient
as ``prior_scale * theta``.  The gradients are written out by hand.

``precision="tf32"`` rounds both operands of every product to TF32 (10
mantissa bits, to nearest even) and keeps float32 everywhere else: the
benchmark's lower-precision control.  ``"float32"`` is the reference; on
the card it needs TF32 off (:func:`strict_float32`).
"""

import math

import torch

from perfbench.reference.stream import param_offsets

LOG_PRIOR_MEAN = math.log(1e-6)
PRIOR_VAR = 0.01
PRECISIONS = ("float32", "tf32")


def strict_float32():
    """Turn TF32 off for matrix products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x):
    """``x`` rounded to TF32 (to nearest even), held in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def bmm(a, b, precision):
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    return torch.bmm(a, b)


def mm(a, b, precision):
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    return torch.mm(a, b)


def unflatten(theta, n_inputs, hidden, depth):
    n = theta.shape[0]
    out = {}
    for name, (off, size) in param_offsets(n_inputs, hidden,
                                           depth).items():
        out[name] = theta[:, off:off + size]
    head = depth + 1
    out["w1"] = out["w1"].reshape(n, n_inputs, hidden)
    for layer in range(2, head):
        out["w%d" % layer] = out["w%d" % layer].reshape(n, hidden, hidden)
    return out


def cost_and_grad(theta, xb, yb, shape, inv_b, inv_n, precision="float32"):
    """Cost ``(n, 1)`` and gradient ``(n, P)`` (weight prior excluded) of
    every chain on its own minibatch: ``xb`` ``(n, B, n_inputs)``, ``yb``
    ``(n, B)``; ``shape`` is ``(n_inputs, hidden, depth)``."""
    n_inputs, hidden, depth = shape
    n = theta.shape[0]
    p = unflatten(theta, n_inputs, hidden, depth)
    head = depth + 1
    acts = [torch.tanh(bmm(xb, p["w1"], precision) + p["b1"][:, None, :])]
    for layer in range(2, head):
        acts.append(torch.tanh(bmm(acts[-1], p["w%d" % layer], precision)
                               + p["b%d" % layer][:, None, :]))
    top = acts[-1]
    w_head = p["w%d" % head]
    mean = bmm(top, w_head[:, :, None], precision)[:, :, 0] + p["b%d" % head]
    log_var = p["log_variance_bias"]
    e_lv = torch.exp(log_var)
    var_inv = 1.0 / (e_lv + 1e-16)
    err = mean - yb
    sq = err * err
    log_like = torch.sum(-sq * (0.5 * var_inv) - 0.5 * log_var, dim=1,
                         keepdim=True) * inv_b
    dev = log_var - LOG_PRIOR_MEAN
    prior = -(dev * dev) / (2.0 * PRIOR_VAR) - 0.5 * math.log(PRIOR_VAR)
    cost = -(log_like + prior * inv_n)

    d_mean = err * var_inv * inv_b                          # (n, B)
    grads = {
        "w%d" % head: bmm(d_mean[:, None, :], top, precision)[:, 0],
        "b%d" % head: d_mean.sum(dim=1, keepdim=True),
        "log_variance_bias": (
            -torch.sum(sq * (0.5 * e_lv) * (var_inv * var_inv) - 0.5, dim=1,
                       keepdim=True) * inv_b + dev / PRIOR_VAR * inv_n),
    }
    dz = bmm(d_mean[:, :, None], w_head[:, None, :], precision) \
        * (1.0 - top * top)
    for layer in range(head - 1, 1, -1):
        below = acts[layer - 2]
        grads["w%d" % layer] = bmm(below.transpose(1, 2), dz, precision)
        grads["b%d" % layer] = dz.sum(dim=1)
        dz = bmm(dz, p["w%d" % layer].transpose(1, 2), precision) \
            * (1.0 - below * below)
    grads["w1"] = bmm(xb.transpose(1, 2), dz, precision)
    grads["b1"] = dz.sum(dim=1)
    flat = torch.cat([grads[name].reshape(n, -1) for name in param_offsets(
        n_inputs, hidden, depth)], dim=1)
    return cost, flat


def forward(theta, x, shape, precision="float32"):
    """Mean and log variance ``(n, Q)`` of every member at the points ``x``
    ``(Q, n_inputs)``."""
    n_inputs, hidden, depth = shape
    n = theta.shape[0]
    p = unflatten(theta, n_inputs, hidden, depth)
    head = depth + 1
    xs = x[None].expand(n, -1, -1)
    act = torch.tanh(bmm(xs, p["w1"], precision) + p["b1"][:, None, :])
    for layer in range(2, head):
        act = torch.tanh(bmm(act, p["w%d" % layer], precision)
                         + p["b%d" % layer][:, None, :])
    mean = bmm(act, p["w%d" % head][:, :, None], precision)[:, :, 0] \
        + p["b%d" % head]
    return mean, p["log_variance_bias"].expand_as(mean)


def sghmc_noise_scale(eps, scale_grad, mdecay, minv):
    """``sqrt(max(2 es^2 mdecay minv - es^4, 1e-16))``, ``es = eps /
    sqrt(scale_grad)`` in float32."""
    es = eps / torch.sqrt(torch.tensor(scale_grad, dtype=torch.float32,
                                       device=minv.device))
    es2 = es * es
    return torch.sqrt(torch.clamp(2.0 * es2 * mdecay * minv - es2 * es2,
                                  min=1e-16))


def adapt(tau, g, v_hat, gg):
    """The self-tuning burn-in's statistics (Springenberg et al. 2016), all
    reading old values: ``(minv, tau', g', v_hat')``, ``minv =
    1 / sqrt(old v_hat)`` with the reference's guards."""
    small = 1e-16
    root = torch.sqrt(torch.clamp(v_hat, min=0.0))
    minv = 1.0 / (root + 2.0 * torch.sign(root) * small + small)
    r = 1.0 / (tau + 1.0)
    tau_new = tau + (-g * g * tau) / (v_hat + 2.0 * torch.sign(v_hat) * small
                                      + small) + 1.0
    return minv, tau_new, g - r * g + r * gg, v_hat - r * v_hat + r * gg * gg


def svgd_phi(x, cost_grads, precision="float32"):
    """SVGD's direction (Liu & Wang 2016) with the RBF kernel and the
    median bandwidth ``h = sqrt(median(D) / (2 log(n + 1)))`` over all pairs
    (numpy's median): ``(K (-G) + (x sum_j K - K x) / h^2) / n``."""
    n = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * mm(x, x.T, precision),
                     min=0.0)
    ordered = torch.sort(d2.reshape(-1)).values
    mid = ordered.shape[0] // 2
    med = ordered[mid] if ordered.shape[0] % 2 else \
        0.5 * (ordered[mid - 1] + ordered[mid])
    h = torch.sqrt(0.5 * med / torch.log(torch.tensor(
        float(n), dtype=torch.float32, device=x.device) + 1.0))
    del ordered
    kernel = torch.exp(-d2 / (2.0 * h * h))
    del d2
    attract = mm(kernel, -cost_grads, precision)
    repulse = (x * kernel.sum(dim=1)[:, None] - mm(kernel, x, precision)) \
        / (h * h)
    return (attract + repulse) / float(n)
