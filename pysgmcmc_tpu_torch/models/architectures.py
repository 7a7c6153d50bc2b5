"""Network architectures for Bayesian neural networks (PyTorch port of
:mod:`pysgmcmc_tpu.models.architectures`).

The reference's ``len(units)``-layer tanh heteroscedastic regression net:
tanh hidden layers, a linear mean head, and a learned log-variance output
bias (initialised to ``log(1e-3)``) as the second output column.  Weights
are He-normal (fan-in, normal truncated at two standard deviations), biases
zero.  Parameters are a dict of tensors with the JAX package's key names and
shapes, in the order ``w1, b1, ..., w{L}, b{L}, log_variance_bias``:
:func:`default_network` has the reference's shapes, :func:`dense_network`
the fused kernels' (``w1`` is ``(H,)`` for one input, the head weight is
``(H,)``); ``log_variance_bias`` is ``(1, 1)``.  Any leading axes (chains,
ensemble members) broadcast through ``apply``.  ``apply`` casts the input to
the network's ``dtype`` and promotes mixed operands as ``jnp.dot`` does
(``torch.promote_types``): bf16 weights in a float32 network compute in
float32, as in the JAX package, and bf16 weights in a bf16 network in bf16.

Examples
--------
>>> import torch
>>> init, apply = dense_network(n_inputs=1, device="cpu")
>>> params = init(torch.Generator().manual_seed(0))
>>> params["w1"].shape, params["w4"].shape, params["log_variance_bias"].shape
(torch.Size([50]), torch.Size([50]), torch.Size([1, 1]))
>>> apply(params, torch.zeros(5, 1)).shape
torch.Size([5, 2])
>>> ref_init, ref_apply = default_network(n_inputs=1, device="cpu")
>>> ref = ref_init(torch.Generator().manual_seed(0))
>>> ref["w1"].shape, ref["w4"].shape
(torch.Size([1, 50]), torch.Size([50, 1]))
>>> torch.equal(ref["w4"][:, 0], params["w4"])  # the same draws
True
"""

import math

import torch

# stddev correction of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's "truncated_normal" constant)
_TRUNC_STD = 0.87962566103423978


def _matmul(a, b):
    """``torch.matmul`` on operands promoted to their common type, as
    ``jnp.dot`` promotes (``torch.matmul`` refuses mixed types)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dtype), b.to(dtype))


def default_network(n_inputs, units=(50, 50, 50), dtype=torch.float32, *,
                    device="cuda"):
    """The reference BNN architecture as an ``(init, apply)`` pair, with the
    reference's parameter shapes (``w1`` ``(n_inputs, H)``, the head weight
    ``(H, 1)``).

    ``init(generator, batch_shape=())`` draws one network per element of
    ``batch_shape`` (e.g. ``(n_chains,)``) on ``device`` (the card unless
    ``"cpu"`` is asked for) from the ``torch.Generator``, one layer after
    the other; ``apply(params, x)`` maps ``(..., N, n_inputs)`` inputs to
    ``(..., N, 2)``: column 0 the predicted mean, column 1 the
    (input-independent, learned) log predictive variance.  Leading axes of
    the parameters broadcast.
    """
    layer_sizes = [n_inputs, *units, 1]
    n_layers = len(layer_sizes) - 1

    def init(generator, batch_shape=()):
        batch_shape = tuple(batch_shape)
        params = {}
        for i, (fan_in, fan_out) in enumerate(
                zip(layer_sizes[:-1], layer_sizes[1:])):
            w = torch.empty(batch_shape + (fan_in, fan_out), dtype=dtype,
                            device=device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            params["w{}".format(i + 1)] = w * (
                math.sqrt(1.0 / fan_in) / _TRUNC_STD)
            params["b{}".format(i + 1)] = torch.zeros(
                batch_shape + (fan_out,), dtype=dtype, device=device)
        params["log_variance_bias"] = torch.full(
            batch_shape + (1, 1), math.log(1e-3), dtype=dtype, device=device)
        return params

    def apply(params, x):
        h = torch.as_tensor(x, dtype=dtype)
        for i in range(1, n_layers):
            h = torch.tanh(_matmul(h, params["w{}".format(i)])
                           + params["b{}".format(i)][..., None, :])
        mean = (_matmul(h, params["w{}".format(n_layers)])
                + params["b{}".format(n_layers)][..., None, :])
        log_var = params["log_variance_bias"].expand(mean.shape)
        out_dtype = torch.promote_types(mean.dtype, log_var.dtype)
        return torch.cat([mean.to(out_dtype), log_var.to(out_dtype)], dim=-1)

    return init, apply


def dense_network(n_inputs, units=(50, 50, 50), dtype=torch.float32, *,
                  device="cuda"):
    """The same architecture with the fused kernels' parameter shapes:
    ``w1`` is ``(H,)`` for one input and the head weight is ``(H,)``.

    ``init`` draws at the reference shapes through :func:`default_network`
    and squeezes, so one generator gives both networks the same weights,
    and packed in dict order the two have the same flat vector.
    ``apply`` as :func:`default_network`'s.
    """
    ref_init, _ = default_network(n_inputs, units, dtype, device=device)
    n_layers = len(units) + 1
    head = "w{}".format(n_layers)
    squeeze_first = n_inputs == 1

    def init(generator, batch_shape=()):
        params = ref_init(generator, batch_shape)
        if squeeze_first:
            params["w1"] = params["w1"][..., 0, :]
        params[head] = params[head][..., 0]
        return params

    def apply(params, x):
        x = torch.as_tensor(x, dtype=dtype)
        w1 = params["w1"]
        if squeeze_first:
            h = torch.tanh(x * w1[..., None, :] + params["b1"][..., None, :])
        else:
            h = torch.tanh(_matmul(x, w1) + params["b1"][..., None, :])
        for i in range(2, n_layers):
            h = torch.tanh(_matmul(h, params["w{}".format(i)])
                           + params["b{}".format(i)][..., None, :])
        mean = (_matmul(h, params[head][..., :, None])[..., 0]
                + params["b{}".format(n_layers)])
        log_var = params["log_variance_bias"][..., 0].expand(mean.shape)
        out_dtype = torch.promote_types(mean.dtype, log_var.dtype)
        return torch.stack([mean.to(out_dtype), log_var.to(out_dtype)],
                           dim=-1)

    return init, apply
