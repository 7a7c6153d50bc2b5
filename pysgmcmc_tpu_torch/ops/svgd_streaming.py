"""Streaming SVGD transport on Hopper (PyTorch port of
:mod:`pysgmcmc_tpu.ops.svgd_streaming`, kernel B11).

The SVGD update needs three reductions over the n x n RBF kernel matrix::

    phi_i = (1/n) [ sum_j K_ij (-g_j)                          (attraction)
                  + (x_i sum_j K_ij - sum_j K_ij x_j) / h^2 ]  (repulsion)

    K_ij  = exp(-max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0) / (2 h^2))

:func:`svgd_phi_streaming` computes them without materialising ``K``: on
CUDA tensors it launches the hand-written kernel of
``csrc/svgd_streaming.cu`` (a row tile of particles per block, ``K`` one
tile at a time in shared memory, memory O(n d)); on CPU tensors it runs the
plain version :func:`svgd_phi_streaming_ref`, the JAX kernel's formula over
column chunks.  Nothing falls back from the kernel to the plain version.

Examples
--------
>>> import torch
>>> x = torch.randn(8, 2, generator=torch.Generator().manual_seed(0))
>>> phi = svgd_phi_streaming(x, -x, 1.0)
>>> tuple(phi.shape)
(8, 2)
"""

import torch

from pysgmcmc_tpu_torch.ops.fused_step import _require_device


def _check(name, particles, cost_grads):
    if (particles.ndim != 2 or particles.dtype != torch.float32
            or cost_grads.shape != particles.shape
            or cost_grads.dtype != torch.float32
            or cost_grads.device != particles.device):
        raise ValueError(
            "{}: particles and cost_grads must be float32 (n, d) tensors of "
            "one shape on one device; got {} {} on {} and {} {} on {}".format(
                name, particles.dtype, tuple(particles.shape),
                particles.device, cost_grads.dtype, tuple(cost_grads.shape),
                cost_grads.device))


def _bandwidth(h, device):
    """``h`` as a float32 0-d tensor on ``device``; a host value is filled
    in on the device, so no copy waits on the stream."""
    if torch.is_tensor(h):
        if h.numel() != 1:
            raise ValueError("svgd_phi_streaming: h must be a scalar; got "
                             "shape {}".format(tuple(h.shape)))
        if h.device.type == device.type:
            return h.reshape(()).to(device=device, dtype=torch.float32)
        h = float(h)
    return torch.full((), float(h), dtype=torch.float32, device=device)


def svgd_phi_streaming_ref(particles, cost_grads, h, tile=512):
    """The plain version: the JAX kernel's formula in PyTorch, over column
    chunks of ``tile`` particles (each chunk's ``(n, tile)`` block of ``K``
    at a time).  Returns phi ``(n, d)``."""
    _check("svgd_phi_streaming_ref", particles, cost_grads)
    x, g = particles, cost_grads
    n = x.shape[0]
    h = _bandwidth(h, x.device)
    inv_two_h2 = 1.0 / (2.0 * h * h)
    sq_norms = torch.sum(x * x, dim=1)
    k_dot_g = torch.zeros_like(x)
    k_dot_x = torch.zeros_like(x)
    ksum = torch.zeros_like(sq_norms)
    tile = max(1, int(tile))
    for j0 in range(0, n, tile):
        x_j = x[j0:j0 + tile]
        d2 = (sq_norms[:, None] + sq_norms[None, j0:j0 + tile]
              - 2.0 * torch.matmul(x, x_j.T))
        kernel = torch.exp(-torch.clamp(d2, min=0.0) * inv_two_h2)
        k_dot_g += torch.matmul(kernel, -g[j0:j0 + tile])
        k_dot_x += torch.matmul(kernel, x_j)
        ksum += torch.sum(kernel, dim=1)
    repulsion = (x * ksum[:, None] - k_dot_x) / (h * h)
    return (k_dot_g + repulsion) / float(n)


def svgd_phi_streaming(particles, cost_grads, h, tile=512, interpret=False):
    """SVGD transport direction phi ``(n, d)`` (kernel B11), without
    materialising the kernel matrix.

    ``particles`` and ``cost_grads`` (gradients of the COST, the negative
    log density) are float32 ``(n, d)``, any ``n`` and ``d``; ``h`` is the
    bandwidth, a float or a scalar tensor (on the card a device scalar,
    read by the kernel without a host sync).  CUDA tensors launch the
    kernel, whose tiles are its own design; CPU tensors run
    :func:`svgd_phi_streaming_ref` with column chunks of ``tile``.
    ``interpret=True`` (the JAX kernel's interpret mode) asks for the plain
    version, which runs on CPU tensors only: on CUDA tensors it raises.
    The caller applies the stepsize and Adagrad.
    """
    name = "svgd_phi_streaming"
    _check(name, particles, cost_grads)
    if not _require_device(name, particles):
        return svgd_phi_streaming_ref(particles, cost_grads, h, tile)
    if interpret:
        raise ValueError(
            "{}: interpret=True runs the plain version, on CPU tensors only; "
            "CUDA tensors launch the kernel (pass interpret=False)".format(
                name))
    from pysgmcmc_tpu_torch.ops import _build

    x, g = particles.contiguous(), cost_grads.contiguous()
    n, d = x.shape
    h = _bandwidth(h, x.device).contiguous()
    phi = torch.empty_like(x)
    rhs = torch.empty_like(x)  # scratch: -g - x / h^2
    sq_norms = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _build.load("svgd_streaming")
    with torch.cuda.device(x.device):  # the launch uses the current device
        _build.check(lib.svgd_phi_streaming_launch(
            x.data_ptr(), g.data_ptr(), h.data_ptr(), phi.data_ptr(),
            rhs.data_ptr(), sq_norms.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream), "svgd_streaming")
    svgd_phi_streaming.launches += 1
    return phi


svgd_phi_streaming.launches = 0


__all__ = ["svgd_phi_streaming", "svgd_phi_streaming_ref"]
