"""The random stream of the fused BNN samplers, in plain PyTorch.

Philox4x32-10 (Salmon et al. 2011) keyed by a 64-bit seed, on the counter
``(chain, absolute step, draw, purpose)``; uniforms ``((bits >> 8) + 1) *
2**-24`` in (0, 1]; a chain's minibatch window at a step is ``min(floor(u *
n_windows), n_windows - 1)`` of the first word of draw 0, purpose 0.

The normals are the MXU-CLT generator (JAX's ``noise_impl="hadamard_clt"``):
the parameters are laid out in slots (each hidden matrix an ``s x s`` slab
with its bias in row ``bias_row``, two slabs side by side; eight vector rows
of ``s`` lanes for the first layer's weights and bias, the head's weights,
then the head's bias and the log-variance bias); each row of ``n`` slots is
one group of ``n`` uniforms from ``n / 4`` draws of purpose 2, and gives
``n`` normals ``fwht(bf16(u - 1/2)) * sqrt(12 / n)``.

Everything is int64 and float32 arithmetic in a fixed order, so that the
card and the CPU draw the same bits.  Nothing here imports the program.
"""

import math

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
WINDOW, CLT = 0, 2


def draw_seed(generator):
    """The 63-bit key a fused driver call draws from its ``generator``."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=generator.device))


def _mulhilo(a, m):
    lo16, hi16 = m & 0xFFFF, m >> 16
    t = a * lo16
    u = a * hi16
    return (u + (t >> 16)) >> 16, (((u & 0xFFFF) << 16) + t) & MASK32


def philox(c0, c1, c2, c3, seed):
    """The four 32-bit output words (int64) of Philox4x32-10 at the counter
    ``(c0, c1, c2, c3)`` (broadcastable int64 tensors or ints)."""
    k0, k1 = seed & MASK32, seed >> 32
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(bits):
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)


def windows(seed, steps, chains, n_windows):
    """Window index ``(len(steps), len(chains))`` of each chain at each
    absolute step."""
    bits = philox(chains[None, :], (steps[:, None] & MASK32), 0, WINDOW,
                  seed)[0]
    u = uniform(bits)
    return torch.clamp((u * n_windows).to(torch.int64), max=n_windows - 1)


def param_offsets(n_inputs, hidden, depth):
    """``{name: (offset, size)}`` of the flat per-chain vector: ``w1, b1,
    w2, b2, ..., w_head, b_head, log_variance_bias``, matrices row-major
    ``(in, out)``."""
    sizes = [("w1", n_inputs * hidden), ("b1", hidden)]
    for layer in range(2, depth + 1):
        sizes += [("w%d" % layer, hidden * hidden), ("b%d" % layer, hidden)]
    sizes += [("w%d" % (depth + 1), hidden), ("b%d" % (depth + 1), 1),
              ("log_variance_bias", 1)]
    out, offset = {}, 0
    for name, size in sizes:
        out[name] = (offset, size)
        offset += size
    return out


def n_params(n_inputs, hidden, depth):
    return sum(size for _, size in param_offsets(n_inputs, hidden,
                                                 depth).values())


def clt_groups(n_inputs, hidden, depth):
    """The CLT slot geometry: ``[(first slot, element map), ...]``, each map
    ``(rows, n)`` giving each slot's flat element, -1 where dead."""
    s, bias_row = (64, 50) if hidden <= 50 else (128, 114)
    off = {name: o for name, (o, _) in param_offsets(
        n_inputs, hidden, depth).items()}
    h, k, head = hidden, n_inputs, depth + 1

    def slab(layer):
        m = torch.full((s, s), -1, dtype=torch.int64)
        m[:h, :h] = off["w%d" % layer] + torch.arange(h * h).reshape(h, h)
        m[bias_row, :h] = off["b%d" % layer] + torch.arange(h)
        return m

    mats = [slab(layer) for layer in range(2, head)]
    arrays = [torch.cat(mats[i:i + 2], dim=1)
              for i in range(0, len(mats) - 1, 2)]
    if len(mats) % 2:
        arrays.append(mats[-1])
    vec = torch.full((8, s), -1, dtype=torch.int64)
    vec[:k, :h] = off["w1"] + torch.arange(k * h).reshape(k, h)
    vec[k, :h] = off["b1"] + torch.arange(h)
    vec[k + 1, :h] = off["w%d" % head] + torch.arange(h)
    vec[k + 2, 0] = off["b%d" % head]
    vec[k + 2, 1] = off["log_variance_bias"]
    arrays.append(vec)
    groups, slot = [], 0
    for emap in arrays:
        groups.append((slot, emap))
        slot += emap.numel()
    return groups


def fwht(x):
    """``x @ H_n`` on the last axis: stages of stride 1, 2, 4, ..., each
    taking ``(a, b)`` at ``(i, i + stride)`` to ``(a + b, a - b)``."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    stride = 1
    while stride < n:
        y = x.reshape(*lead, n // (2 * stride), 2, stride)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        stride *= 2
    return x


def clt_normals(seed, steps, chains, n_inputs, hidden, depth):
    """The CLT normals ``(len(steps), len(chains), P)`` of the given chains
    at the given absolute steps."""
    device = chains.device
    p = n_params(n_inputs, hidden, depth)
    out = torch.empty((len(steps), len(chains), p), dtype=torch.float32,
                      device=device)
    for slot, emap in clt_groups(n_inputs, hidden, depth):
        n = emap.shape[1]
        live = torch.nonzero((emap >= 0).any(dim=1))[:, 0]
        emap = emap[live].to(device)
        ctr = ((slot + live.to(device)[:, None] * n) // 4
               + torch.arange(n // 4, dtype=torch.int64, device=device))
        words = philox(chains[None, :, None, None],
                       (steps[:, None, None, None] & MASK32),
                       ctr[None, None], CLT, seed)
        u = uniform(torch.stack(words, dim=-2))  # (t, c, rows, 4, n / 4)
        u = u.reshape(len(steps), len(chains), -1, n)
        x = (u - 0.5).to(torch.bfloat16).to(torch.float32)
        z = fwht(x) * torch.tensor(math.sqrt(12.0 / n), dtype=torch.float32,
                                   device=device)
        keep = emap >= 0
        out[:, :, emap[keep]] = z[:, :, keep]
    return out
