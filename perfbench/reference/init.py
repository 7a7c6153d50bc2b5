"""The initial weights of the network, in plain PyTorch: every hidden and
output layer's ``(fan_in, fan_out)`` weights He-normal (a unit normal
truncated to [-2, 2] by ``torch.nn.init.trunc_normal_``, scaled by
``sqrt(1 / fan_in) / 0.8796...``), drawn one layer after the other from one
``torch.Generator`` seeded with the run's seed on the device; biases 0, the
log-variance bias ``log(1e-3)``.  Flattened in the order of
:func:`perfbench.reference.stream.param_offsets`.
"""

import math

import torch

_TRUNC_STD = 0.87962566103423978


def initial_weights(seed, n_members, n_inputs, hidden, depth, device):
    generator = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [n_inputs] + [hidden] * depth + [1]
    parts = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.empty((n_members, fan_in, fan_out), dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        w = w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        parts += [w.reshape(n_members, -1),
                  torch.zeros((n_members, fan_out), dtype=torch.float32,
                              device=device)]
    parts.append(torch.full((n_members, 1), math.log(1e-3),
                            dtype=torch.float32, device=device))
    return torch.cat(parts, dim=1)
