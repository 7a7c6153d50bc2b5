"""The work of the regression network's passes, counted from the algorithm
and the shapes: ``shape`` is ``(n_inputs, hidden, depth)``.

Products (a multiply-add is two operations): the forward pass of every
layer, each layer's weight gradient, and the input gradient of every layer
but the first.  Elementwise (float32) operations: per hidden activation the
bias add and the tanh forward, and backward the tanh derivative ``1 - a^2``
times the incoming gradient (3) and the bias gradient's sum; per point the
head's bias, the loss (6) and the two output gradients (7); per chain the
variance's exp and the log-variance prior (8).
"""


def layer_sizes(shape):
    n_inputs, hidden, depth = shape
    return [n_inputs] + [hidden] * depth + [1]


def forward_products(shape, points):
    """Operations of the forward products for ``points`` inputs."""
    sizes = layer_sizes(shape)
    return 2 * points * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def gradient_products(shape, batch):
    """Operations of one chain's forward and backward products on a
    minibatch of ``batch`` points."""
    sizes = layer_sizes(shape)
    macs = [a * b for a, b in zip(sizes[:-1], sizes[1:])]
    return 2 * batch * (2 * sum(macs) + sum(macs[1:]))


def gradient_elementwise(shape, batch):
    """Float32 elementwise operations of one chain's cost and gradient."""
    _, hidden, depth = shape
    acts = depth * batch * hidden
    return 2 * acts + 4 * acts + batch + 6 * batch + 7 * batch + 8


def forward_elementwise(shape, points):
    """Float32 elementwise operations of the forward pass: bias add and
    tanh per hidden activation, the head's bias per point."""
    _, hidden, depth = shape
    return 2 * depth * points * hidden + points
