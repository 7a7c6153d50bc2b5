"""The work of SVGD's transport direction for ``n`` particles of ``d``
parameters (Liu & Wang 2016), counted from the algorithm: phi = (K (-G) +
(x sum_j K - K x) / h^2) / n with the RBF kernel K of the bandwidth h.

Products: the Gram matrix x x^T, K G and K x, ``2 n^2 d`` each.  Float32:
per pair the squared distance from the Gram (3), its scaling and the exp
(2) and the row sum (1); per element the repulsion and the sum (5).  Bytes:
the particles and gradients read once, phi written once.
"""


def work(n, d):
    return dict(tc_flops=6 * n * n * d, f32_flops=6 * n * n + 5 * n * d,
                bytes=4 * 3 * n * d)
