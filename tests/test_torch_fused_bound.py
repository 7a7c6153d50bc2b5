"""The operation count behind the fused kernels' ``bound_ms`` in
``chip_smoke.py``'s ``kernels`` line: the products of a chain-step (the
hidden layers' on the tensor cores, the rest on the CUDA cores), the
update rule, and the normals each variant draws (Box-Muller's Philox draw
and transforms per four parameters as the slim kernels count them; the MXU-CLT
generator's Philox words, bf16 inputs, Walsh-Hadamard adds and scaling per
group).  CPU only: the counts follow from the shapes."""

import pytest

import chip_smoke as cs
from pysgmcmc_tpu_torch.ops import fused_step as fs

FLAGSHIP = fs.FusedLayout(1, 50, 3)  # 3x50 tanh, P = 5,252


def _clt_ops_by_kernel_groups(lay):
    """The CLT's operations counted over the kernel's own enumeration of
    groups (``clt_groups`` / ``clt_group`` in ``csrc/fused_body.cuh``): the
    matrix slabs in pairs of 2s lanes and an odd last one of s, then
    n_inputs + 3 vector rows of s, each with H + 1 rows per matrix section;
    a group of n draws n / 4 Philox words and transforms all n."""
    h, k = lay.hidden, lay.n_inputs
    s = 64 if h <= 50 else 128
    n_mats = lay.depth - 1
    sizes = ([2 * s] * (n_mats // 2) + [s] * (n_mats % 2)) * (h + 1)
    sizes += [s] * (k + 3)
    per_group = sum(cs.PHILOX_OPS * n // 4 + 7 * n
                    + n * (n.bit_length() - 1) for n in sizes)
    return per_group + lay.n_params  # one scaling multiply per parameter


def test_fused_bound_counts_at_the_flagship():
    assert FLAGSHIP.n_params == 5252
    assert cs._product_flops(FLAGSHIP, 20) == 608_000
    # a Box-Muller draw: Philox 98, four uniforms 16, two pairs' log,
    # root, sine, cosine and 4 multiplies 16; four normals
    assert cs.DRAW_OPS == 130 and cs.NOISE_OPS == 32.5
    assert cs._noise_ops(FLAGSHIP, "box_muller") == 130 * 1313 == 170_690
    assert cs._noise_ops(FLAGSHIP, "paired") == 170_690
    # 51 groups of 128 (w2 | w3 by rows, bias row included: 100 values
    # each) and 4 of 64 (w1, b1, w_head, then b_head and lvb)
    assert cs._noise_ops(FLAGSHIP, "hadamard_clt") == (
        51 * (98 * 32 + 7 * 128 + 128 * 7) + 4 * (98 * 16 + 7 * 64 + 64 * 6)
        + 5252) == 266_180
    # of the 608,000 product flops, the hidden layers' 600,000 run on the
    # tensor cores; layer 1's and the head's 8,000 on the CUDA cores
    assert cs._tc_product_flops(FLAGSHIP, 20) == 600_000
    for record, variant, noise in (("B1", "box_muller", 170_690),
                                   ("B1 (clt)", "hadamard_clt", 266_180),
                                   ("B1 (bf16, paired)", "paired", 170_690)):
        assert cs._variant_of(record) == variant
        assert cs._flops_per_chain_step(
            FLAGSHIP, 20, cs.RULE_FLOPS["B1"], variant) == (
            600_000, 8_000 + 19 * 5252 + noise)
    # B1 at 8192 chains x 200 steps: the products as 3xTF32 take 5.96 ms,
    # the rest at the f32 peak 6.81 ms (17.02 ms with a draw per normal;
    # 17.31 ms with all the products at the f32 peak and no normals); under
    # the CLT 9.14 ms
    ms, by = cs._bound(8192, 200, cs._flops_per_chain_step(
        FLAGSHIP, 20, cs.RULE_FLOPS["B1"]), 0)
    assert by == "operations" and ms == pytest.approx(6.8098, abs=1e-4)
    assert 3.0 * 8192 * 200 * cs._tc_product_flops(FLAGSHIP, 20) \
        / cs.TF32_FLOPS * 1e3 == pytest.approx(5.9578, abs=1e-4)
    ms, _ = cs._bound(8192, 200, cs._flops_per_chain_step(
        FLAGSHIP, 20, cs.RULE_FLOPS["B1"], "hadamard_clt"), 0)
    assert ms == pytest.approx(9.1449, abs=1e-4)
    # where the bytes take longer, they bound the launch
    assert cs._bound(8192, 1, cs._flops_per_chain_step(
        FLAGSHIP, 20, cs.RULE_FLOPS["B3"]), 1e9)[1] == "bytes"


@pytest.mark.parametrize("h,depth", [(13, 2), (13, 3), (50, 2), (50, 4),
                                     (100, 3), (114, 3)])
def test_clt_count_follows_the_kernel_groups(h, depth):
    """The CLT count from the plain version's geometry equals the count
    over the kernel's groups, at both slot widths and odd and even numbers
    of matrix slabs."""
    lay = fs.FusedLayout(1, h, depth)
    assert cs._noise_ops(lay, "hadamard_clt") == \
        _clt_ops_by_kernel_groups(lay)
    assert cs._noise_ops(lay, "box_muller") == \
        cs.DRAW_OPS * ((lay.n_params + 3) // 4)
