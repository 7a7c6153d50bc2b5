"""The paired fused kernels of the PyTorch port (JAX's ``pair_dots=True``)
against the JAX package.

JAX's paired kernels pack chain pairs block-diagonally for the MXU; what
carries over is that they compute the unpaired kernels' updates, except
that at bf16 state they keep the matrix slabs' momentum (``w2, b2, w3,
b3``) float32 for a whole launch and round it once, at its end, and that
JAX's drivers cut launches at 512 steps.  The port's plain versions with
``pair_dots=True`` are held against

(a) JAX's paired kernels in interpret mode on the zero-bit stream, over two
    launches: at float32 state within the unpaired tests' bounds, at bf16
    state with one bf16 ulp more on the momentum (one rounding in all);
(a') the same, B1, B2, B5-sgnht and B5-rsghmc at bf16 state, on a
    workload whose updates are elementwise: the bf16 momentum element by
    element, paired and unpaired, and what pairing moved (the matrix slabs
    only), with the per-step rounding shown to fail;
(b) the unpaired plain versions: equal bit for bit at float32 state, and
    apart at bf16 state only where the rounding moved;
(c) JAX's refusals, each a ``ValueError``;

and the paired BNN slice against JAX's.  The CUDA kernels are held against
these plain versions, and paired against unpaired, on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.models.bayesian_neural_network import (
    BayesianNeuralNetwork as JaxBNN,
)
from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.parallel import (
    MAX_STEPS_PER_LAUNCH,
    burnin_chain_fused,
    sample_chain_fused,
)
from pysgmcmc_tpu_torch.parallel.packed import _launch_segments
from tests.test_torch_bnn import (
    MEAN_ATOL,
    SAMPLES_ATOL,
    SLICE,
    VAR_ATOL,
    _data,
    _port_bnn,
)
from tests.test_torch_fused_samplers import (
    COMMON,
    MULTI,
    MULTI_TOL,
    RULES,
    _check_states,
    _jax_args,
    _jax_kw,
    _port_args,
    _state,
)
from tests.test_torch_fused_step import (
    B1_PALLAS_TOL,
    B2_PALLAS_TOL,
    BATCH,
    EPS,
    H,
    LAYOUT,
    MDECAY,
    N_DATA,
    NAMES,
    P,
    PRIOR,
    to_flat,
    to_tree,
    windows,
    workload,
)
from tests.test_torch_one_step import WIDX, _inputs
from tests.test_torch_sgld import (
    A_COEF,
    B5_PALLAS_TOL,
    B6_PALLAS_TOL,
    PALLAS_EPS,
)

LAUNCHES = (2, 2)  # steps of the two launches (one compile of JAX's)
SGHMC = dict(mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
             batch_size=BATCH, n_data=N_DATA)
SGLD = dict(SGHMC, a_coef=A_COEF)
del SGLD["mdecay"]


def _ulp(x):
    """One bf16 ulp of each |value| (2**-7 of its binade; 0 at 0)."""
    x = np.abs(np.asarray(x, np.float32))
    return np.where(x > 0, np.exp2(np.floor(np.log2(np.maximum(
        x, 1e-38))) - 7), 0.0)


def _close(got, want, label, rtol=0.0, atol=0.0, ulps=0):
    """``got`` within ``atol + rtol |want|`` plus ``ulps`` bf16 ulps of
    each value of ``want``."""
    for key in want:
        w = np.asarray(want[key], np.float32)
        diff = np.abs(np.asarray(got[key], np.float32) - w)
        bound = atol + rtol * np.abs(w) + ulps * _ulp(w)
        assert np.all(diff <= bound), "{} {}: {} beyond".format(
            label, key, float((diff - bound).max()))


def _zero(k, n):
    return dict(noise=torch.zeros((k, n, P)),
                widx=torch.zeros((k, n), dtype=torch.int32))


def _launches(fn, state, n_state, step_kw):
    """Two launches of ``LAUNCHES`` steps, the second from the first's
    state (its first ``n_state`` outputs), the frozen inputs kept."""
    out, step0 = None, 0
    for k in LAUNCHES:
        out = fn(state, k, step0, **step_kw(k))
        state = list(out[:n_state]) + list(state[n_state:])
        step0 += k
    return out


#  (a) against JAX's paired kernels in interpret mode -------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paired_sghmc_sampling_matches_pallas_kernel(dtype):
    n = 2
    x, y, st = workload(n, seed=41)
    xw, yw = windows(x, y)
    jw = jfs.data_windows(x, y, BATCH)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _launches(
        lambda s, k, step0: jfs.fused_bnn_multistep(
            *s, *jw, EPS, 0, block_chains=n, state_dtype=jdt, k_steps=k,
            pair_dots=True, interpret=True, **SGHMC),
        [jfs.pack_fused(st["theta"]),
         tuple(a.astype(jdt) for a in jfs.pack_fused(st["v"])),
         tuple(a.astype(jdt) for a in jfs.pack_fused(st["minv"]))],
        2, lambda k: {})
    got = _launches(
        lambda s, k, step0, **kw: fs.fused_bnn_multistep_ref(
            *s, xw, yw, EPS, 0, state_dtype=tdt, k_steps=k, step0=step0,
            pair_dots=True, **SGHMC, **kw),
        [to_flat(st["theta"]), to_flat(st["v"]).to(tdt),
         to_flat(st["minv"]).to(tdt)], 2, lambda k: _zero(k, n))
    assert got[1].dtype == tdt
    ulps = len(LAUNCHES) if dtype == "bfloat16" else 0
    _close(to_tree(got[0]), jfs.unpack_fused(want[0], H), "B1-pair theta",
           **B1_PALLAS_TOL["theta"])
    _close(to_tree(got[1].float()), jfs.unpack_fused(
        tuple(a.astype(jnp.float32) for a in want[1]), H), "B1-pair v",
        ulps=ulps, **B1_PALLAS_TOL["v"])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paired_sghmc_burnin_matches_pallas_kernel(dtype):
    n = 2
    x, y, st = workload(n, seed=42)
    xw, yw = windows(x, y)
    jw = jfs.data_windows(x, y, BATCH)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    start = [jfs.pack_fused(st[name]) for name in NAMES]
    start[1] = tuple(a.astype(jdt) for a in start[1])
    want = _launches(
        lambda s, k, step0: jfs.fused_bnn_multistep_burnin(
            *s, *jw, EPS, 0, block_chains=n, state_dtype=jdt, k_steps=k,
            pair_dots=True, interpret=True, **SGHMC), start, 5,
        lambda k: {})
    start = [to_flat(st[name]) for name in NAMES]
    start[1] = start[1].to(tdt)
    got = _launches(
        lambda s, k, step0, **kw: fs.fused_bnn_multistep_burnin_ref(
            *s, xw, yw, EPS, 0, state_dtype=tdt, k_steps=k, step0=step0,
            pair_dots=True, **SGHMC, **kw), start, 5,
        lambda k: _zero(k, n))
    for i, name in enumerate(NAMES + ("minv",)):
        ulps = len(LAUNCHES) if name == "v" and dtype == "bfloat16" else 0
        want_tree = jfs.unpack_fused(
            tuple(a.astype(jnp.float32) for a in want[i]), H)
        _close(to_tree(got[i].float()), want_tree, "B2-pair " + name,
               ulps=ulps, **B2_PALLAS_TOL[name])


def test_paired_sgld_kernels_match_pallas_kernels():
    n = 2
    names = ("theta", "tau", "g", "v_hat")
    x, y, st = workload(n, seed=43)
    xw, yw = windows(x, y)
    jw = jfs.data_windows(x, y, BATCH)
    want = _launches(
        lambda s, k, step0: jfs.fused_bnn_multistep_burnin_sgld(
            *s, *jw, PALLAS_EPS, 0, block_chains=n, k_steps=k,
            pair_dots=True, interpret=True, **SGLD),
        [jfs.pack_fused(st[name]) for name in names], 4, lambda k: {})
    got = _launches(
        lambda s, k, step0, **kw: fs.fused_bnn_multistep_burnin_sgld_ref(
            *s, xw, yw, PALLAS_EPS, 0, k_steps=k, step0=step0,
            pair_dots=True, **SGLD, **kw),
        [to_flat(st[name]) for name in names], 4, lambda k: _zero(k, n))
    for i, name in enumerate(names + ("minv",)):
        _close(to_tree(got[i]), jfs.unpack_fused(want[i], H),
               "B6-pair " + name, **B6_PALLAS_TOL[name])
    want = _launches(
        lambda s, k, step0: jfs.fused_bnn_multistep_sgld(
            *s, *jw, PALLAS_EPS, 0, block_chains=n, k_steps=k,
            pair_dots=True, interpret=True, **SGLD),
        [jfs.pack_fused(st["theta"]), jfs.pack_fused(st["minv"])], 1,
        lambda k: {})
    got = _launches(
        lambda s, k, step0, **kw: fs.fused_bnn_multistep_sgld_ref(
            *s, xw, yw, PALLAS_EPS, 0, k_steps=k, step0=step0,
            pair_dots=True, **SGLD, **kw),
        [to_flat(st["theta"]), to_flat(st["minv"])], 1,
        lambda k: _zero(k, n))
    _close(to_tree(got[0]), jfs.unpack_fused(want[0], H), "B5-sgld-pair",
           **B5_PALLAS_TOL["theta"])


@pytest.mark.parametrize("kind", sorted(RULES))
def test_paired_rules_match_pallas_kernels(kind):
    """B5-psgld, B5-sgnht and B5-rsghmc paired, float32 state."""
    x, y, st, _, _, _ = _inputs(seed=44)
    state = _state(kind, st, seed=45)
    ref, jax_fn = MULTI[kind]
    eps = RULES[kind][1]
    jw = jfs.data_windows(x, y, BATCH)
    jax_kw = dict(_jax_kw(kind), h=H, pair_dots=True)
    if kind != "psgld":
        jax_kw["state_dtype"] = np.float32
    n_state = 3 if kind == "sgnht" else 2
    want = _launches(
        lambda s, k, step0: jax_fn(*s, *jw, eps, 0, k_steps=k, **jax_kw),
        _jax_args(kind, state), n_state, lambda k: {})
    xw, yw = windows(x, y)
    got = _launches(
        lambda s, k, step0, **kw: ref(
            *s, xw, yw, eps, 0, k_steps=k, step0=step0, pair_dots=True,
            **RULES[kind][0], **COMMON, **kw),
        _port_args(kind, state), n_state, lambda k: _zero(k, WIDX.size))
    _check_states(kind, got, want, MULTI_TOL[kind], kind + "-pair")


#  (a') the one rounding per launch against JAX's, element by element --------
#
# JAX's kernels take the network's products on bf16 operands (the MXU's),
# which the port does not share, so on the workloads above the two bf16
# momenta lie many bf16 ulps apart, more than the rounding schedule moves
# them.  A log-variance bias of QUIET_LVB scales the data term by e^-60:
# the gradient is then the prior's alone, far below an f32 ulp of the
# momentum, and every update is elementwise, the same float32 arithmetic
# on both sides.  There JAX's paired and unpaired kernels and the port's
# plain versions keep the same bf16 momentum element by element, and the
# paired schedule moves the matrix slabs' momentum (w2..b3) and nothing
# else, on a share of elements this comparison sees.

QUIET_LVB = 60.0
# elements allowed to lie one bf16 ulp apart (an f32 result that straddles
# a rounding boundary by the two sides' last-bit differences)
QUIET_FLIPS = 1e-3
# relativistic SGHMC moves the momentum by friction alone here, 1e-3 of it
# a step at its test stepsize, under half a bf16 ulp: this stepsize moves it
QUIET_EPS = {"sgnht": RULES["sgnht"][1], "rsghmc": 1e-2}


def _quiet(st):
    theta = dict(st["theta"])
    theta["log_variance_bias"] = np.full_like(theta["log_variance_bias"],
                                              QUIET_LVB)
    return dict(st, theta=theta)


def _quiet_sghmc(burnin, side, pair_dots):
    """The bf16 momentum after two launches of B2 (``burnin``) or B1 on the
    quiet workload, as a float32 ``(n, P)`` array."""
    n = 2
    x, y, st = workload(n, seed=53)
    st = _quiet(st)
    names = NAMES if burnin else ("theta", "v", "minv")
    n_state = 5 if burnin else 2
    bf16 = ("v",) if burnin else ("v", "minv")
    if side == "jax":
        fn = (jfs.fused_bnn_multistep_burnin if burnin
              else jfs.fused_bnn_multistep)
        jw = jfs.data_windows(x, y, BATCH)
        start = [tuple(a.astype(jnp.bfloat16) for a in jfs.pack_fused(st[k]))
                 if k in bf16 else jfs.pack_fused(st[k]) for k in names]
        out = _launches(
            lambda s, k, step0: fn(
                *s, *jw, EPS, 0, block_chains=n, state_dtype=jnp.bfloat16,
                k_steps=k, pair_dots=pair_dots, interpret=True, **SGHMC),
            start, n_state, lambda k: {})
        return to_flat(jfs.unpack_fused(
            tuple(a.astype(jnp.float32) for a in out[1]), H)).numpy()
    fn = (fs.fused_bnn_multistep_burnin_ref if burnin
          else fs.fused_bnn_multistep_ref)
    xw, yw = windows(x, y)
    start = [to_flat(st[k]).bfloat16() if k in bf16 else to_flat(st[k])
             for k in names]
    out = _launches(
        lambda s, k, step0, **kw: fn(
            *s, xw, yw, EPS, 0, state_dtype=torch.bfloat16, k_steps=k,
            step0=step0, pair_dots=pair_dots, **SGHMC, **kw),
        start, n_state, lambda k: _zero(k, n))
    assert out[1].dtype == torch.bfloat16
    return out[1].float().numpy()


def _quiet_rule(kind, side, pair_dots):
    """As :func:`_quiet_sghmc` for B5-sgnht or B5-rsghmc."""
    x, y, st, _, _, _ = _inputs(seed=54)
    state = _state(kind, _quiet(st), seed=55)
    ref, jax_fn = MULTI[kind]
    n_state = 3 if kind == "sgnht" else 2
    if side == "jax":
        args = _jax_args(kind, state)
        args[1] = tuple(a.astype(jnp.bfloat16) for a in args[1])
        jw = jfs.data_windows(x, y, BATCH)
        out = _launches(
            lambda s, k, step0: jax_fn(
                *s, *jw, QUIET_EPS[kind], 0, k_steps=k, h=H,
                pair_dots=pair_dots, state_dtype=jnp.bfloat16,
                **_jax_kw(kind)),
            args, n_state, lambda k: {})
        return to_flat(jfs.unpack_fused(
            tuple(a.astype(jnp.float32) for a in out[1]), H)).numpy()
    args = _port_args(kind, state)
    args[1] = args[1].bfloat16()
    xw, yw = windows(x, y)
    out = _launches(
        lambda s, k, step0, **kw: ref(
            *s, xw, yw, QUIET_EPS[kind], 0, k_steps=k, step0=step0,
            pair_dots=pair_dots, state_dtype=torch.bfloat16,
            **RULES[kind][0], **COMMON, **kw),
        args, n_state, lambda k: _zero(k, WIDX.size))
    assert out[1].dtype == torch.bfloat16
    return out[1].float().numpy()


def _agree(got, want, label):
    """Equal but on at most QUIET_FLIPS of the elements, and there by one
    bf16 ulp."""
    apart = got != want
    assert apart.mean() <= QUIET_FLIPS, "{}: {} of the elements differ".format(
        label, apart.mean())
    assert np.all(np.abs(got - want)[apart] <= _ulp(want)[apart]), label


QUIET = {"B1": lambda side, pd: _quiet_sghmc(False, side, pd),
         "B2": lambda side, pd: _quiet_sghmc(True, side, pd),
         "B5-sgnht": lambda side, pd: _quiet_rule("sgnht", side, pd),
         "B5-rsghmc": lambda side, pd: _quiet_rule("rsghmc", side, pd)}


@pytest.mark.parametrize("kernel", sorted(QUIET))
def test_paired_bf16_rounding_matches_pallas_kernels_elementwise(kernel):
    v = {(side, pd): QUIET[kernel](side, pd)
         for side in ("jax", "port") for pd in (False, True)}
    off = LAYOUT.offsets()
    slabs = np.zeros(P, bool)
    slabs[off["w2"][0]:off["w4"][0]] = True
    moved = {side: v[side, True] != v[side, False] for side in ("jax",
                                                                "port")}
    # pairing moved the matrix slabs' momentum and nothing else, on both
    # sides, and on a share this comparison sees
    for side in moved:
        assert not moved[side][:, ~slabs].any(), side
        assert moved[side][:, slabs].mean() > 0.05, side
    # the port's bf16 momentum is JAX's, paired and unpaired, element by
    # element; so is what pairing moved
    _agree(v["port", True], v["jax", True], kernel + "-pair v")
    _agree(v["port", False], v["jax", False], kernel + " v")
    assert (moved["port"] != moved["jax"]).mean() <= 2 * QUIET_FLIPS
    # the control: the per-step rounding (the unpaired schedule) fails
    # the paired comparison
    with pytest.raises(AssertionError):
        _agree(v["port", False], v["jax", True], "control")


#  (b) against the unpaired plain versions ------------------------------------

def _philox_pair(fn, state, pair_dots, k=3, **kw):
    n = state[0].shape[0]
    x, y, _ = workload(n, seed=46)
    xw, yw = windows(x, y)
    return fn(*state, xw, yw, EPS, 2**40 + 11, k_steps=k, step0=9,
              pair_dots=pair_dots, **kw)


def test_paired_equals_unpaired_at_f32_and_rounds_once_at_bf16():
    n = 2
    _, _, st = workload(n, seed=47)
    f32 = [to_flat(st[k]) for k in ("theta", "v", "minv")]
    unpaired = _philox_pair(fs.fused_bnn_multistep_ref, f32, False, **SGHMC)
    paired = _philox_pair(fs.fused_bnn_multistep_ref, f32, True, **SGHMC)
    for a, b in zip(unpaired, paired):
        assert torch.equal(a, b)
    bf = [f32[0], f32[1].bfloat16(), f32[2]]
    kw = dict(SGHMC, state_dtype=torch.bfloat16)
    unpaired = _philox_pair(fs.fused_bnn_multistep_ref, bf, False, **kw)
    paired = _philox_pair(fs.fused_bnn_multistep_ref, bf, True, **kw)
    lo, hi = LAYOUT.offsets()["w2"][0], LAYOUT.offsets()["w4"][0]
    # the rounding moved in the matrix slabs' momentum
    assert paired[1].dtype == torch.bfloat16
    assert (paired[1] != unpaired[1])[:, lo:hi].any()
    # one step is one rounding either way
    one = [_philox_pair(fs.fused_bnn_multistep_ref, bf, pair_dots, k=1, **kw)
           for pair_dots in (False, True)]
    assert all(torch.equal(a, b) for a, b in zip(*one))


@pytest.mark.parametrize("segs", [(3,), (2, 1)])
def test_paired_bf16_launches_round_at_their_ends(segs):
    """Two paired launches of k steps equal one of 2k at float32 state, and
    at bf16 state round the matrix slabs at the boundary: each launch is
    its own rounding unit."""
    n = 2
    x, y, st = workload(n, seed=48)
    xw, yw = windows(x, y)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        theta, v = to_flat(st["theta"]), to_flat(st["v"]).to(dtype)
        minv, step0 = to_flat(st["minv"]), 0
        for k in segs:
            theta, v, _ = fs.fused_bnn_multistep(
                theta, v, minv, xw, yw, EPS, 5, k_steps=k, step0=step0,
                state_dtype=dtype, pair_dots=True, **SGHMC)
            step0 += k
        out[dtype] = (theta, v)
    if segs == (2, 1):
        one = {}
        for dtype in (torch.float32, torch.bfloat16):
            one[dtype] = fs.fused_bnn_multistep(
                to_flat(st["theta"]), to_flat(st["v"]).to(dtype),
                to_flat(st["minv"]), xw, yw, EPS, 5, k_steps=3,
                state_dtype=dtype, pair_dots=True, **SGHMC)[:2]
        assert all(torch.equal(a, b) for a, b in zip(one[torch.float32],
                                                     out[torch.float32]))
        assert not torch.equal(one[torch.bfloat16][1],
                               out[torch.bfloat16][1])


def test_paired_drivers_cut_launches_where_jax_does():
    assert MAX_STEPS_PER_LAUNCH == 512
    assert _launch_segments(1100, True) == [512, 512, 76]
    assert _launch_segments(1024, True) == [512, 512]
    assert _launch_segments(1100, False) == [1100]


def test_paired_driver_equals_unpaired_driver_at_f32(monkeypatch):
    """The burn-in and sampling drivers with ``pair_dots`` (their launch
    cuts included, here every 2 steps) give the unpaired drivers' chains at
    float32 state."""
    from pysgmcmc_tpu_torch.models import dense_network
    from pysgmcmc_tpu_torch.parallel import packed
    from pysgmcmc_tpu_torch.samplers import SGHMCSampler

    monkeypatch.setattr(packed, "MAX_STEPS_PER_LAUNCH", 2)

    x, y, _ = workload(2, seed=49)
    init_fn, _ = dense_network(1, units=(6, 6, 6), device="cpu")
    sampler = SGHMCSampler(lambda p, b: None, stepsize_schedule=1e-3,
                           scale_grad=float(N_DATA))
    states = sampler.init(init_fn(torch.Generator().manual_seed(3), (2,)))
    out = {}
    for pair_dots in (False, True):
        burned = burnin_chain_fused(
            sampler, states, torch.Generator().manual_seed(4),
            5, x, y, state_dtype=torch.float32,
            pair_dots=pair_dots, noise_impl="box_muller")
        out[pair_dots] = sample_chain_fused(
            sampler, burned, torch.Generator().manual_seed(5), 2, x, y,
            keep_every=3, state_dtype=torch.float32, multistep=True,
            pair_dots=pair_dots, noise_impl="box_muller")
    for key in out[False][1]:
        assert torch.equal(out[False][1][key], out[True][1][key]), key


#  (c) JAX's refusals ---------------------------------------------------------

@pytest.mark.parametrize("case,match", [
    (dict(h=60), "64-slot"),
    (dict(depth=2), "3-hidden-layer"),
    (dict(n=3), "even"),
    (dict(noise_impl="hadamard_clt"), "box_muller"),
    (dict(one_step=dict(n_inputs=2)), "n_inputs=1"),
    (dict(one_step=dict(noise=True)), "noise injection"),
    (dict(one_step=dict(select_in_kernel=True)), "select_in_kernel"),
])
def test_paired_kernels_refuse_what_jax_refuses(case, match):
    h, depth, n = case.get("h", 8), case.get("depth", 3), case.get("n", 2)
    layout = fs.FusedLayout(1, h, depth)
    theta = torch.zeros((n, layout.n_params))
    x, y, _ = workload(n, seed=50)
    xw, yw = windows(x, y)
    one = case.get("one_step")
    with pytest.raises(ValueError, match=match):
        if one is None:
            fs.fused_bnn_multistep(
                theta, theta, theta, xw, yw, EPS, 1, h=h, pair_dots=True,
                noise_impl=case.get("noise_impl", "box_muller"), **SGHMC)
        elif one.get("select_in_kernel"):
            fs.fused_bnn_step(theta, theta, theta, xw, yw, EPS, 1, h=h,
                              pair_dots=True, select_in_kernel=True, **SGHMC)
        else:
            n_inputs = one.get("n_inputs", 1)
            layout = fs.FusedLayout(n_inputs, h, depth)
            theta = torch.zeros((n, layout.n_params))
            x_sel = torch.zeros((n, BATCH) + ((n_inputs,) if n_inputs > 1
                                              else ()))
            fs.fused_bnn_step(
                theta, theta, theta, x_sel, torch.zeros((n, BATCH)), EPS, 1,
                h=h, n_inputs=n_inputs, pair_dots=True,
                noise=torch.zeros_like(theta) if one.get("noise") else None,
                **SGHMC)


def test_paired_one_step_kernel_is_b3_with_its_one_rounding():
    x, y, st, x_sel, y_sel, _ = _inputs(seed=51)
    state = [to_flat(st[k]) for k in ("theta", "v", "minv")]
    state[1] = state[1].bfloat16()
    kw = dict(SGHMC, state_dtype=torch.bfloat16, step=7)
    paired = fs.fused_bnn_step(*state, x_sel, y_sel, EPS, 3, pair_dots=True,
                               **kw)
    unpaired = fs.fused_bnn_step(*state, x_sel, y_sel, EPS, 3, **kw)
    for a, b in zip(paired, unpaired):
        assert torch.equal(a, b)


def test_sample_chain_fused_refuses_paired_one_step():
    from pysgmcmc_tpu_torch.models import dense_network
    from pysgmcmc_tpu_torch.samplers import SGHMCSampler

    x, y, _ = workload(2, seed=52)
    init_fn, _ = dense_network(1, units=(6, 6, 6), device="cpu")
    sampler = SGHMCSampler(lambda p, b: None, stepsize_schedule=1e-3)
    states = sampler.init(init_fn(torch.Generator().manual_seed(3), (2,)))
    with pytest.raises(ValueError, match="multistep=True"):
        sample_chain_fused(sampler, states, torch.Generator(), 1, x, y,
                           pair_dots=True, multistep=False)


#  The slice: the paired BNN against JAX's ------------------------------------

@pytest.fixture(scope="module")
def trained_paired():
    x, y = _data()
    jax_bnn = JaxBNN(pair_dots=True, **SLICE)
    jax_bnn.train(x, y)
    port_bnn = _port_bnn(pair_dots=True, **SLICE)
    port_bnn.train(x, y)
    return jax_bnn, port_bnn


def test_paired_bnn_matches_jax(trained_paired):
    jax_bnn, port_bnn = trained_paired
    assert port_bnn.pair_dots and port_bnn.noise_impl == "zero"
    for key, want in jax_bnn.samples.items():
        np.testing.assert_allclose(port_bnn.samples[key].numpy(),
                                   np.asarray(want), rtol=0,
                                   atol=SAMPLES_ATOL, err_msg=key)
    x_grid = np.linspace(0.0, 1.0, 50)[:, None]
    want_mean, want_var = jax_bnn.predict(x_grid)
    mean, var = port_bnn.predict(x_grid)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=MEAN_ATOL)
    np.testing.assert_allclose(var, want_var, rtol=0, atol=VAR_ATOL)


def test_paired_bnn_defaults_to_box_muller():
    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork

    bnn = BayesianNeuralNetwork(pair_dots=True, device="cpu", **SLICE)
    assert bnn.noise_impl == "box_muller"
    jax_bnn = JaxBNN(pair_dots=True, **SLICE)
    assert jax_bnn.noise_impl == bnn.noise_impl
