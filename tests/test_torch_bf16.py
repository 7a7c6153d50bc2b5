"""bf16 sampler state, the BNN's ``compute_dtype`` and the wide fused layout
in the port, against the JAX package.

(a) The fused kernels' plain versions with bf16 state (``state_dtype=
    bfloat16`` momenta and accumulators, bf16 frozen minv) against JAX's
    Pallas kernels in interpret mode with ``state_dtype=jnp.bfloat16``, on
    the zero-bit stream (multi-step) or injected noise (one-step): each
    kernel's f32 interpret-mode bound plus one bf16 ulp of every bf16 value
    per step.  Two launches of k steps equal one of 2k bit for bit under
    bf16, so the rounding happens every step, as the TPU kernels' stores.
(b) The slim kernels' plain versions with bf16 v, minv and gradient against
    JAX's slim kernels (interpret mode), within their f32 bound plus one
    bf16 ulp of a bf16 output.
(c) The drivers at JAX's defaults are in ``tests/test_torch_bf16_drivers.py``,
    the BNN's ``compute_dtype`` and ``predict(compute_dtype=)`` in
    ``tests/test_torch_bf16_bnn.py``.
(d) The networks' operand promotion against ``jnp.dot``'s, and bf16 leaves
    through ``interop``.
(e) A width of JAX's 128-slot layout (H = 64) through B1 and B2 against
    JAX's kernels.

Inputs are made with numpy seeds and handed to both sides.  The CUDA
kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from pysgmcmc_tpu.models.architectures import default_network as jax_default
from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu.ops import slim_update as jsu
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.models import default_network, dense_network
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.ops import slim_update as su
from tests import test_torch_fused_samplers as tfs
from tests import test_torch_lanes as tl
from tests import test_torch_samplers_lanes as tsl
from tests.test_torch_fused_step import (
    B1_PALLAS_TOL,
    B2_PALLAS_TOL,
    BATCH,
    EPS,
    H,
    MDECAY,
    N_DATA,
    P,
    PRIOR,
    to_flat,
    windows,
    workload,
)
from tests.test_torch_one_step import A_COEF, PALLAS_TOL, WIDX, _inputs
from tests.test_torch_sgld import B5_PALLAS_TOL, PALLAS_EPS

BF16 = torch.bfloat16
K = 3


def _ulp(a):
    """One bf16 ulp of each value, as ``chip_smoke.py`` counts it."""
    return cs._ulp_bf16(torch, torch.as_tensor(np.asarray(
        a, np.float64))).numpy()


def _tree32(flat, h=H):
    """The port's ``(n, P)`` output (any type) as a dict of f32 arrays."""
    return {k: v.numpy() for k, v in fs.unpack(
        flat.float(), fs.FusedLayout(1, h, 3)).items()}


def _jtree32(slabs, h=H):
    return {k: np.asarray(v, np.float32)
            for k, v in jfs.unpack_fused(slabs, h).items()}


def _close(got, want, tol, label, ulps=0, ulp_of=None):
    """Every value of ``got`` within ``tol`` (``rtol``/``atol``) of
    ``want``'s, plus ``ulps`` bf16 ulps of ``ulp_of`` (``want`` unless
    given), leaf by leaf."""
    ulp_of = want if ulp_of is None else ulp_of
    for key, leaf in want.items():
        w = np.asarray(leaf, np.float64)
        slack = tol.get("atol", 0.0) + tol.get("rtol", 0.0) * np.abs(w)
        slack = slack + ulps * _ulp(np.abs(np.asarray(ulp_of[key])).max()
                                    if ulp_of is not want else w)
        err = np.abs(np.asarray(got[key], np.float64) - w)
        assert np.all(err <= slack), "{} {}: {:.3e} beyond its bound".format(
            label, key, float((err - slack).max()))


#  (a) the fused kernels with bf16 state ---------------------------------------

def _sghmc_case(name):
    """B1 / B2 / B3 / B4-sgld / B5-sgld: (JAX outputs, port outputs, output
    names, bf16 outputs, base bounds)."""
    n = WIDX.size
    x, y, st, x_sel, y_sel, noise = _inputs(seed=51)
    xw, yw = windows(x, y)
    jx_win, jy_win = jfs.data_windows(x, y, BATCH)
    jx_sel, jy_sel = jfs.gather_batch(jx_win, jy_win, WIDX)
    common = dict(scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA)
    jcommon = dict(common, block_chains=n, interpret=True)
    zero = dict(noise=torch.zeros((K, n, P)),
                widx=torch.zeros((K, n), dtype=torch.int32))
    jmulti = dict(jcommon, k_steps=K, noise_impl="box_muller")
    theta, v, minv = (to_flat(st[k]) for k in ("theta", "v", "minv"))
    jtheta = jfs.pack_fused(st["theta"])
    jv = tuple(a.astype(jnp.bfloat16) for a in jfs.pack_fused(st["v"]))
    jminv = tuple(a.astype(jnp.bfloat16) for a in jfs.pack_fused(st["minv"]))
    if name == "B1":
        want = jfs.fused_bnn_multistep(
            jtheta, jv, jminv, jx_win, jy_win, EPS, 0, mdecay=MDECAY,
            state_dtype=jnp.bfloat16, **jmulti)
        got = fs.fused_bnn_multistep_ref(
            theta, v.to(BF16), minv.to(BF16), xw, yw, EPS, 0, mdecay=MDECAY,
            state_dtype=BF16, k_steps=K, **zero, **common)
        return want, got, ("theta", "v"), ("v",), B1_PALLAS_TOL
    if name == "B2":
        names = ("tau", "g", "v_hat")
        want = jfs.fused_bnn_multistep_burnin(
            jtheta, jv, *[jfs.pack_fused(st[k]) for k in names], jx_win,
            jy_win, EPS, 0, mdecay=MDECAY, state_dtype=jnp.bfloat16,
            **jmulti)
        got = fs.fused_bnn_multistep_burnin_ref(
            theta, v.to(BF16), *[to_flat(st[k]) for k in names], xw, yw, EPS,
            0, mdecay=MDECAY, state_dtype=BF16, k_steps=K, **zero, **common)
        return (want, got, ("theta", "v", "tau", "g", "v_hat", "minv"),
                ("v",), B2_PALLAS_TOL)
    eta = torch.tensor(noise)
    jeta = jfs.pack_fused(_tree32(eta))
    if name == "B3":
        want = jfs.fused_bnn_step(
            jtheta, jv, jminv, jx_sel, jy_sel, EPS, 0, mdecay=MDECAY,
            state_dtype=jnp.bfloat16, noise=jeta, **jcommon)
        got = fs.fused_bnn_step_ref(
            theta, v.to(BF16), minv.to(BF16), x_sel, y_sel, EPS, 0,
            mdecay=MDECAY, state_dtype=BF16, noise=eta, **common)
        tol = PALLAS_TOL["B3"]
        return want, got, ("theta", "v"), ("v",), dict(theta=tol, v=tol)
    if name == "B4-sgld":
        want = jfs.fused_bnn_step_sgld(
            jtheta, jminv, jx_sel, jy_sel, 1e-3, 0, a_coef=A_COEF,
            noise=jeta, **jcommon)
        got = fs.fused_bnn_step_sgld_ref(
            theta, minv.to(BF16), x_sel, y_sel, 1e-3, 0, a_coef=A_COEF,
            noise=eta, **common)
        return want, got, ("theta",), (), dict(theta=PALLAS_TOL["B4-sgld"])
    want = jfs.fused_bnn_multistep_sgld(
        jtheta, jminv, jx_win, jy_win, PALLAS_EPS, 0, a_coef=A_COEF,
        **jmulti)
    got = fs.fused_bnn_multistep_sgld_ref(
        theta, minv.to(BF16), xw, yw, PALLAS_EPS, 0, a_coef=A_COEF,
        k_steps=K, **zero, **common)
    return want, got, ("theta",), (), B5_PALLAS_TOL


def _rule_case(name):
    """B4-psgld, B4-/B5-sgnht, B4-/B5-rsghmc with bf16 momentum or
    accumulator."""
    kind = name[3:]
    one_step = name.startswith("B4")
    x, y, st, x_sel, y_sel, noise = _inputs(seed=53)
    state = tfs._state(kind, st, seed=54)
    eps = tfs.RULES[kind][1]
    args = tfs._port_args(kind, state)
    args[1] = args[1].to(BF16)
    jargs = tfs._jax_args(kind, state)
    jargs[1] = tuple(a.astype(jnp.bfloat16) for a in jargs[1])
    jkw = dict(tfs._jax_kw(kind), state_dtype=jnp.bfloat16, h=H)
    kw = dict(tfs.RULES[kind][0], state_dtype=BF16, **tfs.COMMON)
    if one_step:
        ref, jax_fn = tfs.STEP[kind]
        jx_sel, jy_sel = jfs.gather_batch(*jfs.data_windows(x, y, BATCH),
                                          WIDX)
        want = jax_fn(*jargs, jx_sel, jy_sel, eps, 0,
                      noise=jfs.pack_fused(_tree32(torch.tensor(noise))),
                      **jkw)
        got = ref(*args, x_sel, y_sel, eps, 0, noise=torch.tensor(noise),
                  **kw)
    else:
        ref, jax_fn = tfs.MULTI[kind]
        jx_win, jy_win = jfs.data_windows(x, y, BATCH)
        want = jax_fn(*jargs, jx_win, jy_win, eps, 0, k_steps=K,
                      noise_impl="box_muller", **jkw)
        xw, yw = windows(x, y)
        got = ref(*args, xw, yw, eps, 0, k_steps=K,
                  noise=torch.zeros((K, WIDX.size, P)),
                  widx=torch.zeros((K, WIDX.size), dtype=torch.int32), **kw)
    return kind, got, want


FUSED_BF16 = ("B1", "B2", "B3", "B4-sgld", "B5-sgld", "B4-psgld",
              "B4-sgnht", "B4-rsghmc", "B5-sgnht", "B5-rsghmc")


@pytest.mark.parametrize("name", FUSED_BF16)
def test_bf16_state_plain_version_matches_pallas_kernel(name):
    """The plain version with bf16 state against JAX's kernel at
    ``state_dtype=jnp.bfloat16``: the kernel's f32 interpret-mode bound
    (its bf16 matrix operands) plus one bf16 ulp of each bf16 value per
    step; a bf16 output comes back bf16 on both sides."""
    steps = 1 if name[:2] in ("B3", "B4") else K
    if name[3:] in tfs.RULES:
        kind, got, want = _rule_case(name)
        tol = tfs.PALLAS_TOL[kind]
        assert got[1].dtype == BF16 and want[1][0].dtype == jnp.bfloat16
        for i, label in enumerate(("theta", "v")):
            base = tol[label]
            if kind == "psgld" and label == "v":  # of each leaf's scale
                scale = {k: np.abs(a).max()
                         for k, a in _jtree32(want[1]).items()}
                w = _jtree32(want[1])
                for k in w:
                    assert np.all(np.abs(_tree32(got[1])[k] - w[k])
                                  <= base * scale[k] + _ulp(w[k])), k
                continue
            _close(_tree32(got[i]), _jtree32(want[i]), dict(atol=base),
                   "{} {}".format(name, label), ulps=steps,
                   ulp_of=_jtree32(want[1]))
        if kind == "sgnht":
            np.testing.assert_allclose(got[2].numpy(),
                                       np.asarray(want[2])[:, 0], rtol=0,
                                       atol=tol["xi"])
        np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]),
                                   rtol=2e-2)
        return
    want, got, names, bf16, tol = _sghmc_case(name)
    for i, label in enumerate(names):
        if label in bf16:
            assert got[i].dtype == BF16 and want[i][0].dtype == jnp.bfloat16
        ulp_of = _jtree32(want[names.index("v")]) if "v" in names else None
        _close(_tree32(got[i]), _jtree32(want[i]), tol[label],
               "{} {}".format(name, label), ulps=steps if ulp_of else 0,
               ulp_of=ulp_of)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]),
                               rtol=2e-2)


# multi-step kernel -> (plain version, state names, bf16 state, keywords)
CHUNKED = {
    "B1": (fs.fused_bnn_multistep, ("theta", "v", "minv"), ("v", "minv"),
           dict(mdecay=MDECAY)),
    "B2": (fs.fused_bnn_multistep_burnin, ("theta", "v", "tau", "g",
                                           "v_hat"), ("v",),
           dict(mdecay=MDECAY)),
    "B5-sgld": (fs.fused_bnn_multistep_sgld, ("theta", "minv"), ("minv",),
                dict(a_coef=A_COEF)),
}


@pytest.mark.parametrize("name", ["B1", "B2", "B5-sgld", "B5-sgnht",
                                  "B5-rsghmc"])
def test_bf16_chunked_launches_equal_one_launch(name):
    """Under bf16 state two launches of k steps equal one of 2k on the
    Philox stream, bit for bit: the momentum is rounded after every step
    (rounding once per launch would part them at step k)."""
    x, y, st = workload(WIDX.size, seed=55)
    xw, yw = windows(x, y)
    if name in CHUNKED:
        fn, names, bf16, kw = CHUNKED[name]
        state = [to_flat(st[k]).to(BF16) if k in bf16 else to_flat(st[k])
                 for k in names]
        kw = dict(kw, scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA)
        if "v" in bf16:
            kw["state_dtype"] = BF16
        n_state = 2 if name == "B1" else len(names) if name == "B2" else 1
    else:
        kind = name[3:]
        fn = {"sgnht": fs.fused_bnn_multistep_sgnht,
              "rsghmc": fs.fused_bnn_multistep_rsghmc}[kind]
        state = tfs._port_args(kind, tfs._state(kind, st, seed=56))
        state[1] = state[1].to(BF16)
        kw = dict(tfs.RULES[kind][0], state_dtype=BF16, **tfs.COMMON)
        n_state = len(state)
    seed, k = 2**40 + 9, 2
    eps = 1e-3
    whole = fn(*state, xw, yw, eps, seed, k_steps=2 * k, step0=30, **kw)
    first = fn(*state, xw, yw, eps, seed, k_steps=k, step0=30, **kw)
    second = fn(*first[:n_state], *state[n_state:], xw, yw, eps, seed,
                k_steps=k, step0=30 + k, **kw)
    for a, b in zip(whole, second):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if "v" in CHUNKED.get(name, (None, None, ("v",)))[2]:
        assert whole[1].dtype == BF16


#  (b) the slim kernels with bf16 operands -------------------------------------

# kernel -> (JAX kernel, port plain version, operands, bf16 operands, rule,
# inputs of tests/test_torch_lanes.py (0) or test_torch_samplers_lanes (1))
SLIM = {
    "B7": (jsu.slim_sghmc_update, su.slim_sghmc_update_ref,
           ("theta", "v", "grad", "minv"), ("v", "grad", "minv"),
           dict(mdecay=0.05), 0),
    "B8-sgld": (jsu.slim_sgld_update, su.slim_sgld_update_ref,
                ("theta", "grad", "minv"), ("grad", "minv"),
                dict(a_coef=1.0), 0),
    "B9-sghmc": (jsu.slim_sghmc_burnin_update,
                 su.slim_sghmc_burnin_update_ref,
                 ("theta", "v", "tau", "g", "v_hat", "grad"), ("v", "grad"),
                 dict(mdecay=0.05), 0),
    "B9-sgld": (jsu.slim_sgld_burnin_update, su.slim_sgld_burnin_update_ref,
                ("theta", "tau", "g", "v_hat", "grad"), ("grad",),
                dict(a_coef=1.0), 0),
    "B8-psgld": (jsu.slim_psgld_update, su.slim_psgld_update_ref,
                 ("theta", "v", "grad"), ("v", "grad"),
                 tsl.KERNELS["B8-psgld"][3], 1),
    "B8-rsghmc": (jsu.slim_rsghmc_update, su.slim_rsghmc_update_ref,
                  ("theta", "p", "grad"), ("p", "grad"),
                  tsl.KERNELS["B8-rsghmc"][3], 1),
    "B8-sgnht": (jsu.slim_sgnht_update, su.slim_sgnht_update_ref,
                 ("theta", "p", "grad"), ("p", "grad"),
                 tsl.KERNELS["B8-sgnht"][3], 1),
}


@pytest.mark.parametrize("kernel", sorted(SLIM))
def test_bf16_slim_plain_version_matches_pallas_kernel(kernel):
    """bf16 v, minv and gradient in, each output in its input's type, as
    JAX's slim kernels: within their f32 bound (1e-6 of a value and of its
    output's scale) plus one bf16 ulp of a bf16 output."""
    jax_fn, ref, names, bf16, rule, source = SLIM[kernel]
    if source == 0:
        inputs, consts = tl._kernel_inputs(3), dict(tl.CONSTANTS)
    else:
        inputs, consts = tsl._kernel_inputs(3), dict(prior_scale=tsl.PRIOR)
    jargs = [jnp.asarray(inputs[k].T) for k in names]
    jargs = [a.astype(jnp.bfloat16) if k in bf16 else a
             for k, a in zip(names, jargs)] + [None]
    args = [torch.tensor(inputs[k]) for k in names]
    args = [a.to(BF16) if k in bf16 else a
            for k, a in zip(names, args)] + [None]
    if kernel == "B8-sgnht":
        jargs.append(jnp.asarray(inputs["xi"][None, :]))
        args.append(torch.tensor(inputs["xi"]))
    want = tl._as_tuple(jax_fn(*jargs, jnp.asarray(0.05), 0,
                               noise=jnp.asarray(inputs["noise"].T),
                               interpret=True, **rule, **consts))
    got = tl._as_tuple(ref(*args, 0.05, 7, noise=torch.tensor(
        inputs["noise"]), **rule, **consts))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert str(a.dtype).split(".")[1] == str(b.dtype), i
        b = np.asarray(b, np.float64).T
        slack = tl.KERNEL_RTOL * (np.abs(b) + np.abs(b).max())
        if a.dtype == BF16:
            slack = slack + _ulp(b)
        err = np.abs(a.double().numpy() - b)
        assert np.all(err <= slack), "output {}: {:.3e}".format(
            i, float((err - slack).max()))


#  (d) promotion and interop --------------------------------------------------

@pytest.mark.parametrize("network,jax_network", [
    (default_network, jax_default), (dense_network, jax_dense)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_network_apply_promotes_as_jax(network, jax_network, dtype):
    """bf16 weights in an f32 network compute in f32 (``jnp.dot``'s
    promotion); in a bf16 network in bf16; the outputs' types match."""
    init, _ = jax_network(1, units=(8, 8))
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    init(jax.random.PRNGKey(3)))
    x = np.random.RandomState(0).uniform(size=(7, 1)).astype(np.float32)
    want = jax_network(1, units=(8, 8), dtype=getattr(jnp, dtype))[1](
        params, x)
    got = network(1, units=(8, 8), dtype=getattr(torch, dtype),
                  device="cpu")[1](interop.params_from_numpy(params, "cpu"),
                                   torch.tensor(x))
    assert str(got.dtype).split(".")[1] == str(want.dtype) == dtype
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_interop_carries_bf16_leaves_exactly():
    """A JAX bf16 leaf becomes a bf16 tensor with the same bits, and comes
    back as float32 numpy with the same values."""
    rng = np.random.RandomState(0)
    leaf = jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32)
                       ).astype(jnp.bfloat16)
    got = interop.params_from_numpy({"w": leaf}, "cpu")["w"]
    assert got.dtype == BF16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(leaf, jnp.int16)))
    back = interop.params_to_numpy({"w": got})["w"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, np.asarray(leaf, np.float32))


#  (e) a width of JAX's 128-slot layout ---------------------------------------

WIDE_H = 64


@pytest.mark.parametrize("name", ["B1", "B2"])
def test_wide_layout_matches_pallas_kernel(name):
    """H = 64, beyond JAX's 64-slot layout: JAX's kernels on their 128-slot
    slabs against the port's plain versions (the layout the card's
    device-memory placement runs for wider networks), f32 state, within
    the 64-slot bounds."""
    n = 2
    rng = np.random.RandomState(57)
    x = rng.uniform(0.0, 1.0, (N_DATA, 1)).astype(np.float32)
    y = np.sinc(10.0 * x[:, 0] - 5.0).astype(np.float32)
    init, _ = jax_dense(1, units=(WIDE_H,) * 3)
    theta = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(5), n))
    theta = {k: np.asarray(v) for k, v in theta.items()}

    def like(lo, hi):
        return {k: rng.uniform(lo, hi, v.shape).astype(np.float32)
                for k, v in theta.items()}

    st = {"theta": theta, "v": like(-1e-3, 1e-3), "tau": like(1.0, 5.0),
          "g": like(-1.0, 1.0), "v_hat": like(1.0, 5.0),
          "minv": like(0.2, 1.2)}
    lay = fs.FusedLayout(1, WIDE_H, 3)
    flat = {k: fs.pack({n_: torch.tensor(a) for n_, a in t.items()}, lay)
            for k, t in st.items()}
    jx_win, jy_win = jfs.data_windows(x, y, BATCH)
    xw, yw = fs.data_windows(torch.tensor(x), torch.tensor(y), BATCH)
    common = dict(scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA, mdecay=MDECAY)
    zero = dict(noise=torch.zeros((2, n, lay.n_params)),
                widx=torch.zeros((2, n), dtype=torch.int32))
    jkw = dict(common, block_chains=n, state_dtype=jnp.float32, k_steps=2,
               noise_impl="box_muller", interpret=True)
    names = (("theta", "v", "minv") if name == "B1"
             else ("theta", "v", "tau", "g", "v_hat"))
    fn, jax_fn = ((fs.fused_bnn_multistep_ref, jfs.fused_bnn_multistep)
                  if name == "B1" else
                  (fs.fused_bnn_multistep_burnin_ref,
                   jfs.fused_bnn_multistep_burnin))
    if name == "B2":
        jkw["h"] = WIDE_H
    want = jax_fn(*[jfs.pack_fused(st[k]) for k in names], jx_win, jy_win,
                  EPS, 0, **jkw)
    assert want[0][0].shape[-1] == 128  # JAX's wide slot
    got = fn(*[flat[k] for k in names], xw, yw, EPS, 0, k_steps=2,
             h=WIDE_H, **zero, **common)
    tol = B1_PALLAS_TOL if name == "B1" else B2_PALLAS_TOL
    outs = ("theta", "v") if name == "B1" else (
        "theta", "v", "tau", "g", "v_hat", "minv")
    for i, label in enumerate(outs):
        w = {k: np.asarray(a) for k, a in jfs.unpack_fused(
            want[i], WIDE_H).items()}
        g = {k: a.numpy() for k, a in fs.unpack(got[i], lay).items()}
        _close(g, w, tol[label], "{} H={} {}".format(name, WIDE_H, label))
