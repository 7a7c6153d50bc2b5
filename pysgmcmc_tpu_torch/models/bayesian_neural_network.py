"""Bayesian neural network trained with SG-MCMC (PyTorch port of
:mod:`pysgmcmc_tpu.models.bayesian_neural_network`).

After Springenberg et al., NIPS 2016: ``train`` samples network weights with
an SG-MCMC sampler, ``predict`` averages over the collected weight snapshots,
across ``n_chains`` independent chains, on the card unless ``device="cpu"``
is asked for (:mod:`pysgmcmc_tpu_torch.parallel.packed` holds the drivers).
Two step implementations are ported:

- ``step_impl="fused"`` (``network="dense"``): sampling on kernel B1
  (SGHMC), B5-sgld, B5-psgld, B5-sgnht or B5-rsghmc, the whole BNN step in
  the kernel and the weight prior folded into the update.  SGHMC and SGLD
  burn in on B2 or B6; pSGLD, SGNHT and relativistic SGHMC, which have no
  burn-in machinery, on discarded steps of the lanes driver (B8-psgld,
  B8-sgnht, B8-rsghmc), on the same likelihood with the prior folded.
  The fused kernels draw their normals from the MXU-CLT generator unless
  ``noise_impl="box_muller"`` (JAX's default on the chip);
  ``pair_dots=True`` (3 hidden layers of at most 50) runs the paired
  variants of B1, B2, B5-* and B6 with Box-Muller normals.
- ``step_impl="lanes"`` (``network="reference"`` or ``"dense"``, or any
  ``get_net``): the gradient of the full cost, weight prior included, by
  autograd over every chain, then one slim elementwise kernel per step:
  B9-sghmc / B9-sgld in burn-in, B7 / B8-sgld in sampling.  pSGLD,
  relativistic SGHMC and SGNHT have no burn-in machinery: their burn-in
  is discarded sampling steps, every step on B8-psgld, B8-rsghmc or
  B8-sgnht.

SVGD (``sampling_method=Sampler.SVGD``) ignores ``step_impl``, as in the JAX
package: ``n_nets`` particle networks are transported jointly, every step on
one minibatch window shared by the ensemble, with the dense kernel matrix
(``kernel_impl="dense"``, ``torch.matmul``) or kernel B11
(``kernel_impl="streaming"``, :mod:`pysgmcmc_tpu_torch.ops.svgd_streaming`).

``compute_dtype=torch.bfloat16`` is JAX's mixed precision: bf16 network
passes in the cost, bf16 sampling state (momentum, accumulator, minv) in
the kernels, f32 state in the adaptive burn-in, and a bf16 serving path in
``predict(compute_dtype=)``.  The fused path takes hidden widths up to 114,
as JAX's.

Other step implementations raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.

Priors and likelihood match the reference: heteroscedastic Gaussian log
likelihood scaled by 1/batch_size, a Gaussian prior on the log predictive
variance and an L2 weight prior, both scaled by 1/N.

Examples
--------
>>> import math, torch
>>> round(float(weight_prior_log_like({"w": torch.ones(2, 2)})), 3)
-0.5
>>> round(float(log_variance_prior_log_like(
...     torch.full((1, 1), math.log(1e-6)))), 3)
2.303
"""

import contextlib
import functools
import logging
import time

import numpy as np
import torch

from pysgmcmc_tpu_torch.data_batches import batch_fn
from pysgmcmc_tpu_torch.models.architectures import (
    default_network,
    dense_network,
)
from pysgmcmc_tpu_torch.models.base_model import (
    BaseModel,
    zero_mean_unit_var_normalization,
    zero_mean_unit_var_unnormalization,
)
from pysgmcmc_tpu_torch.ops.fused_step import (
    MAX_INPUTS,
    STATE_DTYPES,
    check_hidden,
)
from pysgmcmc_tpu_torch.parallel.packed import (
    _draw_seed,
    burnin_chain_fused,
    burnin_chain_lanes,
    sample_chain_fused,
    sample_chain_lanes,
)
from pysgmcmc_tpu_torch.sampling import Sampler
from pysgmcmc_tpu_torch.stepsize_schedules import (
    ConstantStepsizeSchedule,
    StepsizeSchedule,
)
from pysgmcmc_tpu_torch.utils.numeric import safe_divide
from pysgmcmc_tpu_torch.utils.pytree import tree_size
from pysgmcmc_tpu_torch.utils.tracing import span, spanned

def log_variance_prior_log_like(log_var, mean=1e-6, var=0.01):
    """Gaussian prior (in log space) on the predicted log variance:
    ``mean(sum(-(log_var - log(mean))^2 / (2 var) - 0.5 log(var), axis=1))``."""
    dtype, device = log_var.dtype, log_var.device
    # fills, not copies from pageable host memory, which wait for the card
    mean = torch.full((), mean, dtype=dtype, device=device)
    var = torch.full((), var, dtype=dtype, device=device)
    return torch.mean(torch.sum(
        safe_divide(-torch.square(log_var - torch.log(mean)), 2.0 * var)
        - 0.5 * torch.log(var), dim=1))


def weight_prior_log_like(params, wdecay=1.0):
    """L2 (Gaussian) prior over all parameters, normalized by their count."""
    leaves = list(params.values())
    log_like = sum(torch.sum(-wdecay * 0.5 * torch.square(leaf))
                   for leaf in leaves)
    n_params = sum(leaf.numel() for leaf in leaves)
    return safe_divide(log_like, torch.full(
        (), n_params, dtype=log_like.dtype, device=log_like.device))


def _not_ported(what, item):
    return NotImplementedError(
        "BayesianNeuralNetwork: {} is not ported to PyTorch yet "
        "(ROADMAP.md {})".format(what, item))


class BayesianNeuralNetwork(BaseModel):
    """SG-MCMC Bayesian neural network for regression.

    Parameters and defaults are the JAX package's (reference ctor
    defaults: batch 20, constant stepsize ``sqrt(1e-4)``, 100 nets thinned
    every 100 steps, 50000 iterations, 1000 burn-in steps), plus ``device``:
    ``"cuda"`` (the default) runs the kernels and raises in ``train`` when
    no CUDA device is present, ``"cpu"`` runs their plain PyTorch versions.
    The ported paths are ``step_impl="fused"`` (``network="dense"``) and
    ``step_impl="lanes"`` (either network, or ``get_net=(init, apply)``
    with the contract of :func:`~pysgmcmc_tpu_torch.models.architectures.
    default_network`), each with any of the five gradient samplers (SGHMC,
    SGLD, pSGLD, SGNHT, relativistic SGHMC), and SVGD on any ``step_impl``
    but these two (``n_nets`` particles, ``n_iters`` steps; ``phase_seconds``
    records its ``"transport"``); ``**sampler_kwargs`` go to the
    sampler (SGLD's
    ``A``, pSGLD's ``alpha``, relativistic SGHMC's ``D``, SVGD's
    ``kernel_impl``, ...), which
    gets ``scale_grad`` = N by default where it has one.  ``noise_impl``
    picks the fused kernels' generator on the Philox stream: ``"auto"``
    (the default) is the MXU-CLT generator ``"hadamard_clt"`` on
    ``step_impl="fused"`` and Box-Muller elsewhere and with ``pair_dots``,
    as JAX's on the chip; ``"box_muller"``; or ``"zero"`` (the degenerate
    stream of the parity tests: zero noise, window 0).  ``"hadamard_clt"``
    needs ``step_impl="fused"`` and refuses ``pair_dots``; ``pair_dots=True``
    runs the paired fused kernels (``step_impl="fused"``, three hidden
    layers; the drivers refuse widths above 50), as JAX's.
    ``compute_dtype`` (``None``, ``torch.float32`` or
    ``torch.bfloat16``) is JAX's mixed precision: set, the network passes of
    the cost run on the weights and inputs cast to it, and the sampling
    state is bf16: the fused path samples with bf16 momentum and minv
    (B1 / B5-*; burn-in keeps float32 state), the lanes path feeds the
    bf16 gradient to the slim kernels and keeps its momentum, accumulator
    and minv in bf16 (burn-in: float32 state).  ``predict(compute_dtype=)``
    serves the ensemble from bf16 copies of the samples.
    """

    def __init__(
        self,
        sampling_method=Sampler.SGHMC,
        get_net=None,
        batch_size=20,
        stepsize_schedule=None,
        n_nets=100,
        n_iters=50000,
        burn_in_steps=1000,
        sample_steps=100,
        normalize_input=True,
        normalize_output=True,
        seed=0,
        dtype=torch.float32,
        compute_dtype=None,
        n_chains=1,
        mesh=None,
        log_every=512,
        network="reference",
        step_impl="pytree",
        units=(50, 50, 50),
        pair_dots=False,
        noise_impl="auto",
        device="cuda",
        **sampler_kwargs,
    ):
        super().__init__()
        if not isinstance(n_nets, int) or n_nets <= 0:
            raise ValueError("n_nets must be a positive integer")
        if not isinstance(n_iters, int) or n_iters <= 0:
            raise ValueError("n_iters must be a positive integer")
        if not isinstance(burn_in_steps, int) or burn_in_steps < 0:
            raise ValueError("burn_in_steps must be a non-negative integer")
        if not isinstance(sample_steps, int) or sample_steps <= 0:
            raise ValueError("sample_steps must be a positive integer")
        if not isinstance(batch_size, int) or batch_size <= 0:
            raise ValueError("batch_size must be a positive integer")
        if not Sampler.is_supported(sampling_method):
            raise ValueError(
                "BayesianNeuralNetwork received unsupported input for "
                "parameter 'sampling_method'. Input was: {!r}.\n"
                "Supported sampling methods are enumerated in the "
                "'Sampler' enum type.".format(sampling_method)
            )
        if stepsize_schedule is None:
            stepsize_schedule = ConstantStepsizeSchedule(float(np.sqrt(1e-4)))
        if not isinstance(stepsize_schedule, StepsizeSchedule):
            stepsize_schedule = ConstantStepsizeSchedule(float(stepsize_schedule))
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        if not isinstance(n_chains, int) or n_chains <= 0:
            raise ValueError("n_chains must be a positive integer")
        if n_chains > 1 and n_nets % n_chains != 0:
            raise ValueError(
                "n_nets ({}) must be divisible by n_chains ({})".format(
                    n_nets, n_chains))
        if log_every is not None and (
            not isinstance(log_every, int) or log_every <= 0
        ):
            raise ValueError("log_every must be a positive integer or None")
        if network not in ("reference", "dense"):
            raise ValueError("network must be 'reference' or 'dense'")
        if step_impl not in ("pytree", "fused", "lanes"):
            raise ValueError(
                "step_impl must be 'pytree', 'fused' or 'lanes'")
        if step_impl == "lanes" and sampling_method not in (
                Sampler.SGHMC, Sampler.SGLD, Sampler.PSGLD,
                Sampler.RelativisticSGHMC, Sampler.SGNHT):
            raise ValueError(
                "step_impl='lanes' supports SGHMC, SGLD, PSGLD, "
                "RelativisticSGHMC and SGNHT")
        units = tuple(int(u) for u in units)
        if not units or any(u <= 0 for u in units):
            raise ValueError("units must be positive layer widths")
        if step_impl == "fused":
            if network != "dense":
                raise ValueError("step_impl='fused' requires network='dense'")
            if not 2 <= len(units) <= 4:
                raise ValueError(
                    "step_impl='fused' supports 2-4 hidden layers; "
                    "got units={!r} (use step_impl='lanes' for other "
                    "topologies)".format(tuple(units)))
            if len(set(units)) != 1:
                raise ValueError(
                    "step_impl='fused' requires equal hidden widths")
            check_hidden(units[0])
            if sampling_method not in (
                Sampler.SGHMC, Sampler.SGLD, Sampler.PSGLD, Sampler.SGNHT,
                Sampler.RelativisticSGHMC,
            ):
                raise ValueError(
                    "step_impl='fused' supports SGHMC, SGLD, PSGLD, SGNHT "
                    "and RelativisticSGHMC")
            if get_net is not None:
                raise ValueError(
                    "step_impl='fused' supports the dense NxH architecture "
                    "family (H <= 114, via units=); pass get_net only with "
                    "step_impl='lanes' or 'pytree'")
        if pair_dots:
            if step_impl != "fused":
                raise ValueError("pair_dots requires step_impl='fused'")
            if len(units) != 3:
                raise ValueError(
                    "pair_dots supports the flagship 3-hidden-layer "
                    "topology only; got units={!r}".format(tuple(units)))
        # noise_impl as JAX's: 'auto' is the fused kernels' MXU-CLT
        # generator, resolved by the drivers (resolve_noise_impl), and
        # Box-Muller elsewhere; the port adds the degenerate stream 'zero'
        if noise_impl == "auto" and (step_impl != "fused" or pair_dots):
            noise_impl = "box_muller"
        if noise_impl not in ("auto", "box_muller", "hadamard_clt", "zero"):
            raise ValueError(
                "noise_impl must be 'box_muller' or 'hadamard_clt'; got "
                + repr(noise_impl))
        if noise_impl == "hadamard_clt" and step_impl != "fused":
            raise ValueError("noise_impl requires step_impl='fused'")
        if noise_impl == "hadamard_clt" and pair_dots:
            raise ValueError(
                "pair_dots kernels support noise_impl='box_muller' only")
        if compute_dtype is not None and compute_dtype not in STATE_DTYPES:
            raise ValueError(
                "compute_dtype must be None, torch.float32 or "
                "torch.bfloat16; got {}".format(compute_dtype))

        # the paths the port has not reached yet (SVGD ignores step_impl)
        if step_impl == "pytree" and sampling_method != Sampler.SVGD:
            raise _not_ported("step_impl='pytree'", "queue A item 6")
        if mesh is not None:
            raise _not_ported("mesh", "queue A item 15")
        if dtype != torch.float32:
            raise _not_ported("dtype={}".format(dtype), "queue A item 6")

        self.sampling_method = sampling_method
        self.get_net = get_net
        self.batch_size = batch_size
        self.stepsize_schedule = stepsize_schedule
        self.n_nets = n_nets
        self.n_iters = n_iters
        self.burn_in_steps = burn_in_steps
        self.sample_steps = sample_steps
        self.normalize_input = normalize_input
        self.normalize_output = normalize_output
        self.seed = seed
        self.n_chains = n_chains
        self.mesh = mesh
        self.log_every = log_every
        self.units = units
        self.pair_dots = bool(pair_dots)
        self.noise_impl = noise_impl
        self.network = network
        self.step_impl = step_impl
        self.compute_dtype = compute_dtype
        self.dtype = dtype
        self.device = torch.device(device)
        self.sampler_kwargs = sampler_kwargs

        self.samples = None  # dict of tensors, leading axis n_nets
        self.is_trained = False
        self.phase_seconds = {}

    #  Likelihood ------------------------------------------------------------

    def negative_log_likelihood(self, apply_fn, params, x, y, n_examples):
        """NLL and MSE of one network's ``params`` on minibatch ``(x, y)``
        (``y`` shaped ``(N, 1)``); returns ``(nll, mse)``.  With
        ``compute_dtype`` set, the network pass runs on the parameters and
        ``x`` cast to it (the likelihood and the priors stay in
        ``dtype``)."""
        net_out = self._network_output(apply_fn, params, x)
        f_mean = net_out[:, 0:1]
        f_log_var = net_out[:, 1:2]
        f_var_inv = 1.0 / (torch.exp(f_log_var) + 1e-16)
        mse = torch.square(y - f_mean)
        log_like = torch.sum(
            torch.sum(-mse * (0.5 * f_var_inv) - 0.5 * f_log_var, dim=1))
        log_like = log_like / self.batch_size
        log_like = log_like + log_variance_prior_log_like(f_log_var) / n_examples
        log_like = log_like + weight_prior_log_like(params) / n_examples
        return -log_like, torch.mean(mse)

    def _network_output(self, apply_fn, params, x):
        """``apply_fn(params, x)``, under ``compute_dtype`` on the
        parameters and ``x`` cast to it and the output cast back to
        ``dtype``, as JAX's BNN does."""
        if self.compute_dtype is None:
            return apply_fn(params, x)
        cast = {name: leaf.to(self.compute_dtype)
                for name, leaf in params.items()}
        return apply_fn(cast, x.to(self.compute_dtype)).to(self.dtype)

    @property
    def _state_dtype(self):
        """The sampling phase's state type: bf16 under ``compute_dtype``,
        as JAX's BNN chooses."""
        return torch.float32 if self.compute_dtype is None \
            else torch.bfloat16

    #  Training ---------------------------------------------------------------

    def _n_collect(self, target=None):
        target = self.n_nets if target is None else target
        budget = max(0, (self.n_iters - self.burn_in_steps) // self.sample_steps)
        n_collect = min(target, budget)
        if n_collect < target:
            logging.warning(
                "BayesianNeuralNetwork: iteration budget n_iters=%d only "
                "allows %d of the requested %d posterior samples",
                self.n_iters, n_collect, self.n_nets,
            )
        if n_collect == 0:
            raise ValueError(
                "BayesianNeuralNetwork: n_iters={} is too small to collect "
                "any samples (burn_in_steps={}, sample_steps={})".format(
                    self.n_iters, self.burn_in_steps, self.sample_steps
                )
            )
        return n_collect

    def _initial_positions(self, init_fn, generator, n_chains):
        """Stacked He-normal initial weights of every chain."""
        return init_fn(generator, (n_chains,))

    def _check_device(self):
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BayesianNeuralNetwork: device={!r} but no CUDA device is "
                "available; pass device='cpu' to run the kernels' plain "
                "PyTorch versions on the CPU".format(str(self.device)))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _phase(self, name):
        """Time the phase ``name`` into ``phase_seconds[name]``, the device
        synchronized at both ends, inside the span ``bnn.<name>``."""
        self._sync()
        start = time.perf_counter()
        with span("bnn." + name):
            yield
            self._sync()
        self.phase_seconds[name] = time.perf_counter() - start

    @BaseModel._check_shapes_train
    def train(self, X, y, *args, **kwargs):
        """Sample ``n_nets`` network-weight snapshots from the posterior:
        ``n_chains`` chains burn in, then each collects its share, one
        snapshot every ``sample_steps`` steps, on the kernels of
        ``step_impl`` (SVGD: ``n_nets`` particles transported jointly for
        ``n_iters`` steps).  ``phase_seconds`` records the wall time of each
        phase, each inside the span ``bnn.<phase>`` while a profiler records
        (:mod:`pysgmcmc_tpu_torch.utils.tracing`; ``predict`` records
        ``bnn.predict`` and, inside it, its copies to the host,
        ``predict.to_host``)."""
        self._check_device()
        start_time = time.time()
        self.X, self.y = X, y

        x_train = np.asarray(X, dtype=np.float64)
        y_train = np.asarray(y, dtype=np.float64)
        if self.normalize_input:
            x_train, self.x_mean, self.x_std = zero_mean_unit_var_normalization(
                x_train)
        if self.normalize_output:
            y_train, self.y_mean, self.y_std = zero_mean_unit_var_normalization(
                y_train)

        n_datapoints, n_inputs = x_train.shape
        if self.step_impl == "fused" and n_inputs > MAX_INPUTS:
            raise ValueError(
                "step_impl='fused' supports up to {} input features (the "
                "flagship architecture family); got n_inputs={}".format(
                    MAX_INPUTS, n_inputs))
        x_dev = torch.as_tensor(x_train, dtype=self.dtype, device=self.device)
        y_dev = torch.as_tensor(y_train, dtype=self.dtype, device=self.device)

        # the architecture is fixed here, at train time: predict() serves
        # what was trained, at any compute_dtype, even if self.network,
        # self.units or self.get_net is changed afterwards.  The builder of a
        # built-in network and its arguments are kept for predict's other
        # precisions; a custom get_net has none (None).
        if self.get_net is not None:
            init_fn, apply_fn = self.get_net
            self._builder = None
        else:
            self._builder = functools.partial(
                dense_network if self.network == "dense" else default_network,
                n_inputs, units=tuple(self.units), device=self.device)
            init_fn, apply_fn = self._builder(dtype=self.dtype)
        self._apply_fn = apply_fn
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        # the kernels' Philox keys (and SVGD's bandwidth subsample) come
        # from a CPU generator, so that one seed draws the same streams on
        # the card and on the CPU
        keys = torch.Generator().manual_seed(self.seed)

        if self.sampling_method == Sampler.SVGD:
            self._train_svgd(
                apply_fn,
                self._initial_positions(init_fn, generator, self.n_nets),
                x_dev, y_dev, n_datapoints, keys)
            logging.info(
                "BayesianNeuralNetwork(SVGD): transported %d particles in "
                "%.2fs", self.n_nets, time.time() - start_time)
            return

        n_chains = max(1, self.n_chains)
        per_chain = self._n_collect(
            self.n_nets // n_chains if self.n_chains > 1 else None)
        positions = self._initial_positions(init_fn, generator, n_chains)
        path = self._fused_path if self.step_impl == "fused" \
            else self._lanes_path
        sampler, burn, sample = path(apply_fn, positions, x_dev, y_dev,
                                     n_datapoints, keys)
        # initial momenta (SGNHT, relativistic SGHMC) from the CPU
        # generator too
        self._run_chains(sampler.init(positions, keys), burn, sample,
                         apply_fn, x_dev, y_dev, n_datapoints, n_chains,
                         per_chain, start_time)

    def _train_svgd(self, apply_fn, particles, x_dev, y_dev, n_datapoints,
                    keys):
        """Train ``n_nets`` particle networks jointly with SVGD, ``n_iters``
        steps from ``particles``: every step takes one minibatch window for
        the whole ensemble (``batch_fn(seed, step, 1)``, the Philox stream
        keyed from ``keys``) and the full cost, priors included, of every
        particle.  ``phase_seconds["transport"]`` records the wall time."""
        def cost_fn(params, batch):
            x_batch, y_batch = batch
            nll, _ = self.negative_log_likelihood(
                apply_fn, params, x_batch, y_batch, n_datapoints)
            return nll

        kwargs = dict(self.sampler_kwargs)
        kwargs.update(cost_fn=cost_fn,
                      stepsize_schedule=self.stepsize_schedule,
                      dtype=self.dtype)
        sampler = Sampler.get_sampler(Sampler.SVGD, **kwargs)
        select_batch = batch_fn(x_dev, y_dev, self.batch_size)
        window_seed = _draw_seed(keys)
        state = sampler.init(particles)
        with self._phase("transport"):
            for step in range(self.n_iters):
                x_batch, y_batch = select_batch(window_seed, step, 1)
                state, _ = sampler.step(state, keys,
                                        (x_batch[0], y_batch[0]))
        self.samples = state.position
        self._n_collected = self.n_nets
        self.is_trained = True

    def _build_sampler(self, cost_fn, n_datapoints, **defaults):
        """The sampler, with ``scale_grad`` = N and the BNN's burn-in length
        unless ``**sampler_kwargs`` set them, each where the sampler has
        it: both for SGHMC and SGLD, ``scale_grad`` for pSGLD and SGNHT,
        neither for relativistic SGHMC."""
        kwargs = dict(self.sampler_kwargs)
        if Sampler.is_burn_in_mcmc(self.sampling_method):
            kwargs.setdefault("scale_grad", float(n_datapoints))
            kwargs.setdefault("burn_in_steps", self.burn_in_steps)
        elif self.sampling_method in (Sampler.PSGLD, Sampler.SGNHT):
            kwargs.setdefault("scale_grad", float(n_datapoints))
        for key, value in defaults.items():
            kwargs.setdefault(key, value)
        return Sampler.get_sampler(
            self.sampling_method, cost_fn=cost_fn,
            stepsize_schedule=self.stepsize_schedule, dtype=self.dtype,
            **kwargs)

    def _fused_path(self, apply_fn, positions, x_dev, y_dev, n_datapoints,
                    keys):
        """``(sampler, burn, sample)`` of the fused kernels: burn-in on B2 /
        B6 for SGHMC and SGLD, on discarded steps of
        :func:`sample_chain_lanes` (B8-psgld, B8-sgnht, B8-rsghmc, one launch
        a step) for the samplers without burn-in machinery, as the JAX
        package's ``make_burn`` does, with float32 state; then one B1 / B5-*
        launch of ``sample_steps`` steps per sample, with bf16 state under
        ``compute_dtype``."""
        n_chains = next(iter(positions.values())).shape[0]
        n_params = tree_size(positions) // n_chains
        prior_scale = 1.0 / (n_params * float(n_datapoints))

        def cost_fn(params, batch):
            # likelihood + log-variance prior only: the weight prior is
            # folded into the sampler update via gaussian_prior_scale
            x_batch, y_batch = batch
            net_out = self._network_output(apply_fn, params, x_batch)
            f_mean = net_out[:, 0:1]
            f_log_var = net_out[:, 1:2]
            f_var_inv = 1.0 / (torch.exp(f_log_var) + 1e-16)
            mse = torch.square(y_batch - f_mean)
            ll = torch.sum(torch.sum(
                -mse * (0.5 * f_var_inv) - 0.5 * f_log_var, dim=1)
            ) / self.batch_size
            return -(ll + log_variance_prior_log_like(f_log_var)
                     / n_datapoints)

        sampler = self._build_sampler(cost_fn, n_datapoints,
                                      gaussian_prior_scale=prior_scale)
        select_batch = batch_fn(x_dev, y_dev, self.batch_size)

        def burn(states, n_steps):
            if Sampler.is_burn_in_mcmc(self.sampling_method):
                return burnin_chain_fused(
                    sampler, states, keys, n_steps, x_dev, y_dev,
                    batch_size=self.batch_size, state_dtype=torch.float32,
                    pair_dots=self.pair_dots, noise_impl=self.noise_impl)
            return self._discarded_steps(sampler, states, keys, n_steps,
                                         select_batch, torch.float32)

        def sample(states, n_keep):
            return sample_chain_fused(
                sampler, states, keys, n_keep, x_dev, y_dev,
                batch_size=self.batch_size, keep_every=self.sample_steps,
                state_dtype=self._state_dtype, multistep=True,
                pair_dots=self.pair_dots, noise_impl=self.noise_impl)

        return sampler, burn, sample

    def _lanes_path(self, apply_fn, positions, x_dev, y_dev, n_datapoints,
                    keys):
        """``(sampler, burn, sample)`` of the chains-on-lanes kernels: the
        full cost, weight prior included, differentiated per chain; burn-in
        on B9-sghmc / B9-sgld, sampling on B7 / B8-sgld, one launch per
        step, each chain on its own minibatch window.  The samplers without
        burn-in machinery burn in on discarded steps of
        :func:`sample_chain_lanes`, as they sample.  The network passes run
        in ``compute_dtype``; the state is float32 in the adaptive burn-in
        and bf16 elsewhere under ``compute_dtype``, as in JAX."""
        def cost_fn(params, batch):
            x_batch, y_batch = batch
            nll, _ = self.negative_log_likelihood(
                apply_fn, params, x_batch, y_batch, n_datapoints)
            return nll

        sampler = self._build_sampler(cost_fn, n_datapoints)
        select_batch = batch_fn(x_dev, y_dev, self.batch_size)

        def burn(states, n_steps):
            if Sampler.is_burn_in_mcmc(self.sampling_method):
                return burnin_chain_lanes(sampler, states, keys, n_steps,
                                          batch_fn=select_batch,
                                          compute_dtype=self.compute_dtype,
                                          state_dtype=torch.float32,
                                          noise_impl=self.noise_impl)
            return self._discarded_steps(sampler, states, keys, n_steps,
                                         select_batch, self._state_dtype)

        def sample(states, n_keep):
            return sample_chain_lanes(
                sampler, states, keys, n_keep, batch_fn=select_batch,
                keep_every=self.sample_steps,
                compute_dtype=self.compute_dtype,
                state_dtype=self._state_dtype, noise_impl=self.noise_impl)

        return sampler, burn, sample

    def _discarded_steps(self, sampler, states, keys, n_steps, select_batch,
                         state_dtype):
        """The burn-in of pSGLD, SGNHT and relativistic SGHMC, which have no
        burn-in machinery: ``n_steps`` discarded steps of
        :func:`sample_chain_lanes` (JAX's ``make_burn``), network passes in
        ``compute_dtype``, Box-Muller normals (that driver's only generator)
        or the degenerate stream under ``noise_impl="zero"``."""
        return sample_chain_lanes(
            sampler, states, keys, 1, batch_fn=select_batch,
            keep_every=n_steps, compute_dtype=self.compute_dtype,
            state_dtype=state_dtype, collect_positions=False,
            noise_impl="zero" if self.noise_impl == "zero" else "auto")[0]

    def _run_chains(self, states, burn, sample, apply_fn, x_dev, y_dev,
                    n_datapoints, n_chains, per_chain, start_time):
        """Burn-in then sampling through ``burn(states, n_steps)`` and
        ``sample(states, n_keep)``, chunked at ``log_every`` burn-in steps
        and at every collected sample for the reference's progress lines;
        ``phase_seconds`` records the wall time of each phase."""
        y_col = y_dev.reshape(-1, 1)
        metrics_fn = torch.func.vmap(
            lambda pos: self.negative_log_likelihood(
                apply_fn, pos, x_dev, y_col, n_datapoints))

        def log_point(iteration, positions_now, n_samples=None):
            if self.log_every is None or not logging.getLogger(
            ).isEnabledFor(logging.INFO):
                return
            with torch.no_grad():
                nll, mse = metrics_fn(positions_now)
            suffix = "" if n_samples is None else " Samples = {}".format(
                n_samples)
            logging.info(
                "Iter %8d : NLL = %.4e MSE = %.4e%s Time = %5.2f",
                iteration, float(nll.mean()), float(mse.mean()), suffix,
                time.time() - start_time)

        log_point(0, states.position)
        if self.log_every is not None and self.burn_in_steps > 0:
            n_full, rem = divmod(self.burn_in_steps, self.log_every)
            seg_lengths = [self.log_every] * n_full + ([rem] if rem else [])
        else:
            seg_lengths = (
                [self.burn_in_steps] if self.burn_in_steps > 0 else [])
        iteration = 0
        with self._phase("burn_in"):
            for n_steps in seg_lengths:
                states = burn(states, n_steps)
                iteration += n_steps
                log_point(iteration, states.position)

        with self._phase("sampling"):
            if self.log_every is not None:
                # one driver call per collected sample, logged like the
                # reference's per-sample progress line
                chunks = []
                for j in range(per_chain):
                    states, pos, _ = sample(states, 1)
                    chunks.append(pos)
                    iteration += self.sample_steps
                    log_point(iteration, states.position,
                              n_samples=(j + 1) * n_chains)
                samples = {name: torch.cat([c[name] for c in chunks], dim=1)
                           for name in chunks[0]}
            else:
                states, samples, _ = sample(states, per_chain)

        # pool: (n_chains, per_chain, ...) -> (n_chains * per_chain, ...)
        self.samples = {name: leaf.reshape((-1,) + leaf.shape[2:])
                        for name, leaf in samples.items()}
        self._n_collected = n_chains * per_chain
        self.is_trained = True
        logging.info(
            "BayesianNeuralNetwork(%s %s): %d chains x %d samples in %.2fs",
            self.step_impl, self.sampling_method.value, n_chains, per_chain,
            time.time() - start_time)

    #  Prediction ----------------------------------------------------------

    def compute_network_output(self, params, input_data):
        """Forward pass of one weight sample (or of stacked ones, where the
        network broadcasts)."""
        return self._apply_fn(params, torch.as_tensor(
            input_data, dtype=self.dtype, device=self.device))

    def _serving_fn(self, compute_dtype):
        """The ensemble forward at ``compute_dtype``: the trained built-in
        network rebuilt at that precision, by the builder ``train`` kept,
        over copies of the samples cast to it, the outputs widened to
        float32 (JAX's ``_serving_fn``)."""
        if self._builder is None:
            raise ValueError(
                "predict(compute_dtype=...) supports the built-in "
                "architectures only (get_net is custom; its apply closes "
                "over its own precision)")
        _, apply_cd = self._builder(dtype=compute_dtype)

        def ensemble(samples, x):
            cast = {name: leaf.to(compute_dtype)
                    for name, leaf in samples.items()}
            out = torch.func.vmap(apply_cd, in_dims=(0, None))(cast, x)
            return out.to(torch.float32)
        return ensemble

    @BaseModel._check_shapes_predict
    @spanned("bnn.predict")
    def predict(self, X_test, return_individual_predictions=False,
                compute_dtype=None, *args, **kwargs):
        """Ensemble predictive mean and variance at ``X_test``: one forward
        pass of every posterior sample, vectorized over the samples.
        ``compute_dtype`` (``torch.bfloat16``) serves the ensemble at that
        precision, the reduction in float32, as JAX's serving path does."""
        if not self.is_trained:
            raise ValueError(
                "Calling `bnn.predict()` on an untrained Bayesian Neural "
                "Network 'bnn' is not supported! Please call `bnn.train()` "
                "before calling `bnn.predict()`"
            )

        x_test = np.asarray(X_test, dtype=np.float64)
        if self.normalize_input:
            x_test, _, _ = zero_mean_unit_var_normalization(
                x_test, self.x_mean, self.x_std)
        if compute_dtype is not None and compute_dtype != self.dtype:
            ensemble_fn = self._serving_fn(compute_dtype)
            x_dev = torch.as_tensor(x_test, dtype=compute_dtype,
                                    device=self.device)
        else:
            ensemble_fn = torch.func.vmap(self._apply_fn, in_dims=(0, None))
            x_dev = torch.as_tensor(x_test, dtype=self.dtype,
                                    device=self.device)
        with torch.no_grad():
            outputs = ensemble_fn(self.samples, x_dev)
        with span("predict.to_host"):
            f_out = outputs[:, :, 0].cpu().numpy()
            log_noise = outputs[:, :, 1].cpu().numpy()
        theta_noise = np.exp(log_noise)

        if return_individual_predictions:
            if self.normalize_output:
                f_out = zero_mean_unit_var_unnormalization(
                    f_out, self.y_mean, self.y_std)
                theta_noise *= self.y_std**2
            return f_out, theta_noise

        mean_prediction = np.mean(f_out, axis=0)
        variance_prediction = np.mean((f_out - mean_prediction) ** 2, axis=0)

        if self.normalize_output:
            mean_prediction = zero_mean_unit_var_unnormalization(
                mean_prediction, self.y_mean, self.y_std)
            variance_prediction *= self.y_std**2
        return mean_prediction, variance_prediction


__all__ = [
    "BayesianNeuralNetwork",
    "log_variance_prior_log_like",
    "weight_prior_log_like",
]
