"""SG-MCMC over the weights of a language model: SGHMC with the self-tuning
burn-in of Springenberg et al. (NIPS 2016) on the chains-on-lanes drivers.

The likelihood is categorical: the cost of a window of token sequences is
the corpus' token count ``N`` times the mean next-token cross-entropy over
the window (the logits over the network's vocabulary, a slice where the
network holds one); ``scale_grad`` is ``N`` and the isotropic Gaussian prior
enters the update as ``gaussian_prior_scale * theta`` with a scale of
``1 / N``.  One chain: burn-in on :func:`~pysgmcmc_tpu_torch.parallel.packed.
burnin_chain_lanes` (kernel B9-sghmc), sampling on :func:`~pysgmcmc_tpu_
torch.parallel.packed.sample_chain_lanes` (B7), float32 state, every step's
gradient by plain autograd through the network (one chain needs no
``vmap``, so a dropless expert layer, whose shapes follow the routing, can
run).  Each array of the state lives as views of one ``(1, P)`` buffer,
which the drivers take without a copy.

The network's products run at :data:`MATMUL_PRECISION` (float32 operands
on TF32 products), set around the model's steps and ``predict`` and restored
after them.  The noise is the lanes kernels' Box-Muller stream.

Examples
--------
>>> import torch
>>> from pysgmcmc_tpu_torch.models.moe_transformer import (
...     MOONLIGHT_16B_A3B, moe_transformer)
>>> cfg = dict(MOONLIGHT_16B_A3B, hidden_size=16, intermediate_size=24,
...            moe_intermediate_size=8, n_routed_experts=4,
...            num_experts_per_tok=2, num_hidden_layers=2,
...            num_attention_heads=2, kv_lora_rank=8, qk_nope_head_dim=4,
...            qk_rope_head_dim=4, v_head_dim=4, vocab_size=32)
>>> net = moe_transformer(cfg, held_experts=[0, 1], device="cpu")
>>> corpus = torch.randint(0, 32, (12, 9),
...                        generator=torch.Generator().manual_seed(0))
>>> model = BayesianLanguageModel(net, batch_size=2, burn_in_steps=2,
...                               n_nets=2, sample_steps=2, device="cpu")
>>> model.train(corpus[:, :-1], corpus[:, 1:])
>>> mean, var = model.predict(corpus[:3, :-1])
>>> tuple(mean.shape), bool(torch.allclose(mean.sum(-1), torch.ones(3, 8)))
((3, 8, 32), True)
"""

import contextlib

import torch
import torch.nn.functional as F

from pysgmcmc_tpu_torch.data_batches import batch_fn
from pysgmcmc_tpu_torch.models.base_model import BaseModel
from pysgmcmc_tpu_torch.parallel.packed import (
    burnin_chain_lanes,
    make_lanes_spec,
    pack_lanes,
    sample_chain_lanes,
    unpack_lanes,
)
from pysgmcmc_tpu_torch.sampling import Sampler
from pysgmcmc_tpu_torch.samplers._adaptive import AdaptiveStats
from pysgmcmc_tpu_torch.stepsize_schedules import WarmupStepsizeSchedule

# torch.set_float32_matmul_precision of the network's passes: float32
# operands on the tensor cores' TF32 products
MATMUL_PRECISION = "high"


class BayesianLanguageModel(BaseModel):
    """SGHMC posterior samples of a language model's weights (module
    docstring).

    ``get_net`` is an ``(init, apply)`` pair as :func:`~pysgmcmc_tpu_torch.
    models.moe_transformer.moe_transformer` returns: ``init(generator,
    batch_shape)`` draws the parameters, ``apply(params, tokens)`` gives
    ``(..., length, vocab)`` logits.  ``train(X, y)`` takes integer token
    sequences ``X`` and their next tokens ``y``, both ``(n_sequences,
    length)``; a step's window is ``batch_size`` consecutive sequences
    (:func:`~pysgmcmc_tpu_torch.data_batches.batch_fn` on the Philox
    stream).  It burns in for ``burn_in_steps`` steps, then keeps ``n_nets``
    samples ``sample_steps`` steps apart.  ``device="cuda"`` (the default)
    runs the slim kernels; ``"cpu"`` their plain versions.
    """

    def __init__(self, get_net, batch_size=8, stepsize_schedule=None,
                 mdecay=0.05, burn_in_steps=8, n_nets=2, sample_steps=8,
                 seed=0, device="cuda"):
        super().__init__()
        for name, value, least in (("batch_size", batch_size, 1),
                                   ("burn_in_steps", burn_in_steps, 0),
                                   ("n_nets", n_nets, 1),
                                   ("sample_steps", sample_steps, 1)):
            if not isinstance(value, int) or value < least:
                raise ValueError("{} must be an integer of at least "
                                 "{}".format(name, least))
        self.init_fn, self.apply_fn = get_net
        self.batch_size = batch_size
        # the burn-in's first step runs at minv = 1, before v_hat has seen
        # a gradient of N times the mean loss, and takes a small stepsize
        self.stepsize_schedule = WarmupStepsizeSchedule(1e-3, 1e-6) \
            if stepsize_schedule is None else stepsize_schedule
        self.mdecay = float(mdecay)
        self.burn_in_steps = burn_in_steps
        self.n_nets = n_nets
        self.sample_steps = sample_steps
        self.seed = int(seed)
        self.device = torch.device(device)
        self.samples = None
        self.is_trained = False

    @contextlib.contextmanager
    def precision(self):
        """The network's product precision, restored on exit."""
        before = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(MATMUL_PRECISION)
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(before)

    def cost(self, params, batch):
        """``N`` times the mean next-token cross-entropy of ``params`` on a
        window ``(tokens, targets)``."""
        tokens, targets = batch
        logits = self.apply_fn(params, tokens)
        return self.n_tokens * F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())

    def start(self, X, y):
        """Set up the sampler and the windows of the corpus ``(X, y)`` and
        return the chain's initial state: weights from ``init``, momentum 0,
        the burn-in statistics 1."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BayesianLanguageModel: device={!r} but no CUDA device is "
                "available; pass device='cpu' to run the kernels' plain "
                "PyTorch versions".format(str(self.device)))
        X = torch.as_tensor(X, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        if X.is_floating_point() or X.ndim != 2 or y.shape != X.shape:
            raise ValueError("X and y must be integer token sequences of one "
                             "shape (n_sequences, length); got {} and "
                             "{}".format(tuple(X.shape), tuple(y.shape)))
        self.X, self.y = X, y
        self.n_tokens = X.numel()
        self.sampler = Sampler.get_sampler(
            Sampler.SGHMC, cost_fn=self.cost,
            stepsize_schedule=self.stepsize_schedule,
            burn_in_steps=self.burn_in_steps, mdecay=self.mdecay,
            scale_grad=float(self.n_tokens),
            gaussian_prior_scale=1.0 / self.n_tokens)
        self.select = batch_fn(X, y, self.batch_size)
        # the kernels' Philox keys come from a CPU generator, so that one
        # seed draws the same stream on the card and on the CPU
        self.keys = torch.Generator().manual_seed(self.seed)
        weights = self.init_fn(torch.Generator(device=self.device)
                               .manual_seed(self.seed), (1,))
        spec = make_lanes_spec({name: leaf[0]
                                for name, leaf in weights.items()})

        def flat(fill=None):
            buffer = pack_lanes(spec, weights) if fill is None else \
                torch.full((1, spec.width), fill, device=self.device)
            return unpack_lanes(spec, buffer)

        ones = flat(1.0)
        state = self.sampler.init(flat())
        del weights
        return state._replace(momentum=flat(0.0), stats=AdaptiveStats(
            tau=ones, g=ones, v_hat=ones, minv=ones))

    def burn_in(self, states, n_steps):
        """``n_steps`` burn-in steps (B9-sghmc), one driver call a step: a
        call holds its caller's state beside its own, and one call a step
        keeps that to a single state's arrays."""
        with self.precision():
            for _ in range(n_steps):
                states = burnin_chain_lanes(
                    self.sampler, states, self.keys, 1,
                    batch_fn=self.select, compute_dtype=None,
                    state_dtype=torch.float32)
        return states

    def sample(self, states, n_samples, keep_every=None,
               collect_positions=True):
        """``n_samples`` samples ``keep_every`` (default ``sample_steps``)
        steps apart (B7): ``(states, positions, costs)`` as
        :func:`~pysgmcmc_tpu_torch.parallel.packed.sample_chain_lanes`.
        Sampling reads only the burn-in's last ``minv``: the states it
        returns no longer carry tau, g and v_hat (``None``), whose arrays
        are then freed."""
        stats = states.stats._replace(tau=None, g=None, v_hat=None)
        with self.precision():
            return sample_chain_lanes(
                self.sampler, states._replace(stats=stats), self.keys,
                n_samples,
                batch_fn=self.select,
                keep_every=keep_every or self.sample_steps,
                compute_dtype=None, state_dtype=torch.float32,
                collect_positions=collect_positions)

    def train(self, X, y):
        """Burn in, then keep ``n_nets`` samples (module docstring)."""
        states = self.burn_in(self.start(X, y), self.burn_in_steps)
        _, positions, _ = self.sample(states, self.n_nets)
        self.samples = {name: leaf[0] for name, leaf in positions.items()}
        self.is_trained = True

    def predict(self, X_test):
        """The posterior predictive next-token distribution at the token
        sequences ``X_test`` ``(n, length)``: the mean over the kept samples
        of each sample's softmax, and its variance over them, both ``(n,
        length, vocab)`` on the model's device."""
        if not self.is_trained:
            raise ValueError("BayesianLanguageModel.predict needs a trained "
                             "model: call train() first")
        tokens = torch.as_tensor(X_test, device=self.device)
        probs = []
        with torch.no_grad(), self.precision():
            for j in range(self.n_nets):
                params = {name: leaf[j] for name, leaf in self.samples.items()}
                probs.append(torch.softmax(self.apply_fn(params, tokens),
                                           dim=-1))
        probs = torch.stack(probs)
        mean = probs.mean(dim=0)
        return mean, ((probs - mean) ** 2).mean(dim=0)


__all__ = ["BayesianLanguageModel"]
