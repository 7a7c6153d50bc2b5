"""Mode ``sample``: sampling continued after burn-in, on the fused kernels.

Set-up burns the chains in as the BNN's fused path does (one
``burnin_chain_fused`` call of ``burn_in_steps`` steps, float32 state).
The window calls ``sample_chain_fused(n_samples, keep_every=...,
multistep=True, collect_positions=True, state_dtype=torch.float32)`` again
and again, each call continuing the chains and its positions dropped after
it; ``sample_rate`` is the chain-steps of the window's calls over its
elapsed time, ending in a synchronize.

The check follows the chosen chains through the window's last call and
calls drawn from the seed, from the state the program handed to each
(:class:`perfbench.fused.FusedCell`), for ``check_steps`` steps; it
compares the initial state exactly, and links every call, set-up's
included, exactly to the one before.  The burn-in that set-up runs, one
call of ``burn_in_steps`` steps, is too long to follow (``PERF.md``): the
train cell follows the same kernel in chunks.
"""

import time

import torch

from perfbench import fused, shared
from pysgmcmc_tpu_torch.models.architectures import dense_network
from pysgmcmc_tpu_torch.parallel import packed
from pysgmcmc_tpu_torch.sampling import Sampler


def _cost_in_kernel(params, batch):
    raise RuntimeError("the fused kernels compute the cost themselves")


class Cell(fused.FusedCell):
    """The ``sample`` mode of one run (see the module docstring)."""

    def sample(self, n_samples, keep_every):
        self.states, _, _ = packed.sample_chain_fused(
            self.sampler, self.states, self.keys, n_samples, self.x_dev,
            self.y_dev, batch_size=self.config["batch_size"],
            keep_every=keep_every, state_dtype=torch.float32,
            collect_positions=True, multistep=True,
            noise_impl=self.config["noise_impl"])

    def setup(self):
        cfg, mix = self.config, self.traffic
        self.make_data()
        init, _ = dense_network(self.shape[0], units=tuple(cfg["units"]),
                                device=self.device)
        positions = init(torch.Generator(device=self.device).manual_seed(
            self.seed), (self.n_chains,))
        self.sampler = Sampler.get_sampler(
            Sampler.SGHMC, cost_fn=_cost_in_kernel,
            stepsize_schedule=cfg["stepsize"], mdecay=cfg["mdecay"],
            scale_grad=float(cfg["n_data"]),
            burn_in_steps=mix["burn_in_steps"],
            gaussian_prior_scale=1.0 / (self.n_params * cfg["n_data"]))
        self.keys = torch.Generator().manual_seed(self.seed)
        self.restart_stream()
        with self.tapped(packed):
            self.states = packed.burnin_chain_fused(
                self.sampler, self.sampler.init(positions, self.keys),
                self.keys, mix["burn_in_steps"], self.x_dev, self.y_dev,
                batch_size=cfg["batch_size"], state_dtype=torch.float32,
                noise_impl=cfg["noise_impl"])
            self.sample(mix["n_samples"], 2)  # loads the sampling kernel
        self.synchronize()

    def window(self, seconds):
        mix = self.traffic
        self.counts.update(launches=[], calls=0)
        self.setup_calls, self.calls = self.calls, []
        start = time.perf_counter()
        deadline = start + seconds
        with self.tapped(packed):
            while True:
                with self.spans("sample"):
                    self.sample(mix["n_samples"], mix["keep_every"])
                self.counts["calls"] += 1
                if time.perf_counter() >= deadline:
                    break
        self.synchronize()
        elapsed = time.perf_counter() - start
        steps = self.counts["calls"] * mix["n_samples"] * mix["keep_every"]
        return {"sample_rate": self.n_chains * steps / elapsed}, \
            self.counts["calls"]

    def release(self):
        self.states = None

    def check(self, control=False):
        """The window's last call and ``check_calls`` more drawn from the
        seed, each followed from the state the program handed to it."""
        picks = set(shared.chosen(self.seed, len(self.calls),
                                  self.traffic["check_calls"]).tolist())
        picks.add(len(self.calls) - 1)
        numbers = self.follow_calls(
            self.seed, [self.calls[i] for i in sorted(picks)], control)
        numbers["init_gap"] = self.init_gap(self.seed,
                                            self.setup_calls[0]["into"])
        numbers["link_gap"] = self.link_gap(self.setup_calls + self.calls)
        return numbers
