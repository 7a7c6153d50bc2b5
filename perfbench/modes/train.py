"""Mode ``train``: whole trains of the fused SGHMC BNN.

Each train is ``BayesianNeuralNetwork(step_impl="fused", network="dense",
...).train(x, y)`` on fresh chains from a seed derived from the run's seed
and the train's index, then ``predict`` on a grid over the training inputs.
The window runs whole trains until ``--seconds`` have passed; ``train_s`` is
the window's elapsed time, ending in a synchronize, over its trains.

The check takes the window's last train: it follows the chosen chains
through every driver call of the train from the state the program handed
to the call (:class:`perfbench.fused.FusedCell`), compares the initial state
exactly, links every call exactly to the one before, and compares the
predictive mean and variance over all members.
"""

import time

import numpy as np

from perfbench import fused, shared
from pysgmcmc_tpu_torch.models import bayesian_neural_network as bnn_module
from pysgmcmc_tpu_torch.models.bayesian_neural_network import (
    BayesianNeuralNetwork,
)


class Cell(fused.FusedCell):
    """The ``train`` mode of one run (see the module docstring)."""

    def model(self, seed, burn_in_steps, sample_steps, log_every):
        cfg = self.config
        return BayesianNeuralNetwork(
            step_impl="fused", network="dense", units=tuple(cfg["units"]),
            n_chains=self.n_chains, n_nets=self.n_chains,
            burn_in_steps=burn_in_steps, sample_steps=sample_steps,
            n_iters=burn_in_steps + sample_steps, log_every=log_every,
            batch_size=cfg["batch_size"], stepsize_schedule=cfg["stepsize"],
            noise_impl=cfg["noise_impl"], seed=seed, device=self.device)

    def setup(self):
        self.make_data()
        self.grid = np.linspace(float(self.x.min()), float(self.x.max()),
                                self.traffic["predict_points"])[:, None]
        # a short train on the same shapes loads every kernel and handle
        with self.tapped(bnn_module):
            self.restart_stream()
            model = self.model(shared.derived_seed(self.seed, 10**6), 16, 8,
                               8)
            model.train(self.x, self.y)
            model.predict(self.grid)
        self.synchronize()

    def window(self, seconds):
        mix = self.traffic
        self.counts.update(launches=[], trains=0, burnin_s=[])
        start = time.perf_counter()
        deadline = start + seconds
        with self.tapped(bnn_module):
            while True:
                seed = shared.derived_seed(self.seed, self.counts["trains"])
                self.restart_stream()
                with self.spans("train"):
                    model = self.model(seed, mix["burn_in_steps"],
                                       mix["sample_steps"], mix["log_every"])
                    model.train(self.x, self.y)
                    with self.spans("predict"):
                        mean, var = model.predict(self.grid)
                self.counts["trains"] += 1
                self.counts["burnin_s"].append(model.phase_seconds["burn_in"])
                self.last = dict(model=model, seed=seed, calls=self.calls,
                                 mean=mean, var=var)
                if time.perf_counter() >= deadline:
                    break
        self.synchronize()
        elapsed = time.perf_counter() - start
        trains = self.counts["trains"]
        self.counts["predict_calls"] = (trains, mix["predict_points"])
        return {"train_s": elapsed / trains}, trains

    def check(self, control=False):
        last = self.last
        numbers = self.follow_calls(last["seed"], last["calls"], control)
        numbers["link_gap"] = self.link_gap(last["calls"])
        numbers["predict_gap"] = self.predict_gap(
            self.pack(last["model"].samples), self.grid, last["mean"],
            last["var"], control)
        return numbers
