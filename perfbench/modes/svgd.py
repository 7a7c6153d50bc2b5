"""Mode ``svgd``: SVGD transport of a BNN ensemble, step after step.

Set-up initialises the particles as the BNN does (the reference network's
He-normal draws from the seed on the device) and builds the sampler as
``BayesianNeuralNetwork._train_svgd`` does, with the BNN's own cost.  The
window drives ``SVGDSampler.step`` as that loop does: one minibatch window
of the Philox stream a step for the whole ensemble; ``svgd_rate`` is the
particle-steps of the window over its elapsed time, ending in a
synchronize.

The check takes two steps, one drawn from the seed among the window's first
``check_from`` and the window's last, and computes each with the reference
from the state the program handed to it: ``transport_gap`` is the
:func:`perfbench.shared.high_gap` over the particles of a row's widest gap
in the particles' change and in the Adagrad accumulator (not the widest
row: a few particles' elements, whose direction is near zero, turn
rounding into a sign under Adagrad).  The initial particles are compared
exactly.
"""

import time

import torch

from perfbench import shared
from perfbench.reference import bnn as ref_bnn
from perfbench.reference import init as ref_init
from perfbench.reference import stream as ref_stream
from pysgmcmc_tpu_torch.data_batches import batch_fn
from pysgmcmc_tpu_torch.models.architectures import default_network
from pysgmcmc_tpu_torch.models.bayesian_neural_network import (
    BayesianNeuralNetwork,
)
from pysgmcmc_tpu_torch.samplers import svgd as svgd_module
from pysgmcmc_tpu_torch.sampling import Sampler


class Cell(shared.Cell):
    """The ``svgd`` mode of one run (see the module docstring)."""

    def __init__(self, *args):
        super().__init__(*args)
        cfg = self.config
        self.n = int(cfg["n_particles"])
        self.shape = (int(cfg["n_inputs"]), int(cfg["units"][0]),
                      len(cfg["units"]))
        self.names = list(ref_stream.param_offsets(*self.shape))

    def setup(self):
        cfg = self.config
        (self.x, self.y, self.x_dev, self.y_dev,
         self.norm) = shared.sinc_data(self.seed, cfg["n_data"], self.device)
        model = BayesianNeuralNetwork(
            sampling_method=Sampler.SVGD, network=cfg["network"],
            units=tuple(cfg["units"]), n_nets=self.n,
            batch_size=cfg["batch_size"], kernel_impl=cfg["kernel_impl"],
            stepsize_schedule=cfg["stepsize"], device=self.device)
        init, apply = default_network(self.shape[0], tuple(cfg["units"]),
                                      device=self.device)
        n_data = cfg["n_data"]

        def cost_fn(params, batch):
            return model.negative_log_likelihood(apply, params, batch[0],
                                                 batch[1], n_data)[0]

        self.sampler = Sampler.get_sampler(
            Sampler.SVGD, cost_fn=cost_fn,
            stepsize_schedule=model.stepsize_schedule,
            dtype=torch.float32, kernel_impl=cfg["kernel_impl"])
        self.select = batch_fn(self.x_dev, self.y_dev, cfg["batch_size"])
        self.keys = torch.Generator().manual_seed(self.seed)
        self.window_seed = ref_stream.draw_seed(self.keys)
        self.state = self.sampler.init(init(torch.Generator(
            device=self.device).manual_seed(self.seed), (self.n,)))
        self.initial = self.flat(self.state.position)
        self.steps = 0
        for _ in range(self.traffic["warmup_steps"]):
            self.step()
        self.synchronize()

    def flat(self, tree):
        return torch.cat([tree[name].reshape(self.n, -1)
                          for name in self.names], dim=1)

    def step(self):
        x_batch, y_batch = self.select(self.window_seed, self.steps, 1)
        self.state, _ = self.sampler.step(self.state, self.keys,
                                          (x_batch[0], y_batch[0]))
        self.steps += 1

    def window(self, seconds):
        mix = self.traffic
        pick = int(shared.chosen(self.seed, mix["check_from"], 1)[0])
        self.kept = {}
        first = self.steps
        start = time.perf_counter()
        deadline = start + seconds
        with self.spans.around(svgd_module, "svgd_phi_streaming",
                               "svgd_phi_streaming"):
            while True:
                before = self.state
                with self.spans("svgd_step"):
                    self.step()
                if self.steps - first - 1 == pick:
                    self.kept["picked"] = (self.steps - 1, before, self.state)
                self.kept["last"] = (self.steps - 1, before, self.state)
                if time.perf_counter() >= deadline:
                    break
        self.synchronize()
        elapsed = time.perf_counter() - start
        n_steps = self.steps - first
        self.counts.update(steps=n_steps, particles=self.n)
        return {"svgd_rate": self.n * n_steps / elapsed}, n_steps

    def release(self):
        self.state = None

    def check(self, control=False):
        numbers = {"init_gap": float((self.initial - ref_init.initial_weights(
            self.seed, self.n, *self.shape, self.device)).abs().max())}
        gaps = []
        for step, before, after in self.kept.values():
            gaps += self.step_gaps(step, before, after, control)
        numbers.update(shared.summarise({"transport_gap": gaps}))
        return numbers

    def reference_step(self, step, x, hist, precision):
        """One SVGD step of the reference from ``(x, hist)``: the new
        particles and accumulator."""
        cfg = self.config
        widx = ref_stream.windows(
            self.window_seed, torch.tensor([step], device=self.device),
            torch.zeros(1, dtype=torch.int64, device=self.device),
            self.x_dev.shape[0] - cfg["batch_size"] + 1)[0, 0]
        rows = slice(int(widx), int(widx) + cfg["batch_size"])
        xb = self.x_dev[rows].expand(self.n, -1, -1)
        yb = self.y_dev[rows].expand(self.n, -1)
        n_params = x.shape[1]
        inv_b = torch.tensor(1.0 / cfg["batch_size"],
                             dtype=torch.float32).item()
        inv_n = torch.tensor(1.0 / cfg["n_data"], dtype=torch.float32).item()
        _, grads = ref_bnn.cost_and_grad(x, xb, yb, self.shape, inv_b, inv_n,
                                         precision)
        grads = grads + x / float(n_params) / float(cfg["n_data"])
        phi = ref_bnn.svgd_phi(x, grads, precision)
        alpha, eps = cfg["alpha"], torch.tensor(cfg["stepsize"],
                                                dtype=torch.float32)
        hist_new = alpha * hist + (1.0 - alpha) * phi ** 2
        return x + eps.item() * (phi / (cfg["fudge_factor"]
                                        + torch.sqrt(hist_new))), hist_new

    def step_gaps(self, step, before, after, control):
        """The rows' gaps of the particles' change and of the accumulator
        in step ``step``."""
        x, hist = self.flat(before.position), self.flat(before.historical_grad)
        ref_x, ref_hist = self.reference_step(step, x, hist, "float32")
        if control:
            new_x, new_hist = self.reference_step(step, x, hist, "tf32")
        else:
            new_x = self.flat(after.position)
            new_hist = self.flat(after.historical_grad)
        return [shared.row_gaps(new_x - x, ref_x - x),
                shared.row_gaps(new_hist, ref_hist)]
