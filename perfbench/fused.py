"""What the modes of the fused SGHMC BNN share: the cell's sizes and data,
the taps on the fused drivers, and the checks against the plain reference.

A tap sees each call into ``burnin_chain_fused`` and ``sample_chain_fused``
(through :meth:`perfbench.shared.Spans.around`, which also records the
call's span) and keeps, for the chains the check follows, the state the
call was handed and the state it returned, and a sampling call's positions
and costs within the check's horizon and its last position.  The check
follows those chains through each call with the reference, from the state
the program handed to it: the trajectories of two float32 programs part by
rounding that grows over thousands of steps, so the reference cannot start
from the initial weights alone (``PERF.md``).  It also holds, bit for bit,
each call's state to the one the call before returned, and each sampling
call's returned position to its last kept one.
"""

import contextlib

import numpy as np
import torch

from perfbench import shared
from perfbench.reference import bnn as ref_bnn
from perfbench.reference import init as ref_init
from perfbench.reference import sghmc as ref_sghmc
from perfbench.reference import stream as ref_stream


class FusedCell(shared.Cell):
    """A cell of the fused SGHMC BNN (configuration ``bnn`` with sampler
    ``sghmc``, ``step_impl`` ``fused``)."""

    def __init__(self, *args):
        super().__init__(*args)
        cfg = self.config
        self.n_chains = int(cfg["n_chains"])
        self.shape = (int(cfg["n_inputs"]), int(cfg["units"][0]),
                      len(cfg["units"]))
        self.names = list(ref_stream.param_offsets(*self.shape))
        self.n_params = ref_stream.n_params(*self.shape)
        self.idx = shared.chosen(self.seed, self.n_chains,
                                 self.traffic["check_chains"]).to(self.device)
        self.calls = []
        self.draws = 0
        self.stream_step = 0
        self.counts["launches"] = []

    def make_data(self):
        cfg = self.config
        (self.x, self.y, self.x_dev, self.y_dev,
         self.norm) = shared.sinc_data(self.seed, cfg["n_data"], self.device)
        self.x_win, self.y_win = ref_sghmc.data_windows(
            self.x_dev, self.y_dev, cfg["batch_size"])

    def rule(self, burn_in):
        cfg = self.config
        n_data = float(cfg["n_data"])
        return dict(eps=cfg["stepsize"], scale_grad=n_data,
                    mdecay=cfg["mdecay"], n_data=cfg["n_data"],
                    prior_scale=1.0 / (self.n_params * n_data),
                    burn_in=burn_in)

    #  Taps ---------------------------------------------------------------

    def rows(self, tree):
        """The followed chains' rows of a parameter dict, flat ``(k, P)``."""
        return torch.cat([tree[name].reshape(tree[name].shape[0], -1)
                          .index_select(0, self.idx).float()
                          for name in self.names], dim=1)

    def restart_stream(self):
        """A new key generator: its draws and steps count from 0."""
        self.calls = []
        self.draws = 0
        self.stream_step = 0

    def _note(self, kind, n_steps, n_keep=0, keep_every=0):
        """A driver call: it draws the stream's next key and advances the
        absolute step; counted (``counts["launches"]``) for the readers."""
        call = dict(kind=kind, draw=self.draws, step0=self.stream_step,
                    n_steps=n_steps)
        self.draws += 1
        self.stream_step += n_steps
        self.counts["launches"].append(dict(
            kind=kind, n_chains=self.n_chains, n_steps=n_steps,
            n_keep=n_keep, keep_every=keep_every))
        return call

    def _burn_tap(self, args, kwargs, out):
        states, n_steps = args[1], int(args[3])
        call = self._note("burn", n_steps)
        stats = states.stats
        call["into"] = dict(
            theta=self.rows(states.position), v=self.rows(states.momentum),
            tau=self.rows(stats.tau), g=self.rows(stats.g),
            v_hat=self.rows(stats.v_hat))
        call["out"] = dict(
            theta=self.rows(out.position), v=self.rows(out.momentum),
            tau=self.rows(out.stats.tau), g=self.rows(out.stats.g),
            v_hat=self.rows(out.stats.v_hat),
            minv=self.rows(out.stats.minv))
        self.calls.append(call)

    def _sample_tap(self, args, kwargs, result):
        states, n_keep = args[1], int(args[3])
        keep_every = int(kwargs.get("keep_every", 1))
        n_steps = n_keep * keep_every
        call = self._note("sample", n_steps, n_keep, keep_every)
        new, positions, costs = result
        # the kept positions and costs within the check's horizon, the last
        # kept position and the returned state, whatever the horizon
        within = min(n_keep, int(self.traffic["check_steps"]) // keep_every)
        call.update(keep_every=keep_every, into=dict(
            theta=self.rows(states.position), v=self.rows(states.momentum),
            minv=self.rows(states.stats.minv)), out=dict(
            theta=self.rows(new.position), v=self.rows(new.momentum)))
        call["positions"] = [
            self.rows({name: leaf[:, j] for name, leaf in positions.items()})
            for j in range(within)]
        call["last"] = self.rows({name: leaf[:, -1]
                                  for name, leaf in positions.items()})
        call["costs"] = costs[:, :within].index_select(0, self.idx).float()
        self.calls.append(call)

    def tapped(self, module):
        """Span and tap the fused drivers as ``module`` calls them."""
        stack = contextlib.ExitStack()
        stack.enter_context(self.spans.around(
            module, "burnin_chain_fused", "burnin_chain_fused",
            after=self._burn_tap))
        stack.enter_context(self.spans.around(
            module, "sample_chain_fused", "sample_chain_fused",
            after=self._sample_tap))
        return stack

    #  Checks ------------------------------------------------------------

    def follow_calls(self, key_seed, calls, control):
        """The gaps of the tapped calls against the reference, each call
        followed from its own start for at most the traffic's
        ``check_steps`` steps (rounding grows along a trajectory until two
        float32 programs no longer agree: ``PERF.md``).

        ``state_gap``: over the followed chains, the
        :func:`perfbench.shared.high_gap` of a row's gap
        (:func:`perfbench.shared.row_gaps`), the worst over the arrays and
        calls: a burn-in call's theta, v, tau, g, v_hat and minv; a sampling
        call's kept positions within the horizon, and its theta and v where
        the whole call is.  ``cost_gap``: the same of each kept cost's
        relative gap.  A high quantile and not the widest gap, for a few
        chains of every ensemble amplify rounding far more than the rest
        (``PERF.md``); ``state_median`` and ``cost_median`` the same with
        the median (:func:`perfbench.shared.summarise`).  ``init_gap``
        (exact) where a call starts at step 0.
        Under ``control`` the reference at TF32 stands in for the
        program."""
        horizon = int(self.traffic["check_steps"])
        keys = torch.Generator().manual_seed(int(key_seed))
        seeds = [ref_stream.draw_seed(keys)
                 for _ in range(max(c["draw"] for c in calls) + 1)]
        numbers = {}
        gaps = {"state_gap": [], "cost_gap": []}
        for call in calls:
            burn_in = call["kind"] == "burn"
            n_steps = call["n_steps"] if burn_in else min(call["n_steps"],
                                                          horizon)
            keep = None if burn_in else call["keep_every"]
            args = (self.idx, seeds[call["draw"]], call["step0"], n_steps,
                    self.x_win, self.y_win, self.rule(burn_in), self.shape)
            ref, _, kept = ref_sghmc.follow(call["into"], *args,
                                            keep_every=keep)
            if control:
                out, _, kept_out = ref_sghmc.follow(
                    call["into"], *args, precision="tf32", keep_every=keep)
                positions = [theta for theta, _ in kept_out]
                costs = [cost[:, 0] for _, cost in kept_out]
            else:
                out = call["out"]
                positions = call.get("positions", [])[:len(kept)]
                costs = [call["costs"][:, j] for j in range(len(kept))] \
                    if kept else []
            if call["step0"] == 0 and burn_in:
                numbers["init_gap"] = self.init_gap(key_seed, call["into"])
            arrays = ["theta", "v", "tau", "g", "v_hat", "minv"] if burn_in \
                else ["theta", "v"] if n_steps == call["n_steps"] else []
            gaps["state_gap"] += [shared.row_gaps(out[k], ref[k])
                                  for k in arrays]
            gaps["state_gap"] += [shared.row_gaps(p, r) for p, (r, _) in
                                  zip(positions, kept)]
            gaps["cost_gap"] += [shared.relative_gaps(cost, ref_cost[:, 0])
                                 for cost, (_, ref_cost) in zip(costs, kept)]
        numbers.update(shared.summarise(gaps))
        return numbers

    @staticmethod
    def link_gap(calls):
        """The largest difference (exact: 0) between what one call handed
        on and what the next was handed: each call's theta and v against
        the call before's, a burn-in call's tau, g and v_hat too; a sampling
        call's minv against the one burn-in ended with; and each sampling
        call's returned theta against its last kept position."""
        diffs = [0.0]

        def differ(a, b):
            diffs.append(float((a - b).abs().max()))

        minv = None
        for before, call in zip([None] + calls[:-1], calls):
            if before is not None:
                for k in ("theta", "v", "tau", "g", "v_hat"):
                    if k in call["into"] and k in before["out"]:
                        differ(call["into"][k], before["out"][k])
            if call["kind"] == "burn":
                minv = call["out"]["minv"]
                continue
            if minv is not None:
                differ(call["into"]["minv"], minv)
            differ(call["out"]["theta"], call["last"])
        return max(diffs)

    def init_gap(self, seed, into):
        """The largest difference of the first call's state from the
        initial state: He-normal weights from ``seed``, momentum 0, the
        burn-in statistics 1 (exact: 0)."""
        theta = ref_init.initial_weights(seed, self.n_chains, *self.shape,
                                         self.device).index_select(0, self.idx)
        want = dict(theta=theta, v=torch.zeros_like(theta),
                    tau=torch.ones_like(theta), g=torch.ones_like(theta),
                    v_hat=torch.ones_like(theta))
        return max(float((into[k] - want[k]).abs().max()) for k in want)

    def pack(self, samples):
        """A member dict as flat ``(n_members, P)`` float32."""
        n = next(iter(samples.values())).shape[0]
        return torch.cat([samples[name].reshape(n, -1).float()
                          for name in self.names], dim=1)

    def ensemble(self, samples, x_host, precision):
        """The reference's predictive mean and variance (float64, in the
        data's units) of the members ``samples`` ``(n, P)`` at ``x_host``."""
        x_mean, x_std, y_mean, y_std = self.norm
        xq = torch.as_tensor((np.asarray(x_host, dtype=np.float64) - x_mean)
                             / x_std, dtype=torch.float32, device=self.device)
        outs = []
        for lo in range(0, samples.shape[0], 1024):
            mean, _ = ref_bnn.forward(samples[lo:lo + 1024], xq, self.shape,
                                      precision)
            outs.append(mean.double())
        f = torch.cat(outs, dim=0)
        mean = f.mean(dim=0)
        var = ((f - mean) ** 2).mean(dim=0)
        return (mean * y_std + y_mean).cpu().numpy(), \
            (var * y_std ** 2).cpu().numpy()

    def predict_gap(self, samples, x_host, mean, var, control):
        """The wider of the predictive mean's and variance's gaps
        (:func:`perfbench.shared.scalar_gap`) against the reference."""
        ref_mean, ref_var = self.ensemble(samples, x_host, "float32")
        if control:
            mean, var = self.ensemble(samples, x_host, "tf32")
        return max(shared.scalar_gap(mean, ref_mean),
                   shared.scalar_gap(var, ref_var))
