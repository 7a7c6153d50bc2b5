"""Mode ``lm_sample``: SGHMC over a language model's weights on the lanes
drivers, one chain (``BayesianLanguageModel``).

Set-up makes the corpus on the card from the seed (``n_sequences``
sequences of ``sequence_length + 1`` token ids, i.i.d. Zipf(``zipf_s``) over
the vocabulary slice, the ids of the ranks in an order drawn from the seed),
draws the network (``moe_transformer``, the held experts of the
configuration) from the seed, sets each expert layer's correction bias so
that the router's top-k choices over the corpus' first ``balance_sequences``
sequences, under the reference's forward pass, fall on every expert equally
(:func:`balance`), burns the chain in for ``burn_in_steps`` steps (B9, the
first at ``first_stepsize``, every later step at ``stepsize``) and makes one
warm-up call.  The window calls ``sample(n_samples, keep_every)`` again and
again, each call dropping its positions; ``sample_rate`` is the chain-steps
of the window's calls over its elapsed time, ending in a synchronize.

The check taps one step of the window, drawn from the seed among the steps
of its first ``check_calls`` calls: the position handed to the step and the
gradient passed to B7 (both whole, copied on the device into buffers
allocated in set-up), the step's cost, each expert layer's chosen experts,
and, at ``check_elements`` columns of every leaf drawn from the seed, the
momentum, ``minv``, gradient and position handed to B7 and B7's outputs.  It also
keeps those columns of the state that every driver call was handed and
returned.  Against the plain reference (``perfbench/reference/moe_lm.py``,
float32 with TF32 off, on the program's expert choices):

- ``grad_gap``: the worst leaf's ``|g_prog - g_ref| / |g_ref|``;
- ``cost_gap``: the step's cost, relative;
- ``route_gap``: the largest amount by which an expert the program chose
  falls short of the reference's k-th largest ``score + bias``;
- ``rule_gap``: B7's outputs at the tapped columns against the reference's
  rule on the program's own inputs and gradient and the reference's Philox
  normals, the worst leaf's largest gap over its largest value;
- ``link_gap`` (exact): each call's handed state against the call before's
  returned one, and every sampling call's ``minv`` against burn-in's.

Under ``control`` the reference with every product's operands rounded to
bfloat16 stands in for the program's gradient, cost and choices, and the
rule on its inputs rounded to bfloat16 for B7's outputs.
"""

import contextlib
import math
import time

import torch

from perfbench import shared
from perfbench.reference import moe_lm as ref
from perfbench.reference import stream as ref_stream
from pysgmcmc_tpu_torch.models import bayesian_language_model as blm
from pysgmcmc_tpu_torch.models import moe_transformer as mt
from pysgmcmc_tpu_torch.parallel import packed
from pysgmcmc_tpu_torch.stepsize_schedules import WarmupStepsizeSchedule
from pysgmcmc_tpu_torch.utils import tracing


def make_corpus(seed, n_sequences, length, vocab, s, device):
    """``(n_sequences, length)`` int32 token ids, i.i.d. Zipf(``s``) over
    ``vocab`` ids whose ranks are in an order drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(
        shared.derived_seed(seed, 1))
    order = torch.randperm(vocab, generator=gen, device=device)
    weight = torch.arange(1, vocab + 1, dtype=torch.float64,
                          device=device) ** -s
    cdf = torch.cumsum(weight / weight.sum(), dim=0)
    u = torch.rand(n_sequences * length, generator=gen, dtype=torch.float64,
                   device=device)
    ranks = torch.clamp(torch.searchsorted(cdf, u), max=vocab - 1)
    return order[ranks].to(torch.int32).reshape(n_sequences, length)


def balanced_bias(scores, top_k, rounds=40):
    """The correction bias ``(n_experts,)`` under which the top ``top_k`` of
    ``scores + bias`` (``(tokens, n_experts)``) give every expert an equal
    share: each round moves every expert's bias halfway to the value that
    would give it exactly its share against the others' current biases."""
    n, e = scores.shape
    share = max(1, round(n * top_k / e))
    bias = torch.zeros(e, dtype=scores.dtype, device=scores.device)
    for _ in range(rounds):
        top = torch.topk(scores + bias, top_k + 1, dim=-1).values
        chosen = scores + bias >= top[:, top_k - 1:top_k]
        # what each expert's score must beat on each token
        bar = torch.where(chosen, top[:, top_k:], top[:, top_k - 1:top_k])
        need = torch.topk((scores - bar).t(), share, dim=-1).values[:, -1]
        bias = 0.5 * bias + 0.5 * (-need)
    return bias


def balance(params, tokens, cfg, held, bias):
    """Set ``bias`` (``(expert layers, n_experts)``) in place, layer after
    layer, to :func:`balanced_bias` of each expert layer's router scores
    under the reference's forward pass over the sequences ``tokens`` (the
    layers before it balanced already)."""
    for layer in range(bias.shape[0]):
        scores = []
        for sequence in tokens:
            found = []
            ref.forward(params, sequence, cfg, held, bias, scores=found)
            scores.append(found[layer])
        bias[layer] = balanced_bias(torch.cat(scores),
                                    cfg["num_experts_per_tok"])


class Cell(shared.Cell):
    """The ``lm_sample`` mode of one run (see the module docstring)."""

    def __init__(self, *args):
        super().__init__(*args)
        cfg = self.config
        self.net_config = dict(cfg, n_routed_experts=cfg["router_experts"])
        self.held = list(cfg["held_experts"])
        self.shapes = ref.param_shapes(self.net_config, len(self.held))
        self.n_params = sum(math.prod(s) for s in self.shapes.values())
        self.columns = self.tapped_columns()
        self.calls = []
        self.tap = None
        self.routes = None

    #  Set-up and window ----------------------------------------------------

    def setup(self):
        cfg, mix = self.config, self.traffic
        self.corpus = make_corpus(self.seed, cfg["n_sequences"],
                                  cfg["sequence_length"] + 1,
                                  cfg["vocab_size"], cfg["zipf_s"],
                                  self.device)
        n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
        self.bias = torch.zeros((n_moe, cfg["router_experts"]),
                                dtype=torch.float32, device=self.device)
        net = mt.moe_transformer(self.net_config, held_experts=self.held,
                                 correction_bias=self.bias,
                                 device=self.device)
        self.model_seed = shared.derived_seed(self.seed, 2)
        self.model = blm.BayesianLanguageModel(
            net, batch_size=cfg["batch_size"],
            stepsize_schedule=WarmupStepsizeSchedule(
                cfg["stepsize"], cfg["first_stepsize"]),
            mdecay=cfg["mdecay"],
            burn_in_steps=mix["burn_in_steps"], n_nets=mix["n_samples"],
            sample_steps=mix["keep_every"], seed=self.model_seed,
            device=self.device)
        states = self.model.start(self.corpus[:, :-1], self.corpus[:, 1:])
        with torch.no_grad():
            balance(ref.leaves(self._flat(states.position), self.shapes),
                    self.corpus[:mix["balance_sequences"], :-1],
                    self.net_config, self.held, self.bias)
        # where the tapped step's position and gradient are kept
        self.kept = [torch.empty((1, self.n_params), device=self.device)
                     for _ in range(2)]
        with self.tapping():
            states = self.model.burn_in(states, mix["burn_in_steps"])
            self.states = self.model.sample(states, mix["n_samples"])[0]
        self.synchronize()

    def window(self, seconds):
        mix = self.traffic
        steps_per_call = mix["n_samples"] * mix["keep_every"]
        self.tap_step = int(self.states.step) + int(shared.chosen(
            self.seed, mix["check_calls"] * steps_per_call, 1)[0])
        assignments = tracing.counts.get("moe.held_assignments", 0)
        calls = 0
        start = time.perf_counter()
        deadline = start + seconds
        with self.tapping():
            while True:
                with self.spans("sample"):
                    self.states = self.model.sample(
                        self.states, mix["n_samples"])[0]
                calls += 1
                if time.perf_counter() >= deadline:
                    break
        self.synchronize()
        elapsed = time.perf_counter() - start
        self.counts.update(
            calls=calls, steps=calls * steps_per_call,
            held_assignments=tracing.counts.get("moe.held_assignments", 0)
            - assignments)
        return {"sample_rate": self.counts["steps"] / elapsed}, calls

    def release(self):
        self.states = self.model = None

    #  Taps -----------------------------------------------------------------

    def tapped_columns(self):
        """The tapped columns of the row: ``check_elements`` of every leaf,
        drawn from the seed (int64, on the device)."""
        cols, off = [], 0
        for i, shape in enumerate(self.shapes.values()):
            size = math.prod(shape)
            gen = torch.Generator().manual_seed(
                shared.derived_seed(self.seed, 100 + i))
            pick = torch.randperm(size, generator=gen)[
                :self.traffic["check_elements"]]
            cols.append(off + torch.sort(pick).values)
            off += size
        return torch.cat(cols).to(self.device)

    def _flat(self, tree):
        """A state tree's row ``(P,)`` (the state's own buffer, uncopied)."""
        spec = packed.make_lanes_spec({k: v[0] for k, v in tree.items()})
        return packed.pack_lanes(spec, tree)[0]

    def _row(self, tree):
        """A state tree's tapped columns (float32)."""
        return self._flat(tree)[self.columns].float()

    def _call_tap(self, kind, driver):
        def tapped(sampler, states, *args, **kwargs):
            into = dict(theta=self._row(states.position),
                        v=self._row(states.momentum))
            if kind == "sample":
                into["minv"] = self._row(states.stats.minv)
            result = driver(sampler, states, *args, **kwargs)
            new = result[0] if kind == "sample" else result
            out = dict(theta=self._row(new.position),
                       v=self._row(new.momentum))
            if kind == "burn":
                out["minv"] = self._row(new.stats.minv)
            self.calls.append(dict(kind=kind, into=into, out=out))
            return result
        return tapped

    def _gradient_tap(self, gradient):
        def tapped(sampler, spec, theta, batch_fn, window_seed, step,
                   *args):
            if step != getattr(self, "tap_step", None) or self.tap:
                return gradient(sampler, spec, theta, batch_fn, window_seed,
                                step, *args)
            self.routes = []
            cost, grad = gradient(sampler, spec, theta, batch_fn,
                                  window_seed, step, *args)
            self.tap = dict(step=step, call=len(self.calls), cost=cost,
                            routes=self.routes,
                            theta=self.kept[0].copy_(theta),
                            grad=self.kept[1].copy_(grad))
            self.routes = None
            return cost, grad
        return tapped

    def _update_tap(self, update):
        def tapped(theta, v, grad, minv, mask, eps, seed, *args, **kwargs):
            out = update(theta, v, grad, minv, mask, eps, seed, *args,
                         **kwargs)
            tap = self.tap
            if tap is not None and kwargs.get("step") == tap["step"] \
                    and "rule" not in tap:
                cols = self.columns
                tap["rule"] = dict(
                    eps=float(eps), seed=int(seed),
                    theta=theta[0, cols], v=v[0, cols].float(),
                    minv=minv[0, cols].float(), grad=grad[0, cols].float(),
                    theta_out=out[0][0, cols], v_out=out[1][0, cols].float())
            return out
        return tapped

    def _route_tap(self, route):
        def tapped(*args):
            out = route(*args)
            if self.routes is not None:
                self.routes.append(out[0].clone())
            return out
        return tapped

    @contextlib.contextmanager
    def tapping(self):
        """Taps on the drivers' calls (as the model makes them), the lanes
        gradient, B7 and the router, restored on exit."""
        taps = [(blm, "burnin_chain_lanes", self._call_tap("burn", blm
                                                             .burnin_chain_lanes)),
                (blm, "sample_chain_lanes", self._call_tap(
                    "sample", blm.sample_chain_lanes)),
                (packed, "_lanes_gradient", self._gradient_tap(
                    packed._lanes_gradient)),
                (packed, "slim_sghmc_update", self._update_tap(
                    packed.slim_sghmc_update)),
                (mt, "route", self._route_tap(mt.route))]
        originals = [(module, name, getattr(module, name))
                     for module, name, _ in taps]
        for module, name, tap in taps:
            setattr(module, name, tap)
        try:
            yield
        finally:
            for module, name, original in originals:
                setattr(module, name, original)

    #  Check ----------------------------------------------------------------

    def link_gap(self):
        """The largest difference (exact: 0) between what one driver call
        handed on and what the next was handed, at the tapped columns, and
        between every sampling call's minv and burn-in's last."""
        diffs, minv = [0.0], None
        for before, call in zip([None] + self.calls[:-1], self.calls):
            if before is not None:
                for k in ("theta", "v"):
                    diffs.append(float((call["into"][k]
                                        - before["out"][k]).abs().max()))
            if call["kind"] == "burn":
                minv = call["out"]["minv"]
            elif minv is not None:
                diffs.append(float((call["into"]["minv"] - minv).abs().max()))
        return max(diffs)

    def _stream_seed(self, call):
        """The Philox key the model's driver call ``call`` drew."""
        keys = torch.Generator().manual_seed(self.model_seed)
        for _ in range(call):
            ref_stream.draw_seed(keys)
        return ref_stream.draw_seed(keys)

    def _window_tokens(self, seed, step):
        cfg = self.config
        n_windows = cfg["n_sequences"] - cfg["batch_size"] + 1
        w = int(ref_stream.windows(
            seed, torch.tensor([step]), torch.tensor([0]), n_windows)[0, 0])
        rows = self.corpus[w:w + cfg["batch_size"]].to(self.device)
        return rows[:, :-1], rows[:, 1:]

    def rule_gap(self, tap, seed, control=False):
        """B7's tapped outputs against the reference's rule on B7's own
        inputs: per leaf, the largest gap over the largest value, the
        worst leaf.  Under ``control`` the rule on the inputs rounded to
        bfloat16 stands in for B7's outputs."""
        r = tap["rule"]
        cfg = self.config
        cols = self.columns
        eta = ref.normals(seed, tap["step"], cols)

        def rule(precision):
            return ref.sghmc_step(
                *[ref.rounded(r[k], precision)
                  for k in ("theta", "v", "minv", "grad")], eta,
                cfg["stepsize"], float(self.n_tokens), cfg["mdecay"],
                1.0 / self.n_tokens)

        theta, v = rule("float32")
        got = rule("bf16") if control else (r["theta_out"], r["v_out"])
        per_leaf = self.traffic["check_elements"]
        worst = 0.0
        for prog, want in zip(got, (theta, v)):
            for lo in range(0, cols.numel(), per_leaf):
                p, w = prog[lo:lo + per_leaf], want[lo:lo + per_leaf]
                worst = max(worst, shared.scalar_gap(p, w))
        return worst

    @property
    def n_tokens(self):
        return self.config["n_sequences"] * self.config["sequence_length"]

    def check(self, control=False):
        tap = self.tap
        numbers = {"link_gap": self.link_gap()}
        if tap is None or "rule" not in tap:
            return numbers  # the tapped step never ran: not correct
        # the Philox key the tapped step's driver call drew (set-up's
        # calls counted)
        seed = self._stream_seed(tap["call"])
        numbers["rule_gap"] = self.rule_gap(tap, seed, control)
        cfg = self.net_config
        row = tap["theta"][0]
        tokens, targets = self._window_tokens(seed, tap["step"])
        args = (self.shapes, tokens, targets, self.n_tokens, cfg, self.held,
                self.bias)
        if control:
            cost, grads, routes, _ = ref.cost_and_grad(row, *args,
                                                       precision="bf16")
            grad = torch.cat([grads[k].reshape(-1) for k in self.shapes])
        else:
            cost, routes = float(tap["cost"][0]), tap["routes"]
            grad = tap["grad"][0]
        want_cost, want, _, gap = ref.cost_and_grad(row, *args,
                                                    routes=routes)
        numbers["route_gap"] = gap
        numbers["cost_gap"] = abs(cost - want_cost) / abs(want_cost)
        worst, off = 0.0, 0
        for name, leaf in want.items():
            g = grad[off:off + leaf.numel()]
            off += leaf.numel()
            worst = max(worst, float(torch.linalg.vector_norm(
                g - leaf.reshape(-1)) / torch.linalg.vector_norm(leaf)))
        numbers["grad_gap"] = worst
        return numbers
