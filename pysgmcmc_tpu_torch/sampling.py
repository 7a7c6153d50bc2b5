"""Sampler enumeration and reflection factory (PyTorch port of
:mod:`pysgmcmc_tpu.sampling`).

``Sampler`` lists every method the JAX package supports, with the same
predicates and error texts; all six are ported.

Examples
--------
>>> import torch
>>> sampler = Sampler.get_sampler(Sampler.SGHMC, cost_fn=lambda p: p["x"].sum())
>>> type(sampler).__name__
'SGHMCSampler'
"""

from enum import Enum
from inspect import _empty, signature


class Sampler(Enum):
    """Enumeration of all supported sampling methods."""

    SGHMC = "SGHMC"
    RelativisticSGHMC = "RelativisticSGHMC"
    SGLD = "SGLD"
    SVGD = "SVGD"
    PSGLD = "PSGLD"
    SGNHT = "SGNHT"

    @staticmethod
    def is_burn_in_mcmc(sampling_method):
        """True iff the method uses the scale-adapted burn-in machinery."""
        return sampling_method in (Sampler.SGHMC, Sampler.SGLD)

    @staticmethod
    def is_supported(sampling_method):
        """True iff ``sampling_method`` can drive model training."""
        return sampling_method in (
            Sampler.SGHMC,
            Sampler.SGLD,
            Sampler.RelativisticSGHMC,
            Sampler.SVGD,
            Sampler.PSGLD,
            Sampler.SGNHT,
        )

    @classmethod
    def get_sampler(cls, sampling_method, **sampler_args):
        """Construct a sampler for ``sampling_method`` with ``sampler_args``;
        unknown keyword arguments raise a ``ValueError`` listing the valid
        ones."""
        if sampling_method == cls.SGHMC:
            from pysgmcmc_tpu_torch.samplers.sghmc import (
                SGHMCSampler as sampler_cls,
            )
        elif sampling_method == cls.SGLD:
            from pysgmcmc_tpu_torch.samplers.sgld import (
                SGLDSampler as sampler_cls,
            )
        elif sampling_method == cls.PSGLD:
            from pysgmcmc_tpu_torch.samplers.psgld import (
                PSGLDSampler as sampler_cls,
            )
        elif sampling_method == cls.SGNHT:
            from pysgmcmc_tpu_torch.samplers.sgnht import (
                SGNHTSampler as sampler_cls,
            )
        elif sampling_method == cls.RelativisticSGHMC:
            from pysgmcmc_tpu_torch.samplers.relativistic_sghmc import (
                RelativisticSGHMCSampler as sampler_cls,
            )
        elif sampling_method == cls.SVGD:
            from pysgmcmc_tpu_torch.samplers.svgd import (
                SVGDSampler as sampler_cls,
            )
        else:
            raise ValueError(
                "sampling.Sampler.get_sampler: unknown sampling method "
                "{method!r}. Supported methods are enumerated in the "
                "`Sampler` enum type.".format(method=sampling_method)
            )

        all_parameters = signature(sampler_cls.__init__).parameters

        for parameter_name in sampler_args:
            if parameter_name not in all_parameters:
                raise ValueError(
                    "sampling.Sampler.get_sampler: '{sampler_name}' does not "
                    "take any parameter with name '{parameter}' which was "
                    "specified as argument to this sampler. Please ensure "
                    "that you only specify sampler arguments that fit the "
                    "corresponding sampling method.\n"
                    "For your choice of sampling method ('{method}'), "
                    "supported parameters are:\n{valid}".format(
                        sampler_name=sampler_cls.__name__,
                        method=sampling_method,
                        parameter=parameter_name,
                        valid="\n".join(
                            "-{}".format(name)
                            for name in all_parameters
                            if name != "self"
                        ),
                    )
                )

        for parameter_name, parameter in all_parameters.items():
            if parameter_name == "self":
                continue
            if parameter_name not in sampler_args and parameter.default is _empty:
                raise ValueError(
                    "sampling.Sampler.get_sampler: {param} was not provided "
                    "as a sampler argument and has no default value in "
                    "{sampler}.__init__. Please pass an explicit value for "
                    "this parameter.".format(
                        param=parameter_name, sampler=sampler_cls.__name__
                    )
                )

        return sampler_cls(**sampler_args)
