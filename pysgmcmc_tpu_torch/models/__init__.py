from pysgmcmc_tpu_torch.models.architectures import (
    default_network,
    dense_network,
)
from pysgmcmc_tpu_torch.models.base_model import (
    BaseModel,
    zero_mean_unit_var_normalization,
    zero_mean_unit_var_unnormalization,
    zero_one_normalization,
    zero_one_unnormalization,
)
from pysgmcmc_tpu_torch.models.bayesian_neural_network import (
    BayesianNeuralNetwork,
    log_variance_prior_log_like,
    weight_prior_log_like,
)

__all__ = [
    "BaseModel",
    "BayesianNeuralNetwork",
    "default_network",
    "dense_network",
    "log_variance_prior_log_like",
    "weight_prior_log_like",
    "zero_mean_unit_var_normalization",
    "zero_mean_unit_var_unnormalization",
    "zero_one_normalization",
    "zero_one_unnormalization",
]
