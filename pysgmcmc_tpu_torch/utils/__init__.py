from pysgmcmc_tpu_torch.utils.numeric import median, safe_divide, safe_sqrt
from pysgmcmc_tpu_torch.utils.pytree import (
    normal_like_tree,
    tree_cast,
    tree_map,
    tree_size,
    tree_zeros_like,
)

__all__ = [
    "median",
    "normal_like_tree",
    "safe_divide",
    "safe_sqrt",
    "tree_cast",
    "tree_map",
    "tree_size",
    "tree_zeros_like",
]
