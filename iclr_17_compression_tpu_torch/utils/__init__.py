"""Device policy, latent analysis, SVD re-quantization and dataset tools
(the JAX package's ``utils`` exports; its XLA compilation cache has no
counterpart here)."""
from .analysis import conditional_entropy, uncertainty_coefficient
from .dataset_tools import (check_image_sizes, create_diff_folder, save_both_direction_recons,
                            warp_side_information)
from .device import apply_precision, resolve_device
from .svd import compose_requantized, decompose_top_i, low_rank_code, rank_rate_bits

__all__ = [
    "conditional_entropy",
    "uncertainty_coefficient",
    "low_rank_code",
    "decompose_top_i",
    "compose_requantized",
    "rank_rate_bits",
    "check_image_sizes",
    "create_diff_folder",
    "save_both_direction_recons",
    "warp_side_information",
    "apply_precision",
    "resolve_device",
]
