"""Attack math on torch tensors: projections, dictionary contractions,
losses, and the hand-written CUDA kernels with their plain twins."""

from .dictionary import codes_from_pinv, dict_apply, dict_flatten, dict_gram, dict_pinv
from .kernels import fused_perturb, fused_perturb_reference
from .losses import attack_loss, cross_entropy_mean, cross_entropy_sum, cw_margin_loss
from .projections import (
    clamp_image,
    l1_ball_project,
    l2_ball_project,
    linf_clamp,
    project_codes,
    project_dictionary,
)

__all__ = [
    "attack_loss",
    "clamp_image",
    "codes_from_pinv",
    "cross_entropy_mean",
    "cross_entropy_sum",
    "cw_margin_loss",
    "dict_apply",
    "dict_flatten",
    "dict_gram",
    "dict_pinv",
    "fused_perturb",
    "fused_perturb_reference",
    "l1_ball_project",
    "l2_ball_project",
    "linf_clamp",
    "project_codes",
    "project_dictionary",
]
