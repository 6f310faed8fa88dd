"""Attack math on torch tensors: projections and proximal operators,
dictionary contractions, losses, Laplace fits and draws, and the
hand-written CUDA kernels with their plain twins."""

from .dictionary import codes_from_pinv, dict_apply, dict_flatten, dict_gram, dict_pinv
from .kernels import (
    fused_adamw_project,
    fused_adamw_project_reference,
    fused_perturb,
    fused_perturb_reference,
)
from .laplace import (
    laplace_fit,
    laplace_fit_conditioned,
    laplace_fit_conditioned_direct,
    laplace_fit_per_atom,
    laplace_sample,
)
from .losses import (
    attack_loss,
    cross_entropy_mean,
    cross_entropy_sum,
    cw_margin_loss,
    dlr_loss,
    dlr_loss_targeted,
)
from .projections import (
    clamp_image,
    l1_ball_project,
    l1_ball_project_bisect,
    l2_ball_project,
    l2_sphere_project,
    linf_clamp,
    project_atoms,
    project_codes,
    project_dictionary,
    soft_threshold,
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
    "dlr_loss",
    "dlr_loss_targeted",
    "fused_adamw_project",
    "fused_adamw_project_reference",
    "fused_perturb",
    "fused_perturb_reference",
    "l1_ball_project",
    "l1_ball_project_bisect",
    "l2_ball_project",
    "l2_sphere_project",
    "laplace_fit",
    "laplace_fit_conditioned",
    "laplace_fit_conditioned_direct",
    "laplace_fit_per_atom",
    "laplace_sample",
    "linf_clamp",
    "project_atoms",
    "project_codes",
    "project_dictionary",
    "soft_threshold",
]
