"""Attacks on a frozen victim: ADIL, the regularized ADILR, and the universal baselines (UAP-PGD,
Fast-UAP, DeepFool, DeepFoolCosinus and Moosavi's universal perturbation)."""

from .adil import ADIL
from .adil_core import AdilConfig
from .adil_regularized import ADILR, RegularizedConfig
from .base import Attack
from .deepfool import DeepFool, deepfool_batch
from .fast_uap import DeepFoolCosinus, FastUAP
from .uap_pgd import UAPPGD
from .universal_pert import universal_perturbation

__all__ = ["ADIL", "ADILR", "AdilConfig", "Attack", "DeepFool", "DeepFoolCosinus", "FastUAP",
           "RegularizedConfig", "UAPPGD", "deepfool_batch", "universal_perturbation"]
