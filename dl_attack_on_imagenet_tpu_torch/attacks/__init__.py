"""Attacks on a frozen victim: ADIL, the regularized ADILR, the universal
baselines (UAP-PGD, Fast-UAP, DeepFool, DeepFoolCosinus and Moosavi's
universal perturbation) and the torchattacks grid (the FGSM family,
PGD/BIM, CW, APGD/APGD-T, FAB, Square, OnePixel and AutoAttack).

``__all__`` is the JAX package's list, in its order.
"""

from .adil import ADIL
from .adil_core import AdilConfig
from .adil_regularized import ADILR, RegularizedConfig
from .apgd import APGD, APGDT
from .autoattack import AutoAttack
from .base import Attack
from .cw import CW
from .deepfool import DeepFool, deepfool_batch
from .fab import FAB
from .fast_uap import DeepFoolCosinus, FastUAP
from .fgsm_family import DIFGSM, EOTPGD, FFGSM, GN, MIFGSM, RFGSM, TPGD, VANILA
from .one_pixel import OnePixel
from .pgd import BIM, FGSM, PGD
from .square import Square
from .uap_pgd import UAPPGD
from .universal_pert import universal_perturbation

__all__ = [
    "Attack",
    "ADIL",
    "AdilConfig",
    "ADILR",
    "RegularizedConfig",
    "DeepFool",
    "deepfool_batch",
    "DeepFoolCosinus",
    "FastUAP",
    "UAPPGD",
    "universal_perturbation",
    "FGSM",
    "PGD",
    "BIM",
    "RFGSM",
    "FFGSM",
    "MIFGSM",
    "TPGD",
    "EOTPGD",
    "DIFGSM",
    "GN",
    "VANILA",
    "CW",
    "APGD",
    "APGDT",
    "Square",
    "FAB",
    "AutoAttack",
    "OnePixel",
]
