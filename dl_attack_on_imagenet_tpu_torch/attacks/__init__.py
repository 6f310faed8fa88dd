"""Attacks on a frozen victim: ADIL serving."""

from .adil import ADIL
from .adil_core import AdilConfig
from .base import Attack

__all__ = ["ADIL", "AdilConfig", "Attack"]
