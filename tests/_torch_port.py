"""Shared helpers for the parity tests of the PyTorch port.

Both packages see the same inputs: numpy arrays made from a fixed seed, and
the same victim weights, carried from the JAX victim into the port with
``state_dict_from_flax``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.models.convert import jax_tree_to_numpy
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.models.convert import state_dict_from_flax


def _randomize_bn(params, stats, rs: np.random.RandomState) -> None:
    """Give every BatchNorm random statistics and affine terms, in place."""
    for key, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if key.startswith("BatchNorm"):
            shape = sub["scale"].shape
            sub["scale"] = rs.uniform(0.5, 1.5, shape).astype(np.float32)
            sub["bias"] = rs.normal(0.0, 0.1, shape).astype(np.float32)
            stats[key]["mean"] = rs.normal(0.0, 0.1, shape).astype(np.float32)
            stats[key]["var"] = rs.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            _randomize_bn(sub, stats.get(key, {}), rs)


def victim_pair(name: str, input_size=None, seed: int = 0, key: int = 0):
    """(JAX victim, its numpy variables, port victim on the CPU) with the
    same weights, drawn by the JAX package from ``PRNGKey(key)``; BatchNorm
    statistics are randomized in numpy."""
    jv = jax_create_model(name, input_size=input_size, rng=jax.random.PRNGKey(key))
    variables = jax_tree_to_numpy(jv.variables)
    if "batch_stats" in variables:
        _randomize_bn(variables["params"], variables["batch_stats"],
                      np.random.RandomState(seed))
    pv = create_model(name, input_size=input_size,
                      state_dict=state_dict_from_flax(variables), device="cpu")
    return jv, variables, pv


def t(a) -> torch.Tensor:
    """A float32 torch copy of a numpy array."""
    return torch.tensor(np.asarray(a), dtype=torch.float32)
