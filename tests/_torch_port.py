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

# The suite runs in several worker processes on one host. Torch sizes its
# CPU thread pool for the whole host in each of them, and the pools then
# spin against each other: beside five other workers a 6.5 s CLI test took
# 200 s. The port's tests run on one thread a process.
torch.set_num_threads(1)


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


def max_err(got, want) -> float:
    """The largest absolute difference of two arrays or tensors, in float64."""
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def assert_signed_close(got, want, meets=1e-5):
    """The bound of a signed-step l∞ trajectory (``tests/test_torch_parity_uap.py``'s):
    atol 2e-3 with under 1% of the elements beyond 5e-5, since a gradient
    element at the noise floor can flip its sign; and ``meets``, what the
    port meets on the test's inputs."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert float(diff.max()) <= 2e-3 and float((diff > 5e-5).mean()) < 0.01
    assert float(diff.max()) <= meets


def call_key(seed: int = 0, call: int = 1):
    """The key a JAX attack class folds from ``PRNGKey(seed)`` on its
    ``call``-th call."""
    return jax.random.fold_in(jax.random.PRNGKey(seed), call)


def strict_jit(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's excess precision
    off, so that every bf16 result is rounded where the code rounds it (by
    default XLA keeps fp32 between bf16 casts, several percent from the
    code's own rounding in a bf16 victim's gradient)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
