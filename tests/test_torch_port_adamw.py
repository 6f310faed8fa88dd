"""The port's fused_adamw_project on the CPU: its plain twin against the JAX
Pallas kernel in interpret mode and against optax AdamW plus the clamp
(atol 1e-6), and the wrapper's checks. The CUDA kernel itself is tested on
the card by test_torch_port_cuda.py."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl_attack_on_imagenet_tpu.ops.pallas_kernels import (
    fused_adamw_project as jax_fused_adamw_project,
)
from dl_attack_on_imagenet_tpu_torch.ops import kernels, native
from dl_attack_on_imagenet_tpu_torch.ops.kernels import (
    bias_corrections,
    fused_adamw_project,
    fused_adamw_project_reference,
)

from _torch_port import t

INF = float("inf")


def _arrays(shape, seed, n_grads=1, moments=0.0):
    rs = np.random.RandomState(seed)
    p = (rs.normal(0.0, 1.0, shape) * 0.5).astype(np.float32)
    grads = [rs.normal(0.0, 1.0, shape).astype(np.float32) for _ in range(n_grads)]
    mu = np.full(shape, moments, np.float32)
    nu = np.full(shape, 2 * moments, np.float32)
    return p, grads, mu, nu


@pytest.mark.parametrize("shape", [(300,), (257,), (4, 8, 8, 3)])
@pytest.mark.parametrize("clip_val", [1.0, INF])
@pytest.mark.parametrize("n_steps", [1, 2])
def test_twin_matches_optax_adamw_plus_clamp(shape, clip_val, n_steps):
    p, grads, mu, nu = _arrays(shape, seed=n_steps, n_grads=n_steps)
    opt = optax.adamw(0.02, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    p_ref = jnp.asarray(p)
    state = opt.init(p_ref)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, p_ref)
        p_ref = jnp.clip(optax.apply_updates(p_ref, upd), -clip_val, clip_val)

    pt, mut, nut = t(p), t(mu), t(nu)
    for i, g in enumerate(grads):
        out = fused_adamw_project(pt, t(g), mut, nut, step=i + 1, lr=0.02, clip_val=clip_val)
        assert out[0] is pt and out[1] is mut and out[2] is nut  # in place
    np.testing.assert_allclose(pt.numpy(), np.asarray(p_ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(mut.numpy(), np.asarray(state[0].mu), atol=1e-6, rtol=0)
    np.testing.assert_allclose(nut.numpy(), np.asarray(state[0].nu), atol=1e-6, rtol=0)
    if clip_val == 1.0:
        assert float(pt.abs().max()) <= 1.0


@pytest.mark.parametrize("shape", [(257,), (4, 8, 8, 3)])
@pytest.mark.parametrize("clip_val", [1.0, INF])
@pytest.mark.parametrize("step", [1, 2, 3])
def test_twin_matches_pallas_interpret(shape, clip_val, step):
    p, (g,), mu, nu = _arrays(shape, seed=step, moments=0.1)
    want = jax_fused_adamw_project(jnp.asarray(p), jnp.asarray(g), jnp.asarray(mu),
                                   jnp.asarray(nu), step, 0.01, clip_val=clip_val,
                                   interpret=True)
    got = fused_adamw_project_reference(t(p), t(g), t(mu), t(nu), step, 0.01,
                                        clip_val=clip_val)
    for a, b in zip(got, want):
        assert a.shape == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_bias_corrections_are_fp32():
    bc1, bc2 = bias_corrections(3)
    assert bc1 == float(np.float32(1.0) - np.float32(0.9) ** np.float32(3))
    assert bc2 == float(np.float32(1.0) - np.float32(0.999) ** np.float32(3))
    assert bias_corrections(1) == (float(np.float32(1) - np.float32(0.9)),
                                   float(np.float32(1) - np.float32(0.999)))


def test_cpu_tensors_never_build_the_kernel(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("a CPU call tried to build or load the kernel")

    monkeypatch.setattr(native, "build", refuse)
    monkeypatch.setattr(native, "load", refuse)
    p, (g,), mu, nu = _arrays((5, 7), seed=0, moments=0.1)
    want = fused_adamw_project_reference(t(p), t(g), t(mu), t(nu), 4, 0.01)
    before = fused_adamw_project.launches
    got = fused_adamw_project(t(p), t(g), t(mu), t(nu), 4, 0.01)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_adamw_project.launches == before  # the plain twin is no launch


def test_non_cpu_tensors_never_reach_the_plain_twin(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("the plain twin ran on a non-CPU tensor")

    monkeypatch.setattr(kernels, "fused_adamw_project_reference", refuse)
    meta = torch.empty(6, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_adamw_project(meta, meta, meta, meta, 1, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adamw_project(torch.zeros(6, 5), meta, meta, meta, 1, 0.01)


def test_argument_checks():
    p, (g,), mu, nu = (np.asarray(a) for a in _arrays((8,), seed=0))
    with pytest.raises(ValueError, match="one shape"):
        fused_adamw_project(t(p), t(g)[:7], t(mu), t(nu), 1, 0.01)
    with pytest.raises(ValueError, match="counts from 1"):
        fused_adamw_project(t(p), t(g), t(mu), t(nu), 0, 0.01)


def test_the_kernel_is_built_with_the_others():
    assert "fused_adamw_project" in native.SOURCES
    path = native.library_path("fused_adamw_project")
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libfused_adamw_project-") and path.suffix == ".so"
