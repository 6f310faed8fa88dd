"""The port's fused_perturb on the CPU: its plain twin against the JAX Pallas
kernel in interpret mode (atol 1e-6) and the wrapper's checks. The CUDA
kernel itself is tested on the card by test_torch_port_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.ops.pallas_kernels import fused_perturb as jax_fused_perturb
from dl_attack_on_imagenet_tpu_torch.ops import kernels, native
from dl_attack_on_imagenet_tpu_torch.ops.kernels import fused_perturb, fused_perturb_reference

from _torch_port import t


def _inputs(n, k, h, w, v_scale, seed=0):
    rs = np.random.RandomState(seed)
    v = (rs.normal(0.0, 1.0, (n, k)) * v_scale).astype(np.float32)
    d = rs.uniform(-1.0, 1.0, (k, h, w, 3)).astype(np.float32)
    x = rs.uniform(0.0, 1.0, (n, h, w, 3)).astype(np.float32)
    return v, d, x


@pytest.mark.parametrize("case", [
    # (n, k, h, w, v_scale, eps, flat_d)
    (8, 16, 8, 8, 0.01, 8 / 255, False),   # 4-D D, M = 192
    (4, 8, 7, 9, 0.1, 0.1, True),          # flat D, M = 189: not a multiple of 128
    (4, 8, 8, 8, 10.0, 0.05, False),       # huge codes: the clamp decides
    (3, 5, 8, 8, 0.1, float("inf"), False),  # no clamp (supervised read-off)
])
def test_plain_twin_matches_pallas_interpret(case):
    n, k, h, w, v_scale, eps, flat_d = case
    v, d, x = _inputs(n, k, h, w, v_scale)
    if flat_d:
        d = d.reshape(k, -1)
    want = jax_fused_perturb(jnp.asarray(v), jnp.asarray(d), jnp.asarray(x), eps,
                             block_m=128, interpret=True)
    got = fused_perturb(t(v), t(d), t(x), eps)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    assert float((got - t(x).clamp(0, 1)).abs().max()) <= eps + 1e-6


def test_cpu_tensors_never_build_the_kernel(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("a CPU call tried to build or load the kernel")

    monkeypatch.setattr(native, "build", refuse)
    monkeypatch.setattr(native, "load", refuse)
    v, d, x = _inputs(2, 4, 4, 4, 0.1)
    before = fused_perturb.launches
    got = fused_perturb(t(v), t(d), t(x), 0.1)
    want = fused_perturb_reference(t(v), t(d).reshape(4, -1), t(x).reshape(2, -1), 0.1)
    assert torch.equal(got.reshape(2, -1), want)
    assert fused_perturb.launches == before  # the plain twin is no launch


def test_non_cpu_tensors_never_reach_the_plain_twin(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("the plain twin ran on a non-CPU tensor")

    monkeypatch.setattr(kernels, "fused_perturb_reference", refuse)
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_perturb(meta(2, 4), meta(4, 48), meta(2, 4, 4, 3), 0.1)


def test_shape_checks():
    v, d, x = (t(a) for a in _inputs(2, 4, 4, 4, 0.1))
    with pytest.raises(ValueError):
        fused_perturb(v[:, :3], d, x, 0.1)  # K mismatch
    with pytest.raises(ValueError):
        fused_perturb(v, d, x[:, :3], 0.1)  # M mismatch
    with pytest.raises(ValueError):
        fused_perturb(v[0], d, x, 0.1)  # v not 2-D


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.find_nvcc()


def test_library_path_follows_the_source():
    path = native.library_path("fused_perturb")
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libfused_perturb-") and path.suffix == ".so"
    assert native.library_path("fused_perturb") == path


def test_library_path_follows_a_changed_source(monkeypatch, tmp_path):
    # A changed source gets a library of its own, so it is rebuilt.
    path = native.library_path("fused_perturb")
    source = (native.CSRC_DIR / "fused_perturb.cu").read_text()
    (tmp_path / "fused_perturb.cu").write_text(source + "\n// changed\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    changed = native.library_path("fused_perturb")
    assert changed.parent == path.parent and changed != path
