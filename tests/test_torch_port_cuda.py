"""The port's CUDA kernel on the card: fused_perturb against its plain twin
(atol 1e-5: the kernel and cuBLAS sum the K products in other orders), its
launch count, and the wrapper's refusals. Every test here needs a GPU and
skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_cuda.py
"""

import pytest
import torch

from dl_attack_on_imagenet_tpu_torch.ops import dict_apply, fused_perturb, fused_perturb_reference

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no GPU present: the CUDA kernel runs only on the card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _inputs(dev, n, k, m, v_scale=0.01):
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn((n, k), generator=g, device=dev) * v_scale
    d = torch.rand((k, m), generator=g, device=dev) * 2 - 1
    x = torch.rand((n, m), generator=g, device=dev)
    return v, d, x


@pytest.mark.parametrize("n,k,m,eps,v_scale", [
    (64, 100, 224 * 224 * 3, 8 / 255, 0.01),       # the serving shape
    (5, 7, 3 * 257, 0.05, 0.1),                     # ragged N and M
    (64, 100, 224 * 224 * 3, float("inf"), 0.01),   # supervised read-off
    (17, 100, 224 * 224 * 3, 8 / 255, 10.0),        # huge codes: the clamp decides
])
def test_cuda_kernel_matches_plain_twin(cuda, n, k, m, eps, v_scale):
    v, d, x = _inputs(cuda, n, k, m, v_scale)
    before = fused_perturb.launches
    got = fused_perturb(v, d, x, eps)
    torch.cuda.synchronize()
    assert fused_perturb.launches == before + 1
    assert float((got - fused_perturb_reference(v, d, x, eps)).abs().max()) <= 1e-5
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    assert float((got - x).abs().max()) <= eps + 1e-6


def test_cuda_kernel_takes_a_4d_dictionary(cuda):
    v, d, x = _inputs(cuda, 4, 8, 32 * 32 * 3)
    got = fused_perturb(v, d.reshape(8, 32, 32, 3), x.reshape(4, 32, 32, 3), 0.03)
    torch.cuda.synchronize()
    assert got.shape == (4, 32, 32, 3)
    assert float((got.reshape(4, -1) - fused_perturb_reference(v, d, x, 0.03)).abs().max()) <= 1e-5


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    v, d, x = _inputs(cuda, 4, 8, 96)
    before = fused_perturb.launches
    with pytest.raises(TypeError):
        fused_perturb(v.double(), d.double(), x.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_perturb(v, d, x.T.contiguous().T, 0.1)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_perturb(v.cpu(), d, x, 0.1)
    big = _inputs(cuda, 2, 4096, 8)
    with pytest.raises(ValueError, match="atoms"):
        fused_perturb(*big, 0.1)
    assert fused_perturb.launches == before


def test_contractions_refuse_tf32(cuda):
    v, d, x = _inputs(cuda, 2, 4, 12)
    torch.backends.cuda.matmul.allow_tf32 = True
    with pytest.raises(RuntimeError, match="true fp32"):
        dict_apply(v, d)
    with pytest.raises(RuntimeError, match="true fp32"):
        fused_perturb_reference(v, d, x, 0.1)
    # The kernel does its own fp32 FMAs: the matmul flag does not touch it.
    got = fused_perturb(v, d, x, 0.1)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert float((got - fused_perturb_reference(v, d, x, 0.1)).abs().max()) <= 1e-5
