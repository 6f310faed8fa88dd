"""Swin's window attention on the qkv map on the CPU, where the module
takes the plain twin ``models.swin.window_attention_reference`` of the
card's ``ops.kernels.swin_window_attention``: each block of
``swin_tiny`` at 64² (shifted and plain blocks, and the last stage, whose
window covers the map) against the plain reference's attention
(``tests/_plain_swin.py``), output and input gradient; the twin's region
mask against the reference's slices at every block shape of ``swin_tiny``
and Swin-B; every registered Swin's blocks in the kernel's shapes; and the
wrapper's refusals, of CPU tensors too. The kernel itself runs only on the
card
(``tests/test_torch_port_cuda.py``).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_swin_window_attention.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _plain_swin
from dl_attack_on_imagenet_tpu_torch.models import MODEL_REGISTRY, create_model
from dl_attack_on_imagenet_tpu_torch.models.swin import (ShiftedWindowAttention,
                                                         window_attention_reference, window_mask)
from dl_attack_on_imagenet_tpu_torch.ops.kernels import (SWIN_WINDOW_SHAPES,
                                                         swin_window_attention)
from dl_attack_on_imagenet_tpu_torch.utils import profiling
from test_torch_port_swin import TINY, tiny_params

torch.set_num_threads(1)

# swin_tiny at 64²: (stage index in ``features``, block, map side, heads).
# Stage 1's and 2's second blocks are shifted; stage 3's 4x4 map is one
# window, so its second block is not.
TINY_BLOCKS = [(1, 0, 16, 2), (1, 1, 16, 2), (3, 0, 8, 4), (3, 1, 8, 4), (5, 0, 4, 8),
               (5, 1, 4, 8)]
# The port and the reference part by fp32 rounding only (the qkv Linear on
# the map or on the windows, the bias and mask added as one term or two):
# 1e-5, as for the whole model in test_torch_port_swin.py.
TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    params = tiny_params()
    return params, create_model("swin_tiny", device="cpu", state_dict=params)


def rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def rel_l2(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("stage,block,side,heads", TINY_BLOCKS)
def test_each_block_matches_the_plain_reference(tiny, stage, block, side, heads):
    params, victim = tiny
    attn = victim.net.features[stage][block].attn
    name = f"features.{stage}.{block}.attn"
    shift = TINY["window_size"] // 2 if block % 2 and TINY["window_size"] < side else 0
    assert (attn.shift if attn.window < side else 0) == shift
    g = torch.Generator().manual_seed(stage * 10 + block)
    x = torch.randn((2, side, side, attn.qkv.in_features), generator=g)
    grad_out = torch.randn((2, side, side, attn.qkv.in_features), generator=g)
    results = []
    for fn in (attn, lambda t: _plain_swin.attention(params, t, name, heads, shift,
                                                     TINY["window_size"])):
        xt = x.clone().requires_grad_(True)
        out = fn(xt)
        (grad,) = torch.autograd.grad(out, xt, grad_out)
        results.append((out.detach(), grad))
    (out, grad), (want, want_grad) = results
    assert rel_max(out, want) < TOL and rel_l2(grad, want_grad) < TOL


def test_the_cpu_takes_the_twin_with_its_shift_spans_and_launches_nothing(tiny):
    _, victim = tiny
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(5)).requires_grad_(True)
    before = (swin_window_attention.launches, swin_window_attention.backward_launches)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            torch.autograd.grad(victim(x).sum(), x)
        counts = {name: t.count for name, t in profiling.totals().items()}
    finally:
        profiling.reset()
    assert (swin_window_attention.launches, swin_window_attention.backward_launches) == before
    assert counts["victim/swin/shift"] == 2 * counts["victim/swin/attention"] == 12


@pytest.mark.parametrize("side,window,shift", [(16, 4, 2), (8, 4, 2), (4, 4, 0), (56, 7, 3),
                                               (28, 7, 3), (14, 7, 3), (7, 7, 0), (56, 7, 0)])
def test_the_region_mask_matches_the_plain_reference(side, window, shift):
    # Every block shape of swin_tiny at 64² and Swin-B at 224²: the twin's
    # mask from each token's region in the rolled map (as the kernel
    # computes it) against the reference's regions cut by slices.
    got = window_mask(side, side, window, shift, shift, "cpu")
    tokens = window * window
    if shift:
        want = _plain_swin.shift_mask(side, side, window, shift, "cpu").reshape(-1, tokens, tokens)
    else:
        want = torch.zeros(((side // window) ** 2, tokens, tokens))
    assert got.shape == want.shape and torch.equal(got, want)
    assert set(got.unique().tolist()) <= {0.0, -100.0}


def test_every_registered_swin_block_has_a_kernel():
    swins = [name for name in MODEL_REGISTRY if name.startswith("swin")]
    assert swins == ["swin_b", "swin_tiny"]
    for name in swins:
        with torch.device("meta"):
            net = MODEL_REGISTRY[name][0]()
        attns = [m for m in net.modules() if isinstance(m, ShiftedWindowAttention)]
        assert attns and all(
            (a.window, a.qkv.in_features // a.num_heads) in SWIN_WINDOW_SHAPES for a in attns)


def _inputs(side=8, window=4, heads=2, head_dim=8, requires_grad=False):
    qkv = torch.randn((1, side, side, 3 * heads * head_dim))
    table = torch.randn(((2 * window - 1) ** 2, heads)).requires_grad_(requires_grad)
    return qkv, table


@pytest.mark.parametrize("case,match", [
    (dict(window=5, head_dim=8, side=10), "no kernel for window 5 with head dim 8"),
    (dict(window=7, head_dim=16, side=14), "no kernel for window 7 with head dim 16"),
    (dict(window=4, head_dim=32, side=8), "no kernel for window 4 with head dim 32"),
    (dict(side=6), "do not tile a 6x6 map"),
    (dict(shift=4), "outside"),
    (dict(table_rows=48), "bias table must be"),
    (dict(qkv_dims=3), "qkv must be"),
])
def test_the_wrapper_refuses_shapes_outside_the_supported_set(case, match):
    window = case.get("window", 4)
    qkv, table = _inputs(case.get("side", 8), window, 2, case.get("head_dim", 8))
    if "table_rows" in case:
        table = table[:case["table_rows"]]
    if "qkv_dims" in case:
        qkv = qkv[0]
    shift = case.get("shift", 0)
    with pytest.raises(ValueError, match=match):
        swin_window_attention(qkv, table, window, shift, shift, 2)


def test_the_wrapper_refuses_a_table_that_needs_a_gradient_on_the_card():
    # The table's check comes before the device check, so CPU tensors show it.
    qkv, table = _inputs(requires_grad=True)
    with pytest.raises(ValueError, match="gives the bias table no gradient"):
        swin_window_attention(qkv, table, 4, 2, 2, 2)
    # Without autograd the table needs none; the CPU tensors then meet the
    # device check, as would a table on another card.
    with torch.no_grad(), pytest.raises(ValueError, match="one CUDA device"):
        swin_window_attention(qkv, table, 4, 2, 2, 2)


def test_the_wrapper_takes_no_cpu_tensors_and_names_the_twin():
    qkv, table = _inputs()
    before = (swin_window_attention.launches, swin_window_attention.backward_launches)
    with pytest.raises(ValueError, match="window_attention_reference"):
        swin_window_attention(qkv, table, 4, 2, 2, 2)
    assert (swin_window_attention.launches, swin_window_attention.backward_launches) == before


def test_the_cpu_twin_gives_a_table_that_needs_one_its_gradient():
    qkv, table = _inputs(requires_grad=True)
    out = window_attention_reference(qkv, table, 4, 2, 2, 2)
    (grad,) = torch.autograd.grad(out.square().sum(), table)
    assert grad.shape == table.shape and float(grad.abs().sum()) > 0
