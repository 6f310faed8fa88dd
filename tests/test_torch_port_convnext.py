"""The port's ConvNeXt (``models.convnext``) on the CPU: ``convnext_mini``
against the plain reference (``tests/_plain_convnext.py``) on seeded random
weights, logits and input gradient in fp32 and in float64; the guard that
a reference without the depthwise convolution, the layer scale, a
downsample's LayerNorm or the exact GELU is a different model; ConvNeXt-B's
size and names against the benchmark's ``param_specs``; the two reference
copies against each other; the loader of a torchvision-named ConvNeXt
``state_dict``; the refusal of bf16; ``cli.main``'s build; and the victim's
spans (their counts a pass, nothing without a profiler).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_convnext.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _plain_convnext
from dl_attack_on_imagenet_tpu_torch.cli import main as cli_main
from dl_attack_on_imagenet_tpu_torch.cli._victim import build_victim
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.models.convert import load_torch_checkpoint
from dl_attack_on_imagenet_tpu_torch.models.convnext import ConvNeXt, convnext_b
from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench.reference import convnext as bench_convnext

torch.set_num_threads(1)

MINI = dict(input_size=64, num_classes=1000, dims=[16, 32, 64], depths=[2, 1, 2], kernel_size=7,
            mlp_ratio=4, layer_norm_eps=1e-6, weights={"head_std": 0.1, "layer_scale": 0.3})
BASE = dict(MINI, input_size=224, dims=[128, 256, 512, 1024], depths=[3, 3, 27, 3])
# Logits within 1e-6 of the largest and input gradients within 1e-6 in
# relative l2: the port and the reference sum in other orders (the port's
# layer scale and residual add are one addcmul, its LayerNorms read the
# permuted maps through other copies), so they part by fp32 rounding
# carried through 5 blocks and 2 downsamples, at most 2.4e-7 and 3.9e-7
# over 4 seeds. The guard's smallest gap, the tanh GELU in place of the
# exact one, reads 2.2e-4 to 2.5e-4 in the gradient on the same seeds: over
# 100x the tolerance.
TOL = 1e-6
PARTS = ("dwconv", "layer_scale", "downsample_norm", "exact_gelu")


def mini_params(seed: int = 0, dtype=torch.float32) -> dict:
    """Every tensor of ``convnext_mini`` drawn at random: the matrices and
    kernels as the benchmark's specs scale them, and the biases,
    LayerNorms and layer scales perturbed around their starts, so that
    each takes part."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape, (kind, value) in bench_convnext.param_specs(MINI):
        noise = torch.randn(shape, generator=g)
        params[name] = (noise * value if kind == "normal" else value + 0.1 * noise).to(dtype)
    return params


def images(n: int = 2, seed: int = 1) -> torch.Tensor:
    return torch.rand((n, 64, 64, 3), generator=torch.Generator().manual_seed(seed))


def logits_and_grad(fn, x):
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (grad,) = torch.autograd.grad(out.logsumexp(-1).sum() - out[:, 3].sum(), x)
    return out.detach(), grad


def gaps(got, want) -> tuple:
    (lg, gg), (lw, gw) = got, want
    return (float((lg - lw).abs().max() / lw.abs().max()),
            float(torch.linalg.vector_norm(gg - gw) / torch.linalg.vector_norm(gw)))


@pytest.fixture(scope="module")
def mini():
    params = mini_params()
    victim = create_model("convnext_mini", device="cpu", state_dict=params)
    return params, victim


def test_mini_matches_the_plain_reference(mini):
    params, victim = mini
    x = images()
    logit_gap, grad_gap = gaps(logits_and_grad(victim, x),
                               logits_and_grad(_plain_convnext.model(params, MINI), x))
    assert logit_gap < TOL and grad_gap < TOL, (logit_gap, grad_gap)


def test_mini_matches_the_plain_reference_in_float64():
    """In float64 the orders of summation part by about 1e-16."""
    params = mini_params(dtype=torch.float64)
    victim = create_model("convnext_mini", device="cpu", state_dict=params)
    victim.double().dtype = torch.float64  # an fp32 victim casts its input; as float64 it keeps it
    x = images().double()
    logit_gap, grad_gap = gaps(logits_and_grad(victim, x),
                               logits_and_grad(_plain_convnext.model(params, MINI), x))
    assert logit_gap < 1e-12 and grad_gap < 1e-12, (logit_gap, grad_gap)


@pytest.mark.parametrize("part", PARTS)
def test_a_reference_without_a_part_is_another_model(mini, part):
    params, victim = mini
    x = images()
    wrong = logits_and_grad(_plain_convnext.model(params, MINI, without=(part,)), x)
    assert max(gaps(logits_and_grad(victim, x), wrong)) > 100 * TOL


def test_the_two_reference_copies_agree(mini):
    params, _ = mini
    x = images()
    with torch.no_grad():
        assert torch.equal(_plain_convnext.model(params, MINI)(x),
                           bench_convnext.model(params, MINI)(x))


def test_convnext_b_size_and_names_are_the_benchmarks():
    with torch.device("meta"):
        net = convnext_b()
    assert sum(p.numel() for p in net.parameters()) == 88_591_464
    assert [(k, tuple(v.shape)) for k, v in net.state_dict().items()] == [
        (name, tuple(shape)) for name, shape, _ in bench_convnext.param_specs(BASE)]
    assert [len(net.features[i]) for i in (1, 3, 5, 7)] == [3, 3, 27, 3]
    dwconv = net.features[5][0].block[0]
    assert (dwconv.kernel_size, dwconv.padding, dwconv.groups) == ((7, 7), (3, 3), 512)
    assert net.features[5][0].block[2].eps == 1e-6


def torchvision_names(dims, depths) -> list:
    """torchvision's ``convnext_*`` ``state_dict`` keys, written out."""
    names = ["features.0.0.weight", "features.0.0.bias", "features.0.1.weight",
             "features.0.1.bias"]
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"features.{2 * i + 1}.{j}"
            names.append(f"{b}.layer_scale")
            names.extend(f"{b}.block.{k}.{p}" for k in (0, 2, 3, 5) for p in ("weight", "bias"))
        if i < len(depths) - 1:
            names.extend(f"features.{2 * i + 2}.{k}.{p}" for k in (0, 1)
                         for p in ("weight", "bias"))
    return names + ["classifier.0.weight", "classifier.0.bias", "classifier.2.weight",
                    "classifier.2.bias"]


def test_loader_takes_a_torchvision_convnext_state_dict_strictly(mini, tmp_path):
    params, victim = mini
    assert list(params) == torchvision_names(MINI["dims"], MINI["depths"])
    assert params["features.1.0.layer_scale"].shape == (16, 1, 1)  # torchvision's (C, 1, 1)
    torch.save(params, tmp_path / "convnext.pth")
    fresh = load_torch_checkpoint(str(tmp_path / "convnext.pth"),
                                  create_model("convnext_mini", device="cpu", seed=9))
    x = images()
    assert torch.equal(fresh(x), victim(x))
    for broken in ({k: v for k, v in params.items() if k != "features.3.0.layer_scale"},
                   {**params, "features.1.0.stochastic_depth.p": torch.zeros(())}):
        torch.save(broken, tmp_path / "broken.pth")
        with pytest.raises(RuntimeError, match="state_dict"):
            load_torch_checkpoint(str(tmp_path / "broken.pth"),
                                  create_model("convnext_mini", device="cpu"))


def test_convnext_is_fp32_only():
    with pytest.raises(ValueError, match="float32 only"):
        create_model("convnext_mini", device="cpu", dtype=torch.bfloat16)


def test_cli_main_builds_convnext_mini():
    args = cli_main.build_argparser().parse_args(["--model", "convnext_mini", "--device", "cpu",
                                                  "--seed", "11"])
    victim = build_victim(args)
    assert isinstance(victim.net, ConvNeXt) and victim.input_size == 64
    assert victim(images(1)).shape == (1, 1000)


@pytest.fixture
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _counts(victim, x, passes=2) -> dict:
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(passes):
            torch.autograd.grad(victim(x).sum(), x)
    return {name: t.count for name, t in profiling.totals().items()}


def test_spans_open_the_stated_number_of_times_a_pass(mini, fresh_recorder):
    _, victim = mini
    x = images().requires_grad_(True)
    victim(x)  # no profiler: nothing recorded
    assert profiling.spans() == []
    blocks = sum(MINI["depths"])
    assert _counts(victim, x) == {"victim/convnext/stem": 2, "victim/convnext/dwconv": 2 * blocks,
                                  "victim/convnext/mlp": 2 * blocks,
                                  "victim/convnext/downsample": 4, "victim/convnext/head": 2}
    assert all(s.parent is None for s in profiling.spans())
    assert profiling.device_totals() == {}  # a CPU victim times nothing on a card


def test_convnext_b_opens_its_spans_36_times_a_pass(fresh_recorder):
    """ConvNeXt-B on the meta device, shapes only: stem 1, dwconv 36, mlp
    36, downsample 3, head 1."""
    with torch.device("meta"):
        net = convnext_b().requires_grad_(False)
        x = torch.empty((1, 3, 224, 224), requires_grad=True)
    assert _counts(net, x, passes=1) == {
        "victim/convnext/stem": 1, "victim/convnext/dwconv": 36, "victim/convnext/mlp": 36,
        "victim/convnext/downsample": 3, "victim/convnext/head": 1}


def test_every_block_hands_on_a_contiguous_nchw_map(mini):
    """The residual add writes the stream in contiguous NCHW, the layout of
    the next depthwise convolution's input."""
    _, victim = mini
    outs = []
    handles = [m.register_forward_hook(lambda m, a, out: outs.append(out))
               for m in victim.net.modules() if type(m).__name__ in ("CNBlock", "Downsample")]
    try:
        x = images().requires_grad_(True)
        torch.autograd.grad(victim(x).sum(), x)
    finally:
        for h in handles:
            h.remove()
    assert len(outs) == sum(MINI["depths"]) + 2
    assert all(o.is_contiguous() for o in outs)
