"""The port's XCiT (``models.xcit``) on the CPU: ``xcit_mini`` against the
plain reference (``tests/_plain_xcit.py``) on seeded random weights, logits
and input gradient in fp32 and in float64; the guard that a reference
without the class attention's patch-row residual or with LPI's BatchNorm
before its GELU is a different model, and that the doubled patch rows
reach the logits through LayerNorm's eps alone; XCiT-L12's size and names
against the benchmark's ``param_specs``; the two reference copies against
each other; the loader of a timm-named ``state_dict``; the refusal of bf16;
the port's own random init; ``cli.main``'s build; the victim's spans (their
counts a pass, nothing without a profiler); the stream's layout; ViT's
fp32 logits beside the layers XCiT shares with it; and XCA's core: its
plain twin against timm's operations, the kernel wrapper's refusals, and
the card's path (each block's core through the wrapper) taken by a tensor
that says it is on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_xcit.py
"""

import math

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import _plain_xcit
from dl_attack_on_imagenet_tpu_torch.cli import main as cli_main
from dl_attack_on_imagenet_tpu_torch.cli._victim import build_victim
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.models.convert import load_torch_checkpoint
from dl_attack_on_imagenet_tpu_torch.models.xcit import XCiT, xca_reference, xcit_l12
from dl_attack_on_imagenet_tpu_torch.ops import kernels
from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench.reference import xcit as bench_xcit

torch.set_num_threads(1)

WEIGHTS = {"head_std": 0.11, "temperature": 20.0, "bn_mean_std": 0.2, "bn_var": 0.5,
           "ln_bias_std": 0.1, "cls_token_std": 0.02,
           "layer_scale": {"gamma1": 0.4, "gamma3": 0.25, "gamma2": 0.35, "cls_gamma1": 0.25,
                           "cls_gamma2": 0.25}}
MINI = dict(input_size=64, num_classes=1000, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            mlp_ratio=4, cls_attn_layers=2, lpi_kernel_size=3, pos_hidden_dim=32,
            pos_temperature=10000.0, layer_norm_eps=1e-6, batch_norm_eps=1e-5, weights=WEIGHTS)
L12 = dict(MINI, input_size=224, embed_dim=768, depth=12, num_heads=16)
# Logits within 1e-5 of the largest and input gradients within 1e-5 in
# relative l2: the port and the reference sum in other orders (the port's
# layer scales and residual adds are addcmuls, its stem adds the position
# encoding before the tokens' copy, its class attention divides q by
# sqrt(d) where the reference multiplies by d^-0.5), so they part by fp32
# rounding carried through 2 blocks and 2 class-attention layers: at most
# 3.4e-7 and 8.6e-7 over 8 seeds (the temperature, 20, scales XCA's
# rounding). The guard's smaller gap, the patch rows' residual left out,
# reads 6.0e-3 to 1.5e-2 in the logits on the same seeds: over 600x the
# tolerance.
TOL = 1e-5
PARTS = ("patch_rows_add", "lpi_order")


def with_counters(params: dict) -> dict:
    """``params`` and the BatchNorms' step counters, which no forward reads."""
    return {**params, **{k[:-len("running_var")] + "num_batches_tracked": torch.zeros(
        (), dtype=torch.long) for k in params if k.endswith(".running_var")}}


def mini_params(seed: int = 0, dtype=torch.float32) -> dict:
    """Every tensor of ``xcit_mini`` drawn at random: the matrices and
    kernels and the drawn statistics as the benchmark's specs scale them,
    and the constants (LayerNorm and BatchNorm weights, biases, running
    variances, temperatures, layer scales) perturbed around their values,
    so that each takes part channel by channel."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape, (kind, value) in bench_xcit.param_specs(MINI):
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
    victim = create_model("xcit_mini", device="cpu", state_dict=with_counters(params))
    return params, victim


@pytest.mark.parametrize("seed", [0, 3])
def test_mini_matches_the_plain_reference(seed):
    params = mini_params(seed)
    victim = create_model("xcit_mini", device="cpu", state_dict=with_counters(params))
    x = images(seed=seed + 1)
    logit_gap, grad_gap = gaps(logits_and_grad(victim, x),
                               logits_and_grad(_plain_xcit.model(params, MINI), x))
    assert logit_gap < TOL and grad_gap < TOL, (logit_gap, grad_gap)


def test_mini_matches_the_plain_reference_in_float64():
    """In float64 the orders of summation part by about 1e-16."""
    params = mini_params(dtype=torch.float64)
    victim = create_model("xcit_mini", device="cpu", state_dict=with_counters(params))
    victim.double().dtype = torch.float64  # an fp32 victim casts its input; as float64 it keeps it
    x = images().double()
    logit_gap, grad_gap = gaps(logits_and_grad(victim, x),
                               logits_and_grad(_plain_xcit.model(params, MINI), x))
    assert logit_gap < 1e-12 and grad_gap < 1e-12, (logit_gap, grad_gap)


@pytest.mark.parametrize("part", PARTS)
def test_a_reference_without_a_part_is_another_model(mini, part):
    params, victim = mini
    x = images()
    wrong = logits_and_grad(_plain_xcit.model(params, MINI, without=(part,)), x)
    assert min(gaps(logits_and_grad(victim, x), wrong)) > 100 * TOL


def test_the_doubled_patch_rows_reach_the_logits_through_layernorm_eps_alone(mini):
    """A class-attention layer returns its patch rows doubled, as timm's
    does, and the port's does so exactly; but the next layer reads them
    through its LayerNorm, which a row's scale does not move (but for
    eps), and the head reads the class row alone: a reference without the
    doubling computes the same logits within rounding. No check on the
    logits can see it, and none needs to."""
    params, victim = mini
    block = victim.net.cls_attn_blocks[0]
    z = torch.randn((2, 17, 64), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        u = block.norm1(z)
        y = block.norm2(torch.addcmul(z, block.gamma1, torch.cat([block.attn(u), u[:, 1:]], 1)))
        assert torch.equal(block(z)[:, 1:], 2 * y[:, 1:])
    x = images()
    want = logits_and_grad(_plain_xcit.model(params, MINI), x)
    undoubled = _plain_xcit.model(params, MINI, without=("patch_rows_doubled",))
    assert max(gaps(logits_and_grad(undoubled, x), want)) < TOL


def test_the_two_reference_copies_agree(mini):
    params, _ = mini
    x = images()
    assert all(torch.equal(a, b) for a, b in zip(
        logits_and_grad(_plain_xcit.model(params, MINI), x),
        logits_and_grad(bench_xcit.model(params, MINI), x)))


def test_xcit_l12_size_and_names_are_the_benchmarks():
    with torch.device("meta"):
        net = xcit_l12()
    assert sum(p.numel() for p in net.parameters()) == 103_792_648
    assert [(k, tuple(v.shape)) for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")] == [
        (name, tuple(shape)) for name, shape, _ in bench_xcit.param_specs(L12)]
    assert (len(net.blocks), len(net.cls_attn_blocks)) == (12, 2)
    lpi = net.blocks[5].local_mp.conv1
    assert (lpi.kernel_size, lpi.padding, lpi.groups) == ((3, 3), (1, 1), 768)
    assert [net.patch_embed.proj[i][0].out_channels for i in (0, 2, 4, 6)] == [96, 192, 384, 768]
    assert net.blocks[0].attn.temperature.shape == (16, 1, 1)
    assert net.blocks[0].norm1.eps == 1e-6 and net.blocks[0].local_mp.bn.eps == 1e-5


def timm_names(depth: int, cls_layers: int) -> list:
    """timm's ``xcit_*_p16`` ``state_dict`` keys, written out."""
    bn = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
    wb = ("weight", "bias")
    names = ["cls_token"]
    for j in (0, 2, 4, 6):
        names.append(f"patch_embed.proj.{j}.0.weight")
        names.extend(f"patch_embed.proj.{j}.1.{p}" for p in bn)
    names.extend(f"pos_embed.token_projection.{p}" for p in wb)
    for i in range(depth):
        b = f"blocks.{i}"
        names.extend([f"{b}.gamma1", f"{b}.gamma3", f"{b}.gamma2"])
        names.extend(f"{b}.norm1.{p}" for p in wb)
        names.append(f"{b}.attn.temperature")
        names.extend(f"{b}.attn.{m}.{p}" for m in ("qkv", "proj") for p in wb)
        names.extend(f"{b}.norm3.{p}" for p in wb)
        names.extend(f"{b}.local_mp.conv1.{p}" for p in wb)
        names.extend(f"{b}.local_mp.bn.{p}" for p in bn)
        names.extend(f"{b}.local_mp.conv2.{p}" for p in wb)
        names.extend(f"{b}.norm2.{p}" for p in wb)
        names.extend(f"{b}.mlp.{m}.{p}" for m in ("fc1", "fc2") for p in wb)
    for i in range(cls_layers):
        b = f"cls_attn_blocks.{i}"
        names.extend([f"{b}.gamma1", f"{b}.gamma2"])
        names.extend(f"{b}.norm1.{p}" for p in wb)
        names.extend(f"{b}.attn.{m}.{p}" for m in ("q", "k", "v", "proj") for p in wb)
        names.extend(f"{b}.norm2.{p}" for p in wb)
        names.extend(f"{b}.mlp.{m}.{p}" for m in ("fc1", "fc2") for p in wb)
    return names + ["norm.weight", "norm.bias", "head.weight", "head.bias"]


def test_loader_takes_a_timm_xcit_state_dict_strictly(mini, tmp_path):
    params, victim = mini
    state = with_counters(params)
    assert sorted(state) == sorted(timm_names(MINI["depth"], MINI["cls_attn_layers"]))
    assert state["blocks.0.attn.temperature"].shape == (4, 1, 1)  # timm's (heads, 1, 1)
    torch.save(state, tmp_path / "xcit.pth")
    fresh = load_torch_checkpoint(str(tmp_path / "xcit.pth"),
                                  create_model("xcit_mini", device="cpu", seed=9))
    x = images()
    assert torch.equal(fresh(x), victim(x))
    for broken in ({k: v for k, v in state.items() if k != "cls_attn_blocks.1.gamma2"},
                   {**state, "cls_attn_blocks.0.attn.qkv.weight": torch.zeros((192, 64))}):
        torch.save(broken, tmp_path / "broken.pth")
        with pytest.raises(RuntimeError, match="state_dict"):
            load_torch_checkpoint(str(tmp_path / "broken.pth"),
                                  create_model("xcit_mini", device="cpu"))


def test_xcit_is_fp32_only():
    with pytest.raises(ValueError, match="float32 only"):
        create_model("xcit_mini", device="cpu", dtype=torch.bfloat16)


def test_the_ports_random_init_keeps_the_published_values():
    """The class token N(0, 0.02), every temperature 1 and every layer
    scale at timm's eta, 1e-5; the BatchNorms as built."""
    net = create_model("xcit_mini", device="cpu", seed=5).net
    assert 0.01 < float(net.cls_token.std()) < 0.03
    assert all(torch.equal(b.attn.temperature, torch.ones(4, 1, 1)) for b in net.blocks)
    gammas = [p for n, p in net.named_parameters() if n.rsplit(".", 1)[-1].startswith("gamma")]
    assert len(gammas) == 3 * 2 + 2 * 2 and all(torch.all(g == 1e-5) for g in gammas)
    bn = net.blocks[1].local_mp.bn
    assert torch.equal(bn.running_mean, torch.zeros(64)) and torch.equal(bn.running_var,
                                                                          torch.ones(64))


def test_cli_main_builds_xcit_mini():
    args = cli_main.build_argparser().parse_args(["--model", "xcit_mini", "--device", "cpu",
                                                  "--seed", "11"])
    victim = build_victim(args)
    assert isinstance(victim.net, XCiT) and victim.input_size == 64
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
    assert _counts(victim, x) == {"victim/xcit/stem": 2, "victim/xcit/xca": 4,
                                  "victim/xcit/lpi": 4, "victim/xcit/mlp": 4,
                                  "victim/xcit/class_attn": 4, "victim/xcit/head": 2}
    assert all(s.parent is None for s in profiling.spans())
    assert profiling.device_totals() == {}  # a CPU victim times nothing on a card


def test_xcit_l12_opens_its_spans_a_pass(fresh_recorder):
    """XCiT-L12 on the meta device, shapes only: stem 1, xca, lpi and mlp
    12 each, class attention 2, head 1."""
    with torch.device("meta"):
        net = xcit_l12().requires_grad_(False)
        x = torch.empty((1, 3, 224, 224), requires_grad=True)
    assert _counts(net, x, passes=1) == {
        "victim/xcit/stem": 1, "victim/xcit/xca": 12, "victim/xcit/lpi": 12,
        "victim/xcit/mlp": 12, "victim/xcit/class_attn": 2, "victim/xcit/head": 1}


def test_every_sublayer_hands_on_contiguous_token_rows(mini):
    """The residual adds write the stream in contiguous (B, N, C) rows,
    LPI's transposed output included, and LPI's convolutions read a
    contiguous NCHW map."""
    _, victim = mini
    outs, maps = [], []
    handles = [m.register_forward_hook(lambda m, a, out: outs.append(out))
               for m in victim.net.modules() if type(m).__name__ in ("XCABlock",
                                                                     "ClassAttentionBlock")]
    handles += [m.register_forward_pre_hook(lambda m, a: maps.append(a[0]))
                for m in victim.net.modules() if type(m).__name__ == "LPI"]
    handles += [m.local_mp.conv1.register_forward_pre_hook(lambda m, a: maps.append(a[0]))
                for m in victim.net.blocks]
    try:
        x = images().requires_grad_(True)
        torch.autograd.grad(victim(x).sum(), x)
    finally:
        for h in handles:
            h.remove()
    assert len(outs) == MINI["depth"] + MINI["cls_attn_layers"]
    assert all(o.is_contiguous() for o in outs)
    assert len(maps) == 2 * MINI["depth"] and all(m.is_contiguous() for m in maps)


def test_vit_fp32_logits_are_bit_identical_beside_the_shared_layers():
    """ViT-B/16's fp32 path through the layers XCiT shares with it
    (``vit.LayerNorm``, ``vit.GELU``, ``vit.attend``, ``layers.Linear``,
    ``layers.Conv2d``) computes what these plain ops, in ViT's order, do,
    bit for bit: a change to a shared layer for XCiT's sake shows here."""
    victim = create_model("vit_tiny", input_size=32, device="cpu", seed=3)
    p = victim.net.state_dict()
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    heads, dim = 4, 64

    def ln(t, name):
        return F.layer_norm(t, (dim,), p[f"{name}.weight"], p[f"{name}.bias"], 1e-6)

    def plain(images):
        t = victim.norm(images.permute(0, 3, 1, 2)).contiguous()
        t = F.conv2d(t, p["conv_proj.weight"], p["conv_proj.bias"], stride=16)
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([p["class_token"].expand(t.shape[0], -1, -1), t], dim=1)
        t = t + p["encoder.pos_embedding"]
        for i in range(2):
            b = f"encoder.layers.encoder_layer_{i}"
            n, length, _ = t.shape
            qkv = F.linear(ln(t, f"{b}.ln_1"), p[f"{b}.self_attention.in_proj_weight"],
                           p[f"{b}.self_attention.in_proj_bias"])
            q, k, v = qkv.view(n, length, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
            w = torch.softmax((q / math.sqrt(dim // heads)) @ k.transpose(-2, -1), dim=-1)
            a = (w @ v).transpose(1, 2).reshape(n, length, dim)
            t = t + F.linear(a, p[f"{b}.self_attention.out_proj.weight"],
                             p[f"{b}.self_attention.out_proj.bias"])
            h = F.gelu(F.linear(ln(t, f"{b}.ln_2"), p[f"{b}.mlp.0.weight"], p[f"{b}.mlp.0.bias"]))
            t = t + F.linear(h, p[f"{b}.mlp.3.weight"], p[f"{b}.mlp.3.bias"])
        return F.linear(ln(t, "encoder.ln")[:, 0], p["heads.head.weight"], p["heads.head.bias"])

    with torch.no_grad():
        assert torch.equal(victim(x), plain(x))


def timm_xca_core(qkv, temperature, heads):
    """timm's ``XCA.forward`` between ``self.qkv`` and ``self.proj``, as
    timm writes it (dropout the identity)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    qkv = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 4, 1)
    q, k, v = qkv.unbind(0)
    q = torch.nn.functional.normalize(q, dim=-1)
    k = torch.nn.functional.normalize(k, dim=-1)
    attn = (q @ k.transpose(-2, -1)) * temperature
    attn = attn.softmax(dim=-1)
    return (attn @ v).permute(0, 3, 1, 2).reshape(b, n, c)


@pytest.mark.parametrize("heads,tokens", [(4, 16), (16, 196)])
def test_the_xca_twin_is_timms_core(heads, tokens):
    """``xca_reference`` computes timm's operations bit for bit, forward and
    qkv's gradient, with a zero channel (``F.normalize``'s eps branch); the
    block's XCA on the CPU is its projection of the twin."""
    g = torch.Generator().manual_seed(heads)
    c = 48 * heads if heads == 16 else 16 * heads
    qkv = torch.randn((2, tokens, 3 * c), generator=g)
    qkv[..., 3] = 0
    temperature = 1 + torch.rand((heads, 1, 1), generator=g)
    grad_out = torch.randn((2, tokens, c), generator=g)
    out = []
    for fn in (xca_reference, timm_xca_core):
        x = qkv.clone().requires_grad_(True)
        y = fn(x, temperature, heads)
        out.append((y.detach(), torch.autograd.grad(y, x, grad_out)[0]))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert torch.isfinite(out[0][1]).all()
    attn = xcit_l12().blocks[0].attn if heads == 16 else XCiT(64, 2, heads).blocks[0].attn
    x = torch.randn((2, tokens, c), generator=g)
    with torch.no_grad():
        assert torch.equal(attn(x), attn.proj(xca_reference(attn.qkv(x), attn.temperature,
                                                            heads)))


def _xca_args(case):
    """(qkv, temperature, heads) for a refusal ``case``: each is what the
    kernel takes but for the one thing the case names."""
    heads, d = 4, 16
    qkv = torch.randn((2, 16, 3 * heads * d))
    temperature = torch.ones((heads, 1, 1))
    if case == "head_dim":
        return qkv, torch.ones((2, 1, 1)), 2  # heads of 32
    if case == "shape":
        return qkv[0], temperature, heads
    if case == "temperatures":
        return qkv, torch.ones((heads + 1, 1, 1)), heads
    if case == "temperature_grad":
        return qkv, temperature.requires_grad_(True), heads
    if case == "dtype":
        return qkv.double(), temperature.double(), heads
    if case == "non_contiguous":
        return torch.randn((2, 3 * heads * d, 16)).transpose(1, 2), temperature, heads
    if case == "unaligned":
        return torch.randn(2 * 16 * 3 * heads * d + 1)[1:].view(2, 16, -1), temperature, heads
    return qkv, temperature, heads  # "cpu": all it takes, on the CPU


@pytest.mark.parametrize("case,error,match", [
    ("head_dim", ValueError, "no kernel for head dim 32"),
    ("shape", ValueError, "must be"),
    ("temperatures", ValueError, "temperatures for"),
    ("temperature_grad", ValueError, "no gradient"),
    ("dtype", TypeError, "float32 only"),
    ("non_contiguous", ValueError, "contiguous"),
    ("unaligned", ValueError, "16-byte aligned"),
    ("cpu", ValueError, "CUDA device"),
])
def test_the_xca_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    with pytest.raises(error, match=match):
        kernels.xcit_xca(*_xca_args(case))


def test_the_temperature_may_need_a_gradient_without_autograd():
    """A temperature that requires a gradient passes the wrapper's check
    where autograd records nothing; the CPU tensor is then refused for its
    device alone."""
    qkv, temperature, heads = _xca_args("temperature_grad")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        kernels.xcit_xca(qkv, temperature, heads)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on CUDA, so that a pass on it takes the
    card's path; every tensor computed from it is one too."""

    @property
    def is_cuda(self):
        return True


def test_a_card_tensor_takes_the_kernel_in_every_block(mini, monkeypatch):
    """Each block's XCA hands the kernel wrapper its qkv rows and its
    temperature on the card (here the twin stands in for the launch), once a
    block a pass, with the logits of the CPU's path."""
    params, victim = mini
    calls = []

    def launch(qkv, temperature, heads):
        calls.append((tuple(qkv.shape), heads, qkv.is_contiguous()))
        return xca_reference(qkv, temperature, heads)

    monkeypatch.setattr(kernels, "xcit_xca", launch)
    x = images()
    want = victim(x)
    assert calls == []
    got = victim(x.as_subclass(_OnCard))
    assert calls == [((2, 16, 192), 4, True)] * MINI["depth"]
    assert torch.equal(got.as_subclass(torch.Tensor), want)
