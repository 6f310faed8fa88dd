"""The port's Swin Transformer (``models.swin``) on the CPU: ``swin_tiny``
against the plain reference (``tests/_plain_swin.py``) on seeded random
weights, logits and input gradient in fp32; the guard that a reference
without the shift, the mask or the relative-position bias is a different
model; Swin-B's size and names against the benchmark's ``param_specs``;
the two reference copies against each other; ViT's fp32 logits unchanged
by the shared attention step; the loader of a torchvision-named Swin
``state_dict``; the CLI's build; and the victim's spans (each once per
block per pass, nothing without a profiler) with the device clock's hooks
(CUDA events stood in for by a counter).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_swin.py
"""

import argparse
import math

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import _plain_swin
from dl_attack_on_imagenet_tpu_torch.cli._victim import build_victim
from dl_attack_on_imagenet_tpu_torch.models import create_model, vit
from dl_attack_on_imagenet_tpu_torch.models.convert import load_torch_checkpoint
from dl_attack_on_imagenet_tpu_torch.models.swin import (SwinTransformer, relative_bias,
                                                         relative_position_index, swin_b)
from dl_attack_on_imagenet_tpu_torch.utils import profiling
from h100bench.reference import swin as bench_swin

torch.set_num_threads(1)

TINY = dict(input_size=64, num_classes=1000, patch_size=4, embed_dim=16, depths=[2, 2, 2],
            num_heads=[2, 4, 8], window_size=4, mlp_ratio=4.0, weights={"head_std": 0.1})
# Logits within 1e-5 of the largest and input gradients within 1e-5 in
# relative l2: the port and the reference sum in other orders (the port's
# windows in one batch of scores, the bias and mask added as one term, its
# q scaled before the product), so they part by fp32 rounding carried
# through 6 blocks and 2 merges, 2.5e-7 and 8.4e-7 here. The guard's
# smallest gap, the bias left out, reads 4.8e-3 in logits and 2.0e-2 in
# the gradient: the tolerance sits between with room on both sides.
TOL = 1e-5


def tiny_params(seed: int = 0) -> dict:
    """Every tensor of ``swin_tiny`` drawn at random: the matrices as the
    benchmark's specs scale them, and the biases, LayerNorms and bias
    tables perturbed around their starts, so that each takes part."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape, (kind, value) in bench_swin.param_specs(TINY):
        noise = torch.randn(shape, generator=g)
        params[name] = noise * value if kind == "normal" else value + 0.1 * noise
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
def tiny():
    params = tiny_params()
    victim = create_model("swin_tiny", device="cpu", state_dict=params)
    return params, victim


def test_tiny_matches_the_plain_reference(tiny):
    params, victim = tiny
    x = images()
    got = logits_and_grad(victim, x)
    want = logits_and_grad(_plain_swin.model(params, TINY), x)
    logit_gap, grad_gap = gaps(got, want)
    assert logit_gap < TOL and grad_gap < TOL, (logit_gap, grad_gap)


@pytest.mark.parametrize("part", ["shift", "mask", "bias"])
def test_a_reference_without_a_part_is_another_model(tiny, part):
    params, victim = tiny
    x = images()
    got = logits_and_grad(victim, x)
    wrong = logits_and_grad(_plain_swin.model(params, TINY, without=(part,)), x)
    assert max(gaps(got, wrong)) > 10 * TOL


def test_the_two_reference_copies_agree(tiny):
    params, _ = tiny
    x = images()
    with torch.no_grad():
        assert torch.equal(_plain_swin.model(params, TINY)(x), bench_swin.model(params, TINY)(x))


def test_swin_b_size_and_names_are_the_benchmarks():
    with torch.device("meta"):
        net = swin_b()
    assert sum(p.numel() for p in net.parameters()) == 87_768_224
    cfg = dict(input_size=224, num_classes=1000, patch_size=4, embed_dim=128,
               depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32], window_size=7, mlp_ratio=4.0,
               weights={"head_std": 0.1})
    assert [(k, tuple(v.shape)) for k, v in net.state_dict().items()] == [
        (name, tuple(shape)) for name, shape, _ in bench_swin.param_specs(cfg)]
    shifted = [b.attn.shift for stage in (1, 3, 5, 7) for b in net.features[stage]]
    assert len(shifted) == 24 and sum(map(bool, shifted)) == 12  # 11 once stage 4's is 0


def test_swin_is_fp32_only_and_refuses_maps_its_windows_do_not_tile():
    with pytest.raises(ValueError, match="float32 only"):
        create_model("swin_tiny", device="cpu", dtype=torch.bfloat16)
    victim = create_model("swin_tiny", input_size=32, device="cpu")
    with pytest.raises(ValueError, match="do not tile a 2x2 map"):
        victim(torch.rand((1, 32, 32, 3)))


def test_the_relative_bias_follows_the_loaded_table(tiny):
    params, victim = tiny
    attn = victim.net.features[1][0].attn
    before = relative_bias(attn.relative_position_bias_table, attn.window).clone()
    table = params["features.1.0.attn.relative_position_bias_table"] + 1.0
    victim.net.load_state_dict({**params, "features.1.0.attn.relative_position_bias_table": table})
    try:
        assert torch.equal(relative_bias(attn.relative_position_bias_table, attn.window),
                           before + 1.0)
    finally:
        victim.net.load_state_dict(params)


def _old_vit_attention(self, x):
    """ViT's fp32 attention as it was written before :func:`vit.attend`."""
    n, length, dim = x.shape
    head_dim = dim // self.num_heads
    qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
    q, k, v = qkv.view(n, length, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
    weights = torch.softmax((q / math.sqrt(head_dim)) @ k.transpose(-2, -1), dim=-1)
    out = (weights @ v).transpose(1, 2).reshape(n, length, dim)
    return self.out_proj(out)


def test_vit_fp32_logits_are_bit_identical_with_the_shared_attention(monkeypatch):
    victim = create_model("vit_tiny", input_size=32, device="cpu", seed=3)
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    got = victim(x)
    monkeypatch.setattr(vit.SelfAttention, "forward", _old_vit_attention)
    assert torch.equal(got, victim(x))


def test_loader_takes_a_torchvision_swin_state_dict(tiny, tmp_path):
    """torchvision keeps each block's ``relative_position_index`` in its
    ``state_dict``; the port computes it and leaves it out of its own."""
    params, victim = tiny
    state = dict(params)
    for key in params:
        if key.endswith("relative_position_bias_table"):
            state[key.replace("bias_table", "index")] = relative_position_index(4)
    torch.save(state, tmp_path / "swin.pth")
    fresh = load_torch_checkpoint(str(tmp_path / "swin.pth"),
                                  create_model("swin_tiny", device="cpu", seed=9))
    x = images()
    assert torch.equal(fresh(x), victim(x))
    key = "features.1.0.attn.relative_position_index"
    state[key] = relative_position_index(4).flip(0)
    torch.save(state, tmp_path / "wrong.pth")
    with pytest.raises(ValueError, match="relative_position_index"):
        load_torch_checkpoint(str(tmp_path / "wrong.pth"), create_model("swin_tiny", device="cpu"))


def test_cli_builds_swin_tiny():
    args = argparse.Namespace(model="swin_tiny", seed=11, input_size=None, fast_victim=False,
                              weights=None, device="cpu")
    victim = build_victim(args)
    assert isinstance(victim.net, SwinTransformer) and victim.input_size == 64
    assert victim(images(1)).shape == (1, 1000)


@pytest.fixture
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def test_spans_open_once_per_block_per_pass(tiny, fresh_recorder):
    _, victim = tiny
    x = images().requires_grad_(True)
    victim(x)  # no profiler: nothing recorded
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            out = victim(x)
            torch.autograd.grad(out.sum(), x)
    counts = {name: t.count for name, t in profiling.totals().items()}
    blocks = sum(TINY["depths"])
    assert counts == {"victim/swin/embed": 2, "victim/swin/attention": 2 * blocks,
                      "victim/swin/shift": 4 * blocks, "victim/swin/mlp": 2 * blocks,
                      "victim/swin/merge": 4, "victim/swin/head": 2}
    by_id = {s.id: s for s in profiling.spans()}
    assert {by_id[s.parent].name for s in by_id.values() if s.name == "victim/swin/shift"} \
        == {"victim/swin/attention"}
    assert all(s.parent is None for s in by_id.values() if s.name != "victim/swin/shift")
    assert profiling.device_totals() == {}  # a CPU victim times nothing on a card


class FakeEvent:
    """A CUDA event's stand-in: the order it was recorded in."""

    clock = 0

    def __init__(self):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def elapsed_time(self, end) -> float:  # milliseconds, as CUDA's
        return float(end.t - self.t)


def test_device_clock_pairs_forward_and_backward(monkeypatch, fresh_recorder):
    monkeypatch.setattr(profiling, "_event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    lin = torch.nn.Linear(4, 4).requires_grad_(False)
    x = torch.rand(2, 4, requires_grad=True)
    off = profiling.annotate("test/off", device=True)
    with off as span:
        assert span.backward(x, lin(x)) is not None  # the no-op span, without a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("test/a", device=True) as span:
            y = span.backward(x, lin(x))
        with profiling.annotate("test/b", device=True) as span:
            z = span.backward(y, lin(y).tanh())
        with profiling.annotate("test/b", device=True) as span:
            span.backward(z, lin(z))  # no backward runs through this pass
        with torch.no_grad(), profiling.annotate("test/a", device=True) as span:
            span.backward(x, lin(x))  # nothing to time backward
        torch.autograd.grad(z.sum(), x)
    ran = [(name, pair) for name, phase, pair in profiling._RECORDER._pairs
           if phase == "backward" and None not in pair]
    assert [name for name, _ in ran] == ["test/a", "test/b"]
    a, b = ran[0][1], ran[1][1]
    # b's backward runs first, then a's; b ends and a starts as y's
    # gradient is ready, recorded one after the other at the same point.
    assert b[0].t < b[1].t and a[0].t < a[1].t and b[0].t < a[0].t
    assert abs(a[0].t - b[1].t) == 1
    totals = profiling.device_totals()
    assert totals["test/a"].count == 2 and totals["test/b"].count == 2
    assert totals["test/a"].backward_s == pytest.approx((a[1].t - a[0].t) / 1e3)
    assert totals["test/b"].backward_s == pytest.approx((b[1].t - b[0].t) / 1e3)
    assert all(t.forward_s > 0 for t in totals.values())
