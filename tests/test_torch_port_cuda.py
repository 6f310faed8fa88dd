"""The port's CUDA kernels on the card: fused_perturb against its plain twin
(atol 1e-5: the kernel and cuBLAS sum the K products in other orders),
fused_adamw_project against its twin (p and mu within 1e-6, nu within 1e-6
relative: elementwise fp32 in the twin's order), their launch counts, the
wrappers' refusals, three training steps on the card against the CPU, and
every victim family's logits and CW input gradient on the card against the
CPU (within 1e-4), and an fp32 ResNet-50 in NCHW launching none of cuDNN's
layout transposes; the bf16 mixed precision on the card against the CPU,
the bf16 products' fp32 accumulator, and data-parallel learning at world
size 1 over NCCL against its serial replay, and a sharded checkpoint of
CUDA tensors at world size 1 over NCCL (bit-equal); DeepFool and a UAP-PGD epoch on
the card against the CPU, and data-parallel UAP-PGD at world size 1 over
NCCL against its replay; both kernels at ADILR's shapes (fused_perturb at
K=10, fused_adamw_project without a clamp against torch.optim.AdamW), and
ADILR's forwards and AdamW trainer on the card against the CPU; the
torchattacks grid's PGD, DIFGSM, CW, APGD-T, FAB, Square and OnePixel on
the card against the CPU with the same draws (1e-4, equal decisions), and
OnePixel's painting of duplicate coordinates; the space-to-depth stems on
the card against the CPU and the plain stem (1e-4), pipelined learning on
an S2D-stem ResNet-18 against the serial loop, and ``cli.generate`` on the card against the CPU; Swin-B's device-timed
spans against the device time of a whole pass, and its DDrague batch's
blocking reads against ViT-B/16's; the Swin window-attention kernel
against its plain twin at every Swin-B stage shape (output within 1e-5 of
its largest value, each of dq, dk, dv within 1e-4 in relative l2), and its
launches: 24 forwards and 24 backwards a Swin-B pass, ``swin_tiny``'s
blocks too, none for an empty batch. Every test here needs a GPU and skips
without one.

This file imports neither JAX nor the JAX package (the grid's tests take
their runs from ``chip_smoke.py``, which imports neither), so it also runs
on a machine that has only PyTorch, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.ops import kernels, native
from dl_attack_on_imagenet_tpu_torch.ops import (
    attack_loss,
    codes_from_pinv,
    dict_apply,
    fused_adamw_project,
    fused_adamw_project_reference,
    fused_perturb,
    fused_perturb_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no GPU present: the CUDA kernel runs only on the card")
    # True fp32 in matmuls and in cuDNN convolutions, and bf16 products with
    # an fp32 accumulator, as chip_smoke.py runs.
    matmul = torch.backends.cuda.matmul
    flags = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda")
    (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     matmul.allow_bf16_reduced_precision_reduction) = flags


def _inputs(dev, n, k, m, v_scale=0.01, x_offset=0):
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn((n, k), generator=g, device=dev) * v_scale
    d = torch.rand((k, m), generator=g, device=dev) * 2 - 1
    # x_offset=1 puts x one float into its buffer: contiguous, but not
    # 16-byte aligned, so the kernel's scalar instance runs.
    x = torch.empty(n * m + x_offset, device=dev)[x_offset:].view(n, m)
    x.copy_(torch.rand((n, m), generator=g, device=dev))
    return v, d, x


def _max_k():
    return kernels._bind(native.load("fused_perturb"))[1]


@pytest.mark.parametrize("n,k,m,eps,v_scale,x_offset", [
    (64, 100, 224 * 224 * 3, 8 / 255, 0.01, 0),       # the serving shape
    (5, 7, 3 * 257, 0.05, 0.1, 0),                     # ragged N and M
    (64, 100, 224 * 224 * 3, float("inf"), 0.01, 0),   # supervised read-off
    (17, 100, 224 * 224 * 3, 8 / 255, 10.0, 0),        # huge codes: the clamp decides
    (1, 100, 3 * 1028, 8 / 255, 0.01, 0),              # one row
    (63, 100, 3 * 1028, 8 / 255, 0.01, 0),             # one short row chunk
    (65, 100, 3 * 1028, 8 / 255, 0.01, 0),             # a second chunk of one row
    (130, 100, 3 * 1028, 8 / 255, 0.01, 0),            # three row chunks
    (64, 1, 3 * 1028, 8 / 255, 0.01, 0),               # one atom: one short stage
    (5, "max", 1028, float("inf"), 0.001, 0),          # the largest K the wrapper takes
    (64, 100, 3 * 1028, 8 / 255, 0.01, 0),             # M % 4 == 0, not a whole tile
    (64, 100, 3 * 1028, 8 / 255, 0.01, 1),             # x not 16-byte aligned
    (64, 100, 3 * 1028, 0.0, 0.01, 0),                 # eps = 0: out is x
    (64, 100, 299 * 299 * 3, 8 / 255, 0.01, 0),        # Inception at 299: M odd, scalar
    (5, 100, 299 * 299 * 3, float("inf"), 0.01, 0),    # instance, full rows
])
def test_cuda_kernel_matches_plain_twin(cuda, n, k, m, eps, v_scale, x_offset):
    k = _max_k() if k == "max" else k
    v, d, x = _inputs(cuda, n, k, m, v_scale, x_offset)
    before = fused_perturb.launches
    got = fused_perturb(v, d, x, eps)
    torch.cuda.synchronize()
    assert fused_perturb.launches == before + 1
    assert float((got - fused_perturb_reference(v, d, x, eps)).abs().max()) <= 1e-5
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    assert float((got - x).abs().max()) <= eps + 1e-6


def test_cuda_kernel_launch_is_persistent_and_spills_nothing(cuda):
    info = kernels.fused_perturb_launch_info(64, 224 * 224 * 3)
    assert info["vec"] == 1 and info["spill_bytes"] == 0
    assert info["grid"] == min(info["sms"] * info["blocks_per_sm"], info["tiles"])
    assert info["items"] == info["tiles"]  # N = 64: one row chunk a tile
    assert kernels.fused_perturb_launch_info(65, 1027, aligned=False)["vec"] == 0


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
    big = _inputs(cuda, 2, _max_k() + 1, 8)
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


def _adamw_inputs(dev, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand((n,), generator=g, device=dev) * 2.4 - 1.2  # some beyond ±1
    grad = torch.randn((n,), generator=g, device=dev)
    mu = torch.randn((n,), generator=g, device=dev) * 0.1
    nu = torch.rand((n,), generator=g, device=dev) * 0.01
    return p, grad, mu, nu


def _check_adamw(args, step, clip_val, lr=0.01):
    want = fused_adamw_project_reference(*args, step, lr, clip_val=clip_val)
    before = fused_adamw_project.launches
    out = fused_adamw_project(*args, step, lr, clip_val)
    torch.cuda.synchronize()
    assert fused_adamw_project.launches == before + 1
    assert out[0] is args[0] and out[1] is args[2] and out[2] is args[3]  # in place
    p, mu, nu = out
    assert float((p - want[0]).abs().max()) <= 1e-6
    assert float((mu - want[1]).abs().max()) <= 1e-6
    assert float(((nu - want[2]).abs() / want[2].abs().clamp(min=1e-30)).max()) <= 1e-6
    if clip_val == 1.0:
        assert float(p.abs().max()) <= 1.0


@pytest.mark.parametrize("n", [257, 100 * 224 * 224 * 3])
@pytest.mark.parametrize("step", [1, 2, 100])
@pytest.mark.parametrize("clip_val", [1.0, float("inf")])
def test_adamw_kernel_matches_plain_twin(cuda, n, step, clip_val):
    _check_adamw(_adamw_inputs(cuda, n), step, clip_val)


def test_adamw_kernel_takes_unaligned_views(cuda):
    # Views one element in are not 16-byte aligned: the scalar loop runs.
    p, g, mu, nu = (t[1:] for t in _adamw_inputs(cuda, 1002))
    _check_adamw((p, g, mu, nu), 3, 1.0)


def test_adamw_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p, g, mu, nu = _adamw_inputs(cuda, 64)
    before = fused_adamw_project.launches
    with pytest.raises(TypeError):
        fused_adamw_project(p.double(), g.double(), mu.double(), nu.double(), 1, 0.01)
    with pytest.raises(ValueError, match="contiguous"):
        fused_adamw_project(p.reshape(8, 8).T, g.reshape(8, 8), mu.reshape(8, 8),
                            nu.reshape(8, 8), 1, 0.01)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_adamw_project(p, g.cpu(), mu, nu, 1, 0.01)
    with pytest.raises(ValueError, match="one shape"):
        fused_adamw_project(p, g[:63], mu, nu, 1, 0.01)
    assert fused_adamw_project.launches == before


def test_train_steps_on_the_card_match_the_cpu(cuda):
    # atol 1e-4: cuDNN sums in another order than the CPU, and AdamW
    # divides by small second moments.
    cpu = torch.device("cpu")
    victim_cpu = create_model("tiny", device=cpu, seed=1)
    victim_dev = create_model("tiny", device=cuda, state_dict=victim_cpu.net.state_dict())
    cfg = core.AdilConfig(n_atoms=8, loss="logits")
    g = torch.Generator().manual_seed(2)
    images = torch.rand((6, 32, 32, 3), generator=g)
    state_cpu = core.init_state(g, (32, 32, 3), 6, cfg)
    state_dev = core.TrainState(**{k: (v.to(cuda) if torch.is_tensor(v) else v)
                                   for k, v in vars(state_cpu).items()})
    labels = core.predict_labels(victim_cpu, images)
    idx, mask = torch.tensor([3, 0, 5, 0]), torch.tensor([1.0, 1.0, 1.0, 0.0])
    before = fused_adamw_project.launches
    for state, victim, dev in ((state_cpu, victim_cpu, cpu), (state_dev, victim_dev, cuda)):
        step = core.make_train_step(victim, cfg, "both")
        for _ in range(3):
            step(state, images[idx].to(dev), labels[idx].to(dev), idx.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    assert fused_adamw_project.launches == before + 6  # d and v, three steps
    assert float((state_dev.d.cpu() - state_cpu.d).abs().max()) <= 1e-4
    assert float((state_dev.v.cpu() - state_cpu.v).abs().max()) <= 1e-4


def test_model_accuracy_on_the_card_matches_the_cpu(cuda):
    from dl_attack_on_imagenet_tpu_torch.evaluation import model_accuracy

    victim_cpu = create_model("tiny", device="cpu", seed=14)
    victim_dev = create_model("tiny", device=cuda, state_dict=victim_cpu.net.state_dict())
    g = torch.Generator().manual_seed(5)
    images = torch.rand((40, 32, 32, 3), generator=g).numpy()
    labels = victim_cpu.predict(torch.as_tensor(images)).numpy()
    labels[::3] = (labels[::3] + 1) % 10
    want = model_accuracy((images, labels), victim_cpu, batch_size=16)
    assert want == pytest.approx(26 / 40)
    assert abs(model_accuracy((images, labels), victim_dev, batch_size=16) - want) <= 1e-4


def test_run_experiment_on_the_card_matches_the_cpu(cuda, tmp_path):
    # The demo's experiment at tiny size (24 images in two classes, K=4)
    # from one saved dictionary: accuracy, fooling rates, RMSE and MSE
    # within 1e-4 (cuDNN sums in another order than the CPU over 10 DDrague
    # steps).
    import numpy as np

    from dl_attack_on_imagenet_tpu_torch.cli import demo
    from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    d = np.random.RandomState(0).uniform(-1.0, 1.0, (4, 32, 32, 3)).astype(np.float32)
    images = np.random.default_rng(14).random((24, 32, 32, 3), dtype=np.float32)
    victim_cpu = create_model("tiny", device="cpu", seed=2)
    labels = victim_cpu.predict(torch.as_tensor(images)).numpy()
    assert sorted(np.unique(labels)) == [2, 7]
    flip = np.where(labels == 2)[0][:2]
    labels[flip] = 7  # two misclassified rows, left out where they land in val or test
    results = {}
    for dev in ("cpu", cuda):
        victim = victim_cpu if dev == "cpu" else create_model(
            "tiny", device=dev, state_dict=victim_cpu.net.state_dict())
        root = str(tmp_path / str(dev))
        ArtifactCache(root).save({"d": d}, "ImageNet", model="tiny")
        args = demo.build_argparser().parse_args(
            ["--seed", "14", "--n-atoms", "4", "--steps-inference", "10", "--eps", "0.3",
             "--device", str(dev), "--dict-dir", root, "--results-dir", root])
        before = fused_perturb.launches
        results[str(dev)] = demo.run_experiment(victim, ArrayDataset(images, labels), 2,
                                                [4, 2, 2], "tiny", args)
    assert fused_perturb.launches - before == 2  # one a served batch: val and test
    got, want = results[str(cuda)], results["cpu"]
    assert want["accuracy"] == pytest.approx(22 / 24)
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-4
    for split in ("val", "test"):
        key = want[split]["group_key"]["adil"]
        for metric in ("fooling_rate", "rmse", "mse"):
            np.testing.assert_allclose(got[split][metric][key], want[split][metric][key],
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,size", [("densenet121", 32), ("mobilenet_v2", 32),
                                       ("googlenet", 32), ("inception_v3", 75),
                                       ("vgg11", 32), ("vit_tiny", 32), ("swin_tiny", 64)])
def test_victim_family_on_the_card_matches_the_cpu(cuda, name, size):
    # Logits and the CW-loss input gradient within 1e-4: cuDNN's depthwise,
    # grouped and padded-pool kernels sum in other orders than the CPU.
    victim_cpu = create_model(name, input_size=size, device="cpu", seed=1)
    victim_dev = create_model(name, input_size=size, device=cuda,
                              state_dict=victim_cpu.net.state_dict())
    x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([1, 3])
    out = []
    for victim, dev in ((victim_cpu, "cpu"), (victim_dev, cuda)):
        xt = x.to(dev).requires_grad_(True)
        logits = victim(xt)
        (grad,) = torch.autograd.grad(attack_loss(logits, labels.to(dev), loss="logits"), xt)
        out.append((logits.detach().cpu(), grad.cpu()))
    assert float((out[0][0] - out[1][0]).abs().max()) <= 1e-4
    assert float((out[0][1] - out[1][1]).abs().max()) <= 1e-4


@pytest.mark.parametrize("side", [2, 8, 17, 35])
def test_inception_average_pool_gradient_on_the_card(cuda, side):
    # Inception's padded 3x3 average pool on a channels_last tensor: its
    # backward runs the forward kernel, as PyTorch's own CUDA backward of
    # avg_pool2d with padding is wrong for channels_last.
    from dl_attack_on_imagenet_tpu_torch.models.inception import _avg_pool

    g = torch.Generator().manual_seed(side)
    x = torch.randn((2, 64, side, side), generator=g)
    grad_out = torch.randn((2, 64, side, side), generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xt = x.to(dev).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        (grad,) = torch.autograd.grad(_avg_pool(xt), xt, grad_out.to(dev))
        grads.append(grad.cpu())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-6


def _device_kernels(fn) -> list:
    """The names of the kernels, copies and memsets ``fn`` runs on the card,
    by ``torch.profiler``; fails where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() != torch.autograd.DeviceType.CPU and not e.is_user_annotation()]
    assert names, "the profiler saw no work on the card"
    return names


def test_fp32_victim_runs_no_layout_transposes_on_the_card(cuda):
    # An fp32 ResNet-50 in contiguous NCHW hands cuDNN the layout of its
    # fp32 kernels: a forward and input gradient at 224x224 launch none of
    # the nhwcToNchw / nchwToNhwc transposes that cuDNN wraps around each
    # fp32 convolution of channels_last tensors (the count of convolutions
    # the layout failed to reach). The same weights forced into
    # channels_last do launch them, and their logits agree within 1e-5 of
    # the largest; a bf16 victim's convolutions take channels_last tensors.
    from torch.overrides import TorchFunctionMode

    victim = create_model("resnet50", device=cuda, seed=0)
    x = torch.rand((8, 224, 224, 3), generator=torch.Generator().manual_seed(3)).to(cuda)
    out = {}

    def pass_():
        xt = x.clone().requires_grad_(True)
        logits = victim(xt)
        torch.autograd.grad(logits.square().sum(), xt)
        out[victim.memory_format] = logits.detach()

    def transposes(names):
        return [n for n in names if "nhwcToNchw" in n or "nchwToNhwc" in n]

    pass_()  # cuDNN's first uses outside the trace
    assert transposes(_device_kernels(pass_)) == []
    victim.net.to(memory_format=torch.channels_last)
    pass_()
    assert transposes(_device_kernels(pass_)), "channels_last fp32 ran no transposes"
    nchw, cl = out[torch.contiguous_format], out[torch.channels_last]
    assert float((nchw - cl).abs().max()) <= 1e-5 * float(cl.abs().max())

    class Convolutions(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.nn.functional.conv2d:
                inputs.append(args[0])
            return func(*args, **(kwargs or {}))

    inputs = []
    bf16 = create_model("resnet50", device=cuda, seed=0, dtype=torch.bfloat16)
    with torch.no_grad(), Convolutions():
        bf16(x)
    assert len(inputs) == 53
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous(memory_format=torch.channels_last)
               for t in inputs)


ULP = 2.0 ** -8  # one bf16 rounding, relative (tests/test_torch_port_mixed.py)


def test_bf16_products_accumulate_in_fp32(cuda):
    # The port's choice: a bf16 product on the card sums in fp32 and rounds
    # once, as XLA does; it refuses to run while cuBLAS may reduce split-K
    # partial sums in bf16. At DDrague's read-off (150528 terms a code) the
    # product is one rounding from the fp32 product of the bf16 operands
    # (2^-7 of it covers a rounding to either neighbour), plus the fp32
    # summation order (1e-5 of the sum of |terms|).
    g = torch.Generator(device=cuda).manual_seed(0)
    m = 224 * 224 * 3
    z = torch.rand((64, m), generator=g, device=cuda) * 0.06 - 0.03
    p = torch.randn((100, m), generator=g, device=cuda) * 1e-3
    v = torch.randn((64, 100), generator=g, device=cuda) * 0.01
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    with pytest.raises(RuntimeError, match="accumulate in fp32"):
        codes_from_pinv(z, p, torch.bfloat16)
    with pytest.raises(RuntimeError, match="accumulate in fp32"):
        dict_apply(v, p, torch.bfloat16)
    reduced = (z.bfloat16() @ p.bfloat16().T).float()  # what the refusal avoids
    matmul.allow_bf16_reduced_precision_reduction = False
    for got, a, b in ((codes_from_pinv(z, p, torch.bfloat16), z, p.T),
                      (dict_apply(v, p, torch.bfloat16), v, p)):
        assert got.dtype == torch.bfloat16
        a, b = a.bfloat16().float(), b.bfloat16().float()
        want = a @ b
        bound = 2 * ULP * want.abs() + 1e-5 * (a.abs() @ b.abs())
        assert bool(((got.float() - want).abs() <= bound).all())
    want = z.bfloat16().float() @ p.bfloat16().float().T
    print("codes_from_pinv in bf16: max error against the fp32 product with fp32 "
          f"accumulation {float((codes_from_pinv(z, p, torch.bfloat16).float() - want).abs().max()):.3e}, "
          f"with bf16 split-K reductions {float((reduced - want).abs().max()):.3e}")


def _bf16_pair(cuda):
    cpu = torch.device("cpu")
    victim_cpu = create_model("tiny", device=cpu, seed=1)
    victim_dev = create_model("tiny", device=cuda, state_dict=victim_cpu.net.state_dict())
    return (victim_cpu, cpu), (victim_dev, cuda)


def test_bf16_train_steps_on_the_card_match_the_cpu(cuda):
    # The fp32 test's 1e-4 (cuDNN's order) plus the bf16 bound of
    # tests/test_torch_port_mixed.py: cuBLAS and the CPU sum the bf16
    # products in other orders, and a sum on the other side of a rounding
    # boundary moves a value by 2^-8 of it: 2^-8 * lr * steps in D and v,
    # 2^-8 relative in the loss.
    cfg = core.AdilConfig(n_atoms=8, loss="logits", perturb_dtype="bfloat16")
    g = torch.Generator().manual_seed(2)
    images = torch.rand((6, 32, 32, 3), generator=g)
    state_cpu = core.init_state(g, (32, 32, 3), 6, cfg)
    state_dev = core.TrainState(**{k: (v.to(cuda) if torch.is_tensor(v) else v)
                                   for k, v in vars(state_cpu).items()})
    (victim_cpu, cpu), (victim_dev, _) = _bf16_pair(cuda)
    labels = core.predict_labels(victim_cpu, images)
    idx, mask = torch.tensor([3, 0, 5, 0]), torch.tensor([1.0, 1.0, 1.0, 0.0])
    before = fused_adamw_project.launches
    losses = []
    for state, victim, dev in ((state_cpu, victim_cpu, cpu), (state_dev, victim_dev, cuda)):
        step = core.make_train_step(victim, cfg, "both")
        losses.append([float(step(state, images[idx].to(dev), labels[idx].to(dev), idx.to(dev),
                                  mask.to(dev))[0]) for _ in range(3)])
    torch.cuda.synchronize()
    assert fused_adamw_project.launches == before + 6  # d and v, three steps, as in fp32
    tol = 1e-4 + ULP * cfg.step_size * 3
    assert float((state_dev.d.cpu() - state_cpu.d).abs().max()) <= tol
    assert float((state_dev.v.cpu() - state_cpu.v).abs().max()) <= tol
    np.testing.assert_allclose(losses[1], losses[0], rtol=ULP)
    assert state_dev.d.dtype == state_dev.v.dtype == torch.float32


@pytest.mark.parametrize("solver", ["supervised_ddrague", "supervised_adamw_codes"])
def test_bf16_solvers_on_the_card_match_the_cpu(cuda, solver):
    # 1e-4 (cuDNN's order, as the fp32 served path) plus the solvers' bf16
    # bound of tests/test_torch_port_mixed.py, 4 * 2^-8 * code_lr * steps.
    cfg = core.AdilConfig(n_atoms=8, loss="logits", steps_inference=5, steps_code=5,
                          perturb_dtype="bfloat16")
    g = torch.Generator().manual_seed(1)
    d = torch.rand((8, 32, 32, 3), generator=g) * 2 - 1
    x = torch.rand((4, 32, 32, 3), generator=g)
    (victim_cpu, _), (victim_dev, _) = _bf16_pair(cuda)
    before = fused_perturb.launches
    want = getattr(core, solver)(victim_cpu, d, x, cfg)
    got = getattr(core, solver)(victim_dev, d.to(cuda), x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert fused_perturb.launches == before + 1  # the fp32 read-off
    assert got.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) <= 1e-4 + 4 * ULP * cfg.code_lr * 5
    fp32 = getattr(core, solver)(victim_dev, d.to(cuda), x.to(cuda),
                                 dataclasses.replace(cfg, perturb_dtype="float32"))
    assert float((got - fp32).abs().max()) < 0.05


def test_dp_at_world_size_one_over_nccl_matches_the_replay(cuda):
    # One rank over NCCL: the all-reduces are copies, so the DP run and its
    # serial replay on the same plan agree within 1e-5 (the loss sums'
    # order); the sharded accuracy equals the unsharded one.
    import torch.distributed as dist

    from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
    from dl_attack_on_imagenet_tpu_torch.evaluation import model_accuracy, model_accuracy_sharded
    from dl_attack_on_imagenet_tpu_torch.parallel import (
        adil_dp, auto_initialize, check_mesh, data_mesh)
    from dl_attack_on_imagenet_tpu_torch.parallel import dist as port_dist

    auto_initialize(device="cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = data_mesh()
        assert check_mesh(mesh)["ok"]
        victim = create_model("tiny", device=cuda, seed=1)
        images = np.random.default_rng(0).random((10, 32, 32, 3), dtype=np.float32)
        labels = victim.predict(torch.as_tensor(images, device=cuda)).cpu().numpy()
        labels[::4] = (labels[::4] + 1) % 10
        data = ArrayDataset(images, labels)
        assert model_accuracy_sharded(data, victim, mesh, 4) == model_accuracy(data, victim)
        cfg = core.AdilConfig(n_atoms=8, batch_size=4, steps=2, loss="logits")
        before = fused_adamw_project.launches
        d, v, history = adil_dp.learn_dictionary_distributed(victim, data, cfg, mesh, seed=0)
        torch.cuda.synchronize()
        assert fused_adamw_project.launches - before == 2 * 2 * 3  # D and v, 2 epochs of 3
        state = adil_dp.init_dp_state(cuda, (32, 32, 3), 10, cfg, mesh, seed=0)
        rows = adil_dp.shard_rows(mesh, images)
        clean = core.predict_labels(victim, rows)
        plans, replay = adil_dp.plan_generator(0), adil_dp.make_dp_replay_epoch_fn(victim, cfg)
        for _ in range(2):
            plan = adil_dp.make_local_batches(plans, 10, 1, cfg.batch_size)
            replay(state, rows, clean, adil_dp.global_batches_from_local(plan, 10))
        assert float((d.reshape(8, -1) - state.d).abs().max()) <= 1e-5
        assert float((v - state.v).abs().max()) <= 1e-5
        assert len(history["loss"]) == 2
    finally:
        port_dist.shutdown()


def test_sharded_checkpoint_of_cuda_tensors_at_world_size_one(cuda, tmp_path):
    # One rank over NCCL: a plain CUDA tensor, a DTensor of CUDA rows and
    # CPU meta go through ArtifactCache.save_sharded and come back bit-equal
    # into the live tensors of a zeroed template.
    from torch.distributed.tensor import DTensor, Shard

    from dl_attack_on_imagenet_tpu_torch.parallel import auto_initialize, data_mesh
    from dl_attack_on_imagenet_tpu_torch.parallel import dist as port_dist
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    auto_initialize(device=cuda)
    try:
        mesh = data_mesh()
        g = torch.Generator(device=cuda).manual_seed(0)
        d = torch.randn((100, 3 * 32 * 32), generator=g, device=cuda)
        v = torch.randn((10, 100), generator=g, device=cuda)

        def tree(d, v, epoch):
            return {"d": d, "v": DTensor.from_local(v, mesh, [Shard(0)], run_check=False),
                    "meta": {"epoch": epoch, "rng": torch.Generator().manual_seed(3).get_state()}}

        cache = ArtifactCache(str(tmp_path))
        cache.save_sharded(tree(d, v, torch.tensor(5)), "ImageNet", model="tiny")
        d2, v2, epoch = torch.zeros_like(d), torch.zeros_like(v), torch.tensor(0)
        cache.load_sharded(tree(d2, v2, epoch), "ImageNet", model="tiny")
        assert d2.is_cuda and v2.is_cuda
        assert torch.equal(d2, d) and torch.equal(v2, v) and int(epoch) == 5
        cache.remove_sharded("ImageNet", model="tiny")
        assert not cache.exists_sharded("ImageNet", model="tiny")
    finally:
        port_dist.shutdown()


def _tiny_pair(cuda, seed=1):
    cpu = torch.device("cpu")
    victim_cpu = create_model("tiny", device=cpu, seed=seed)
    return victim_cpu, create_model("tiny", device=cuda, state_dict=victim_cpu.net.state_dict())


def test_deepfool_on_the_card_matches_the_cpu(cuda):
    # Iteration counts exact, perturbations within 1e-4 (cuDNN sums in
    # another order than the CPU, and each step divides by a gradient norm).
    from dl_attack_on_imagenet_tpu_torch.attacks import deepfool_batch

    victim_cpu, victim_dev = _tiny_pair(cuda)
    images = torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    active = torch.tensor([True, True, False, True, True, True, False, True])
    for mask in (None, active):
        r_cpu, it_cpu = deepfool_batch(victim_cpu, images, 10, 0.02, 10, active_init=mask)
        r_dev, it_dev = deepfool_batch(victim_dev, images.to(cuda), 10, 0.02, 10,
                                       active_init=None if mask is None else mask.to(cuda))
        assert r_dev.device == images.to(cuda).device and torch.equal(it_dev.cpu(), it_cpu)
        assert int(it_cpu.max()) > 1
        assert float((r_dev.cpu() - r_cpu).abs().max()) <= 1e-4


def test_uap_pgd_epoch_on_the_card_matches_the_cpu(cuda, tmp_path):
    # One l2 epoch of 3 Adam steps over one plan: e within 1e-5.
    from dl_attack_on_imagenet_tpu_torch.attacks import UAPPGD, uap_pgd
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    victim_cpu, victim_dev = _tiny_pair(cuda)
    g = torch.Generator().manual_seed(4)
    images = torch.rand((10, 32, 32, 3), generator=g)
    labels = victim_cpu.predict(images)
    plan = core.make_batches(g, 10, 4)
    out = []
    for victim, dev in ((victim_cpu, torch.device("cpu")), (victim_dev, cuda)):
        atk = UAPPGD(victim, steps=0, batch_size=4, norm="l2", eps=0.1,
                     cache=ArtifactCache(str(tmp_path)))
        e = torch.zeros((1, 32, 32, 3), device=dev, requires_grad=True)
        loss, _ = uap_pgd.make_uap_epoch_fn(victim, atk)(
            e, atk.make_optimizer([e]), images.to(dev), labels.to(dev), plan.to(dev))
        out.append((e.detach().cpu(), float(loss)))
    assert float((out[0][0] - out[1][0]).abs().max()) <= 1e-5
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-5)


def test_uap_pgd_dp_at_world_size_one_over_nccl_matches_the_replay(cuda, tmp_path):
    # One rank over NCCL, deterministic cuDNN: the DP epochs and their
    # serial replay on the same plans agree within 1e-6.
    from dl_attack_on_imagenet_tpu_torch.attacks import UAPPGD, uap_pgd
    from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp, auto_initialize, data_mesh
    from dl_attack_on_imagenet_tpu_torch.parallel import dist as port_dist
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    auto_initialize(device=cuda)
    try:
        mesh = data_mesh()
        victim = create_model("tiny", device=cuda, seed=1)
        images = np.random.default_rng(0).random((10, 32, 32, 3), dtype=np.float32)
        labels = victim.predict(torch.as_tensor(images, device=cuda)).cpu().numpy()
        kw = dict(batch_size=4, norm="l2", eps=0.5, seed=0, cache=ArtifactCache(str(tmp_path)))
        dp = UAPPGD(victim, data_train=(images, labels), steps=2, mesh=mesh, **kw)
        atk = UAPPGD(victim, steps=0, **kw)
        e = torch.zeros((1, 32, 32, 3), device=cuda, requires_grad=True)
        opt, plans = atk.make_optimizer([e]), adil_dp.plan_generator(0)
        epoch = uap_pgd.make_uap_dp_replay_epoch_fn(victim, atk, 1)
        x, y = torch.as_tensor(images, device=cuda), torch.as_tensor(labels, device=cuda)
        for _ in range(2):
            plan = adil_dp.global_batches_from_local(adil_dp.make_local_batches(plans, 10, 1, 4), 10)
            epoch(e, opt, x, y, torch.as_tensor(plan, device=cuda))
        assert float((dp.attack_vec - e.detach()).abs().max()) <= 1e-6
        assert len(dp.history["loss"]) == 2
    finally:
        port_dist.shutdown()
        torch.backends.cudnn.deterministic = old


@pytest.mark.parametrize("eps", [10 / 255, float("inf")])
def test_cuda_kernel_matches_plain_twin_at_adilr_shapes(cuda, eps):
    # ADILR's read-offs: K=10 atoms, a clamp at its budget and none.
    v, d, x = _inputs(cuda, 64, 10, 224 * 224 * 3, v_scale=0.1)
    before = fused_perturb.launches
    got = fused_perturb(v, d.reshape(10, 224, 224, 3), x.reshape(64, 224, 224, 3), eps)
    torch.cuda.synchronize()
    assert fused_perturb.launches == before + 1
    want = fused_perturb_reference(v, d, x, eps).reshape(got.shape)
    assert float((got - want).abs().max()) <= 1e-5
    if eps < 1:
        assert float((got - x.reshape(got.shape)).abs().max()) <= eps + 1e-6


def test_adamw_kernel_without_clamp_is_torch_adamw(cuda):
    # clip_val=inf at ADILR's D size: three steps against torch.optim.AdamW
    # (weight decay 1e-2, its own order of operations), within 1e-6.
    n = 10 * 224 * 224 * 3
    g = torch.Generator(device=cuda).manual_seed(5)
    p = torch.rand((n,), generator=g, device=cuda) * 2 - 1
    ref = p.clone().requires_grad_(True)
    opt = torch.optim.AdamW([ref], lr=0.01, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    for step in (1, 2, 3):
        grad = torch.randn((n,), generator=g, device=cuda)
        fused_adamw_project(p, grad, mu, nu, step, 0.01, float("inf"))
        ref.grad = grad.clone()
        opt.step()
    torch.cuda.synchronize()
    assert float((p - ref.detach()).abs().max()) <= 1e-6


def _adilr_pair(cuda, tmp_path, **kw):
    """The tiny victim on the CPU and on the card, each with an ADILR over
    one saved artifact (K=4 atoms on 32x32 images)."""
    from dl_attack_on_imagenet_tpu_torch.attacks import ADILR
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    victim_cpu, victim_dev = _tiny_pair(cuda, seed=3)
    rng = np.random.default_rng(2)
    train = rng.random((12, 32, 32, 3), dtype=np.float32)
    labels = victim_cpu.predict(torch.as_tensor(train)).numpy()
    cache = ArtifactCache(str(tmp_path))
    cache.save({"d": rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32),
                "v": rng.laplace(0.3, 0.5, (12, 4)).astype(np.float32),
                "loss": np.zeros(2, np.float32), "labels": labels.astype(np.int32)},
               "ADILR", model="tiny", lam1=1e-3, lam2=0.1, atoms=4, steps=100,
               tag="param_selecting")
    return [ADILR(victim, n_atoms=4, trials=6, lambda_l1=1e-3, cache=cache,
                  data_train=(train, labels), **kw) for victim in (victim_cpu, victim_dev)]


def test_adilr_forwards_on_the_card_match_the_cpu(cuda, tmp_path):
    # Supervised: the codes solver and one fused_perturb at the budget,
    # within 1e-4 of the CPU; unsupervised with the same draws, one launch a
    # trial, within 1e-5.
    x = torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(6))
    on_cpu, on_dev = _adilr_pair(cuda, tmp_path, attack="unsupervised")
    labels = on_cpu.victim.predict(x)
    draws = torch.randn((6, 8, 4), generator=torch.Generator().manual_seed(7)) * 0.5
    for mode in on_cpu.CONDITIONING:
        outs = []
        for atk, dev in ((on_cpu, torch.device("cpu")), (on_dev, cuda)):
            before = fused_perturb.launches
            if mode in ("labels_atoms", "predictions_atoms"):
                adv = atk.forward_unsupervised_conditioned_target_atoms(
                    x.to(dev), labels.to(dev), None, mode.split("_")[0], draws=draws.to(dev))
            elif mode == "atoms":
                adv = atk.forward_unsupervised_conditioned_atoms(x.to(dev), None,
                                                                 draws=draws.to(dev))
            else:
                adv = atk.forward_unsupervised(x.to(dev), None, draws=draws.to(dev))
            outs.append(adv.cpu())
        assert fused_perturb.launches == before + 6
        assert float((outs[0] - outs[1]).abs().max()) <= 1e-5
    for atk in (on_cpu, on_dev):
        atk.attack_mode = "supervised"
    before = fused_perturb.launches
    adv_dev = on_dev(x.to(cuda), labels.to(cuda))
    assert fused_perturb.launches == before + 1
    adv_cpu = on_cpu(x, labels)
    assert on_dev.stats == on_cpu.stats
    assert float((adv_dev.cpu() - adv_cpu).abs().max()) <= 1e-4
    assert float((adv_dev.cpu() - x).abs().max()) <= 10 / 255 + 1e-5


def test_adilr_adamw_batches_on_the_card_match_the_cpu(cuda):
    # Two batches of the AdamW trainer: two fused_adamw_project launches a
    # batch, D and v within 1e-4 of the CPU.
    from dl_attack_on_imagenet_tpu_torch.attacks import RegularizedConfig, adil_regularized

    victim_cpu, victim_dev = _tiny_pair(cuda, seed=3)
    rng = np.random.default_rng(4)
    x = rng.random((8, 32, 32, 3), dtype=np.float32)
    d0 = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    v0 = (rng.random((8, 4)) * 0.1).astype(np.float32)
    cfg = RegularizedConfig(n_atoms=4, batch_size=4, targeted=False, lambda_l2=0.5)
    out = []
    for victim, dev in ((victim_cpu, torch.device("cpu")), (victim_dev, cuda)):
        before = fused_adamw_project.launches
        d, v, losses, _, _ = adil_regularized.adilr_adamw(
            victim, torch.as_tensor(x, device=dev), cfg, nepochs=1, shuffle=False,
            d_init=d0, v_init=v0)
        out.append((d.cpu(), v.cpu(), losses))
    assert fused_adamw_project.launches == before + 4
    assert float((out[0][0] - out[1][0]).abs().max()) <= 1e-4
    assert float((out[0][1] - out[1][1]).abs().max()) <= 1e-4
    assert out[1][2] == pytest.approx(out[0][2], rel=1e-4)


@pytest.mark.parametrize("family", ["pgd", "difgsm", "cw", "apgdt", "fab", "square",
                                    "one_pixel"])
def test_grid_family_on_the_card_matches_the_cpu(cuda, family):
    # The same host draws on both sides, deterministic cuDNN: adversaries
    # within 1e-4 and every decision equal (APGD-T's step sizes after each
    # checkpoint, FAB's found flags and chosen candidates, Square's queries
    # and accepts, OnePixel's generations and accepts).
    from chip_smoke import _deterministic_cudnn, _same_decisions, grid_family_run

    victim_cpu, victim_dev = _tiny_pair(cuda)
    images = torch.rand((8, 32, 32, 3), generator=torch.Generator().manual_seed(5))
    labels = victim_cpu.predict(images)
    with _deterministic_cudnn():
        adv_cpu, stats_cpu = grid_family_run(family, victim_cpu, images, labels)
        adv_dev, stats_dev = grid_family_run(family, victim_dev, images.to(cuda),
                                             labels.to(cuda))
    assert stats_dev.keys() == stats_cpu.keys()
    for key in stats_cpu:
        assert _same_decisions(stats_dev[key], stats_cpu[key]), key
    assert float((adv_dev - adv_cpu).abs().max()) <= 1e-4


def test_one_pixel_paints_duplicate_coordinates_in_order_on_the_card(cuda):
    # A later pixel wins a duplicate coordinate on the card as on the CPU.
    from dl_attack_on_imagenet_tpu_torch.attacks.one_pixel import _apply_candidate

    g = torch.Generator().manual_seed(2)
    images = torch.rand((64, 8, 8, 3), generator=g)
    cands = torch.cat([torch.rand((64, 4, 2), generator=g) * 8,
                       torch.rand((64, 4, 3), generator=g)], -1)
    cands[:, 2, :2] = cands[:, 0, :2]
    cands[:, 3, :2] = cands[:, 0, :2]
    got = _apply_candidate(images.to(cuda), cands.to(cuda)).cpu()
    want = _apply_candidate(images, cands)
    assert torch.equal(got, want)
    rows, cols = cands[:, 0, 0].long(), cands[:, 0, 1].long()
    assert torch.equal(got[torch.arange(64), rows, cols], cands[:, 3, 2:])


@pytest.mark.parametrize("name", ["resnet18", "densenet121", "googlenet"])
def test_s2d_stem_on_the_card_matches_the_cpu_and_the_plain_stem(cuda, name):
    # The space-to-depth stem's 4x4 convolution over 12 channels in cuDNN:
    # logits and the CW input gradient within 1e-4 of the CPU's and of the
    # plain stem's on the card.
    victim_cpu = create_model(name, input_size=32, device="cpu", seed=1, stem_s2d=True)
    state_dict = victim_cpu.net.state_dict()
    s2d = create_model(name, input_size=32, device=cuda, state_dict=state_dict, stem_s2d=True)
    plain = create_model(name, input_size=32, device=cuda, state_dict=state_dict)
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([1, 3])
    out = []
    for victim, dev in ((victim_cpu, "cpu"), (s2d, cuda), (plain, cuda)):
        xt = x.to(dev).requires_grad_(True)
        logits = victim(xt)
        (grad,) = torch.autograd.grad(attack_loss(logits, labels.to(dev), loss="logits"), xt)
        out.append((logits.detach().cpu(), grad.cpu()))
    for other in (out[0], out[2]):
        assert float((out[1][0] - other[0]).abs().max()) <= 1e-4
        assert float((out[1][1] - other[1]).abs().max()) <= 1e-4


def test_pipelined_s2d_learning_on_the_card_equals_the_serial(cuda, tmp_path):
    # ADIL on a ResNet-18 with an S2D stem, in the standard layout: the
    # pipelined epochs equal the serial ones under deterministic cuDNN.
    from chip_smoke import _deterministic_cudnn
    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    victim = create_model("resnet18", input_size=32, device=cuda, seed=1, stem_s2d=True)
    data = (np.random.default_rng(0).random((12, 32, 32, 3), dtype=np.float32), np.zeros(12))
    runs = []
    with _deterministic_cudnn():
        for pipeline in (True, False):
            attack = ADIL(victim, n_atoms=8, batch_size=4, steps=3, loss="logits", data_train=data,
                          cache=ArtifactCache(str(tmp_path / str(pipeline))),
                          pipeline_epochs=pipeline)
            runs.append(attack)
    assert runs[0].history["loss"] == runs[1].history["loss"]
    assert float((runs[0].dictionary - runs[1].dictionary).abs().max()) <= 1e-5


def test_generate_on_the_card_matches_the_cpu(cuda, tmp_path):
    # cli.generate on a blob with the tiny victim: the same rows, fooling
    # counts, and mse within 5e-5 relative (tests/test_torch_port_generate.py).
    import json

    from dl_attack_on_imagenet_tpu_torch.cli import dataset, generate
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

    images = np.random.default_rng(1).random((10, 32, 32, 3), dtype=np.float32)
    dataset.save_blob(str(tmp_path / "b.npz"), images, np.zeros(10), ["a"])
    d = np.random.default_rng(2).uniform(-1, 1, (100, 32, 32, 3)).astype(np.float32)
    ArtifactCache(str(tmp_path / "dicts")).save({"d": d}, "ImageNet", model="tiny")
    # Random weights are drawn on the device's generator: both runs load one set.
    torch.save(create_model("tiny", device="cpu", seed=0).net.state_dict(), tmp_path / "w.pt")
    reports = []
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        generate.main(generate.build_argparser().parse_args([
            "--model", "tiny", "--blob", str(tmp_path / "b.npz"), "--dict-dir",
            str(tmp_path / "dicts"), "--batch-size", "6", "--steps-inference", "3",
            "--weights", str(tmp_path / "w.pt"), "--device", dev, "--out-dir", str(out)]))
        with open(out / "report.jsonl") as f:
            reports.append([json.loads(line) for line in f])
    cpu, card = reports
    assert [(r["step"], r["n"], r["fooling"]) for r in card] == \
        [(r["step"], r["n"], r["fooling"]) for r in cpu]
    np.testing.assert_allclose([r["mse"] for r in card], [r["mse"] for r in cpu], rtol=5e-5)


_SWIN_TOP = ("victim/swin/embed", "victim/swin/attention", "victim/swin/mlp", "victim/swin/merge",
             "victim/swin/head")


def test_swin_spans_cover_a_pass_on_the_card(cuda):
    # One Swin-B forward and input gradient at batch 8, traced: the device
    # seconds of the victim's top-level spans (the stem, each block's
    # attention and MLP halves, the merges, the head), forward and
    # backward, add up to within 5% of the pass's device time between CUDA
    # events around it. A sleep kernel first holds the card while the host
    # queues the pass, so that the host's time between spans is not idle
    # time of the card.
    from torch.profiler import ProfilerActivity, profile

    from dl_attack_on_imagenet_tpu_torch.utils import profiling

    victim = create_model("swin_b", device=cuda, seed=0)
    x = torch.rand((8, 224, 224, 3), generator=torch.Generator().manual_seed(3)).to(cuda)

    def pass_():
        xt = x.clone().requires_grad_(True)
        torch.autograd.grad(victim(xt).square().sum(), xt)

    pass_()  # first uses outside the count
    torch.cuda.synchronize()
    profiling.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda._sleep(200_000_000)
            start.record()
            pass_()
            end.record()
            torch.cuda.synchronize()
        whole = start.elapsed_time(end) / 1e3
        totals = profiling.device_totals()
    finally:
        profiling.reset()
    # The shift is the kernel's indexing on the card: no span of its own.
    assert totals["victim/swin/attention"].count == 24 and "victim/swin/shift" not in totals
    assert totals["victim/swin/merge"].count == 3
    covered = sum(totals[n].forward_s + totals[n].backward_s for n in _SWIN_TOP)
    shares = {n: (t.forward_s + t.backward_s) / whole for n, t in totals.items()}
    print(f"swin_b b8: pass {whole * 1e3:.3f} ms, top-level spans {covered * 1e3:.3f} ms; "
          f"shares {shares}")
    assert all(t.backward_s > 0 for t in totals.values())
    assert abs(covered - whole) <= 0.05 * whole


@pytest.mark.parametrize("name", ["vit_b16", "swin_b"])
def test_a_ddrague_batch_reads_as_often_on_swin_as_on_vit(cuda, tmp_path, name):
    # A DDrague call of 30 steps at 224x224 reads the card 31 times on either
    # victim: D's pseudo-inverse once, each step's max |dz| once.
    from torch.profiler import ProfilerActivity, profile

    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache, profiling

    victim = create_model(name, device=cuda, seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    cache = ArtifactCache(str(tmp_path))
    cache.save({"d": torch.rand((100, 224, 224, 3), generator=g, device=cuda) * 2 - 1},
               "ImageNet", model=name)
    attack = ADIL(victim, n_atoms=100, batch_size=4, cache=cache, model_name=name,
                  loss="logits", steps_inference=30)
    x = torch.rand((4, 224, 224, 3), generator=g, device=cuda)
    labels = torch.zeros(4, dtype=torch.long, device=cuda)
    attack(x, labels)  # the first call's first uses outside the count
    torch.cuda.synchronize()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            attack(x, labels)
        syncs = {n: t.count for n, t in profiling.totals().items() if n.startswith("sync/")}
    finally:
        profiling.reset()
    assert syncs == {"sync/dict_pinv": 1, "sync/step_delta": 30}


# Swin-B's stages at 224²: (map side, channels, heads, shift); the fourth
# stage's 7x7 map is one window, so none of its blocks is shifted.
_SWIN_B_STAGES = [(56, 128, 4, 0), (56, 128, 4, 3), (28, 256, 8, 0), (28, 256, 8, 3),
                  (14, 512, 16, 0), (14, 512, 16, 3), (7, 1024, 32, 0)]


@pytest.mark.parametrize("table_scale", [1.0, 10.0])
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("side,channels,heads,shift", _SWIN_B_STAGES)
def test_swin_window_attention_matches_its_twin_on_the_card(cuda, side, channels, heads, shift,
                                                            batch, table_scale):
    # The table drawn as the victim's init, N(0, 0.02), and at 10x that; q,
    # k and v of unit scale. Output within 1e-5 of its largest value, and
    # the gradients of q, k and v each within 1e-4 in relative l2: the kernel
    # and the twin's cuBLAS products sum in other orders.
    from dl_attack_on_imagenet_tpu_torch.models.swin import window_attention_reference
    from dl_attack_on_imagenet_tpu_torch.ops.kernels import swin_window_attention

    g = torch.Generator(device=cuda).manual_seed(side + shift + batch)
    qkv = torch.randn((batch, side, side, 3 * channels), generator=g, device=cuda)
    table = torch.randn((13 * 13, heads), generator=g, device=cuda) * 0.02 * table_scale
    grad_out = torch.randn((batch, side, side, channels), generator=g, device=cuda)
    before = (swin_window_attention.launches, swin_window_attention.backward_launches)
    results = []
    for fn in (swin_window_attention, window_attention_reference):
        x = qkv.clone().requires_grad_(True)
        out = fn(x, table, 7, shift, shift, heads)
        (grad,) = torch.autograd.grad(out, x, grad_out)
        results.append((out.detach(), grad))
    torch.cuda.synchronize()
    assert (swin_window_attention.launches, swin_window_attention.backward_launches) == (
        before[0] + 1, before[1] + 1)
    (out, grad), (want, want_grad) = results
    out_err = float((out - want).abs().max() / want.abs().max())
    grad_errs = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
                 for a, b in zip(grad.chunk(3, dim=-1), want_grad.chunk(3, dim=-1))]
    assert out_err <= 1e-5 and max(grad_errs) <= 1e-4, (out_err, grad_errs)


@pytest.mark.parametrize("name,size,blocks", [("swin_b", 224, 24), ("swin_tiny", 64, 6)])
def test_every_swin_block_launches_the_kernel_on_the_card(cuda, name, size, blocks):
    # A forward and input gradient launches one forward and one backward a
    # block; a forward without autograd, one forward a block.
    from dl_attack_on_imagenet_tpu_torch.ops.kernels import swin_window_attention

    victim = create_model(name, device=cuda, seed=0)
    x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(4)).to(cuda)
    counts = lambda: (swin_window_attention.launches, swin_window_attention.backward_launches)
    before = counts()
    xt = x.clone().requires_grad_(True)
    torch.autograd.grad(victim(xt).square().sum(), xt)
    torch.cuda.synchronize()
    assert counts() == (before[0] + blocks, before[1] + blocks)
    with torch.no_grad():
        victim(x)
    assert counts() == (before[0] + 2 * blocks, before[1] + blocks)


def test_swin_window_attention_takes_an_empty_batch_on_the_card(cuda):
    from dl_attack_on_imagenet_tpu_torch.ops.kernels import swin_window_attention

    qkv = torch.zeros((0, 14, 14, 3 * 512), device=cuda, requires_grad=True)
    table = torch.zeros((13 * 13, 16), device=cuda)
    counts = lambda: (swin_window_attention.launches, swin_window_attention.backward_launches)
    before = counts()
    out = swin_window_attention(qkv, table, 7, 3, 3, 16)
    (grad,) = torch.autograd.grad(out.sum(), qkv)
    assert out.shape == (0, 14, 14, 512) and grad.shape == qkv.shape
    assert counts() == before
