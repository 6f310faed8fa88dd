"""The port's CUDA kernels on the card: fused_perturb against its plain twin
(atol 1e-5: the kernel and cuBLAS sum the K products in other orders),
fused_adamw_project against its twin (p and mu within 1e-6, nu within 1e-6
relative: elementwise fp32 in the twin's order), their launch counts, the
wrappers' refusals, and three training steps on the card against the CPU.
Every test here needs a GPU and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_cuda.py
"""

import pytest
import torch

from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.ops import kernels, native
from dl_attack_on_imagenet_tpu_torch.ops import (
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
    # True fp32 in matmuls and in cuDNN convolutions, as chip_smoke.py runs.
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


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
