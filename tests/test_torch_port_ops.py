"""Port ops against their JAX twins: projections, dictionary contractions,
losses and metrics, in float32 at atol 1e-6 unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu import ops as jops
from dl_attack_on_imagenet_tpu.evaluation import metrics as jmetrics
from dl_attack_on_imagenet_tpu_torch import ops
from dl_attack_on_imagenet_tpu_torch.evaluation import metrics

from _torch_port import t, victim_pair

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.fixture()
def rs():
    return np.random.RandomState(0)


def test_clamps(rs):
    x = rs.normal(0.5, 1.0, (3, 4, 4, 3)).astype(np.float32)
    _close(ops.clamp_image(t(x)), jops.clamp_image(jnp.asarray(x)))
    _close(ops.clamp_image(t(x), -0.2, 0.7), jops.clamp_image(jnp.asarray(x), -0.2, 0.7))
    _close(ops.linf_clamp(t(x), 0.03), jops.linf_clamp(jnp.asarray(x), 0.03))


@pytest.mark.parametrize("shape,eps", [((6, 10), 0.5), ((6, 10), 50.0),
                                        ((2, 3, 17), 0.1), ((5, 100), 8 / 255)])
def test_l1_ball_project(rs, shape, eps):
    x = rs.normal(0.0, 1.0, shape).astype(np.float32)
    got = ops.l1_ball_project(t(x), eps)
    _close(got, jops.l1_ball_project(jnp.asarray(x), eps))
    assert float(got.reshape(-1, shape[-1]).abs().sum(1).max()) <= eps + 1e-5


@pytest.mark.parametrize("radius,axis", [(1.0, None), (0.5, 1), (float("inf"), 1),
                                         (2.0, (1, 2))])
def test_l2_ball_project(rs, radius, axis):
    x = rs.normal(0.0, 1.0, (4, 5, 3)).astype(np.float32)
    if axis == 1:
        x = x.reshape(4, 15)
    _close(ops.l2_ball_project(t(x), radius, axis),
           jops.l2_ball_project(jnp.asarray(x), radius, axis))


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_project_codes_and_dictionary(rs, norm):
    v = rs.uniform(0.0, 1.0, (6, 12)).astype(np.float32)
    _close(ops.project_codes(t(v), 0.1, norm), jops.project_codes(jnp.asarray(v), 0.1, norm))
    d = rs.normal(0.0, 1.0, (5, 4, 4, 3)).astype(np.float32)
    _close(ops.project_dictionary(t(d), norm), jops.project_dictionary(jnp.asarray(d), norm))
    with pytest.raises(ValueError):
        ops.project_codes(t(v), 0.1, "l3")


@pytest.mark.parametrize("flat", [False, True])
def test_dict_apply_gram_pinv_codes(rs, flat):
    k, n = 8, 3
    d = rs.uniform(-1.0, 1.0, (k, 8, 8, 3)).astype(np.float32)
    if flat:
        d = d.reshape(k, -1)
    v = rs.normal(0.0, 0.1, (n, k)).astype(np.float32)
    _close(ops.dict_apply(t(v), t(d)), jops.dict_apply(jnp.asarray(v), jnp.asarray(d)))
    _close(ops.dict_gram(t(d)), jops.dict_gram(jnp.asarray(d)), atol=1e-4)  # entries ~ M/3
    pinv = ops.dict_pinv(t(d))
    _close(pinv, jops.dict_pinv(jnp.asarray(d)))
    _close(ops.dict_pinv(t(d), ridge=0.5), jops.dict_pinv(jnp.asarray(d), ridge=0.5))
    z = rs.uniform(-0.03, 0.03, (n,) + d.shape[1:]).astype(np.float32)
    jpinv = jops.dict_pinv(jnp.asarray(d))
    _close(ops.codes_from_pinv(t(z), t(np.asarray(jpinv))),
           jops.codes_from_pinv(jnp.asarray(z), jpinv))


@pytest.mark.parametrize("targeted", [False, True])
@pytest.mark.parametrize("negative", [False, True])
def test_cw_margin_loss_and_gradient(rs, targeted, negative):
    import jax

    logits = rs.normal(0.0, 3.0, (6, 10)).astype(np.float32)
    if negative:  # the runner-up is floored at zero
        logits = -np.abs(logits) - 0.1
    labels = rs.randint(0, 10, 6)
    jl = lambda lg: jops.cw_margin_loss(lg, jnp.asarray(labels), kappa=5.0, targeted=targeted)
    lt = t(logits).requires_grad_(True)
    got = ops.cw_margin_loss(lt, torch.as_tensor(labels), kappa=5.0, targeted=targeted)
    _close(got, jl(jnp.asarray(logits)))
    (g,) = torch.autograd.grad(got.sum(), lt)
    _close(g, jax.grad(lambda lg: jnp.sum(jl(lg)))(jnp.asarray(logits)))


@pytest.mark.parametrize("loss", ["ce", "logits"])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("targeted", [False, True])
def test_attack_loss(rs, loss, reduction, targeted):
    logits = rs.normal(0.0, 2.0, (5, 7)).astype(np.float32)
    labels = rs.randint(0, 7, 5)
    got = ops.attack_loss(t(logits), torch.as_tensor(labels), loss=loss,
                          targeted=targeted, kappa=3.0, reduction=reduction)
    want = jops.attack_loss(jnp.asarray(logits), jnp.asarray(labels), loss=loss,
                            targeted=targeted, kappa=3.0, reduction=reduction)
    _close(got, want, atol=1e-5)
    _close(ops.cross_entropy_sum(t(logits), torch.as_tensor(labels)),
           jops.cross_entropy_sum(jnp.asarray(logits), jnp.asarray(labels)), atol=1e-5)
    _close(ops.cross_entropy_mean(t(logits), torch.as_tensor(labels)),
           jops.cross_entropy_mean(jnp.asarray(logits), jnp.asarray(labels)))
    with pytest.raises(ValueError):
        ops.attack_loss(t(logits), torch.as_tensor(labels), loss="hinge")


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_fooling_rate(rs, reduction):
    jv, _, pv = victim_pair("tiny")
    clean = rs.uniform(0.0, 1.0, (8, 32, 32, 3)).astype(np.float32)
    adv = np.clip(clean + rs.uniform(-0.5, 0.5, clean.shape), 0, 1).astype(np.float32)
    want = jmetrics.compute_fooling_rate(jv, adv, clean, reduction)
    assert metrics.compute_fooling_rate(pv, t(adv), t(clean), reduction) == pytest.approx(want)
    # A random victim gives every image one label, so given clean labels
    # decide which images count as fooled: three of the eight here.
    labels = pv.predict(t(clean)).numpy()
    labels[[1, 4, 6]] = (labels[[1, 4, 6]] + 1) % pv.num_classes
    want = jmetrics.compute_fooling_rate(jv, adv, None, reduction, clean_labels=labels)
    assert want == pytest.approx(3 if reduction == "sum" else 3 / 8)
    assert metrics.compute_fooling_rate(pv, t(adv), None, reduction,
                                        clean_labels=torch.as_tensor(labels)) == pytest.approx(want)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_rmse_and_mse(rs, reduction):
    clean = rs.uniform(0.0, 1.0, (4, 6, 6, 3)).astype(np.float32)
    adv = np.clip(clean + rs.uniform(-0.03, 0.03, clean.shape), 0, 1).astype(np.float32)
    assert metrics.compute_rmse(t(adv), t(clean), reduction) == pytest.approx(
        jmetrics.compute_rmse(adv, clean, reduction), rel=1e-5)
    assert metrics.compute_mse(t(adv), t(clean), reduction) == pytest.approx(
        jmetrics.compute_mse(adv, clean, reduction), rel=1e-5)
