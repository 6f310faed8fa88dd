"""The port's ADILR against the JAX package's, on the tiny victim.

The ops only ADILR uses (the soft threshold, the bisection l1 projection,
the l2 sphere, the per-atom constraints) and the Laplace fits hold at 1e-6;
the median of an even count is the midpoint of the two middle values, as
``jnp.median`` takes it. The prox solvers hold their trajectories in
float64 within 1e-8, both sides from the same start, with equal numbers of
victim forwards (each line-search candidate is one, so equal counts mean
equal iterations and accept decisions); the JAX side counts them with
``jax.debug.callback``. In float32, ``sadil`` and ``adilr_adamw`` over the
JAX package's permutations hold v and the losses within 1e-5 and D within
2e-3 x lr: AdamW's first steps turn a near-zero gradient's sign into a full
lr step, so the two frameworks' ~1e-11 backward differences reach D at
that size (the bound of the port's training-step tests). Best-of-trials
takes the JAX draws and holds every conditioning mode within 1e-6. The
harness learns an untrained ADILR lazily on the kept rows: fooling counts
exact, RMSE and MSE within 5e-5 relative (the harness tests' bound and
reason).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu import evaluation as jev
from dl_attack_on_imagenet_tpu.attacks import ADILR as JaxADILR
from dl_attack_on_imagenet_tpu.attacks import adil_regularized as jr
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.ops import laplace as jlap
from dl_attack_on_imagenet_tpu.ops import projections as jproj
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch import evaluation as ev
from dl_attack_on_imagenet_tpu_torch import ops
from dl_attack_on_imagenet_tpu_torch.attacks import ADILR, RegularizedConfig
from dl_attack_on_imagenet_tpu_torch.attacks import adil_regularized as pr
from dl_attack_on_imagenet_tpu_torch.ops import kernels
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import t, victim_pair

N, K, SIZE = 8, 4, 32
RTOL = 5e-5


@pytest.fixture(scope="module")
def setup():
    jv, _, pv = victim_pair("tiny", key=7)
    rng = np.random.default_rng(5)
    x = rng.random((N, SIZE, SIZE, 3), dtype=np.float32)
    d0 = (rng.random((K, SIZE, SIZE, 3), dtype=np.float32) * 2 - 1) * 0.1
    return jv, pv, x, d0


@pytest.fixture(scope="module")
def f64(setup):
    """Both victims in float64 with one set of weights, each counting its
    forwards: the JAX one by a debug callback, the port's by a wrapper
    around a ``.double()`` copy of its net (``VictimModel`` casts to fp32)."""
    jv, pv, x, _ = setup
    jax_calls, port_calls = [], []
    with jax.enable_x64(True):
        vars64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv.variables)
        jv64 = jax_create_model("tiny", dtype=jnp.float64, variables=vars64)
        labels = np.array(jnp.argmax(jv64.apply_fn(vars64, jnp.asarray(x, jnp.float64)), -1))

    def jax_apply(variables, z):
        jax.debug.callback(lambda: jax_calls.append(1))
        return jv64.apply_fn(variables, z)

    net = copy.deepcopy(pv.net).double()

    def port_apply(z):
        port_calls.append(1)
        return net(z.permute(0, 3, 1, 2))

    return dict(jax_apply=jax_apply, vars=vars64, port_apply=port_apply,
                jax_calls=jax_calls, port_calls=port_calls, labels=labels)


def _forwards(f64):
    """(JAX forwards, port forwards) since the last call; resets both."""
    jax.effects_barrier()
    counts = len(f64["jax_calls"]), len(f64["port_calls"])
    f64["jax_calls"].clear()
    f64["port_calls"].clear()
    return counts


def _d64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# -- ops ------------------------------------------------------------------


def test_soft_threshold_and_l2_sphere_match_jax():
    rs = np.random.RandomState(0)
    x = rs.normal(size=(6, 50)).astype(np.float32)
    lam = np.float32(0.3)
    np.testing.assert_allclose(ops.soft_threshold(t(x), torch.tensor(lam)).numpy(),
                               np.asarray(jproj.soft_threshold(x, lam)), atol=1e-6)
    for axis in (None, 1):
        np.testing.assert_allclose(ops.l2_sphere_project(t(x), 2.0, axis=axis).numpy(),
                                   np.asarray(jproj.l2_sphere_project(x, 2.0, axis=axis)),
                                   atol=1e-6)


def test_l1_bisection_matches_jax_on_rows_over_4096_wide():
    rs = np.random.RandomState(1)
    x = rs.normal(size=(3, 5000)).astype(np.float32) * 0.01
    x[0] *= 1e-3  # inside the ball: left as it is
    got = ops.l1_ball_project_bisect(t(x), 1.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jproj.l1_ball_project_bisect(x, 1.0)), atol=1e-6)
    np.testing.assert_array_equal(got[0], x[0])
    np.testing.assert_allclose(np.abs(got[1:]).sum(1), 1.0, atol=1e-4)


@pytest.mark.parametrize("constraint,shape", [
    ("l2ball", (3, 8, 8, 3)), ("l2sphere", (3, 8, 8, 3)),
    ("l1ball", (2, 8, 8, 3)),    # per (atom, channel) plane, by the sort
    ("l1ball", (2, 70, 70, 3)),  # 4900 columns a plane: by bisection
    ("l1ball", (2, 5000)),       # flat D: whole rows
])
def test_project_atoms_matches_jax(constraint, shape):
    d = np.random.RandomState(2).normal(size=shape).astype(np.float32) * 0.05
    got = ops.project_atoms(t(d), constraint).numpy()
    np.testing.assert_allclose(got, np.asarray(jproj.project_atoms(d, constraint)), atol=1e-6)
    if constraint == "l1ball" and len(shape) == 4:
        planes = np.abs(got).transpose(0, 3, 1, 2).reshape(shape[0] * 3, -1).sum(1)
        assert planes.max() <= 1.0 + 1e-4


@pytest.mark.parametrize("rows", [7, 8])  # odd and even: the median's midpoint
def test_laplace_fits_match_jax(rows):
    rs = np.random.RandomState(rows)
    v = rs.laplace(0.1, 0.5, size=(rows, 5)).astype(np.float32)
    v[:, 4] = 0.0  # a constant column: the scale floor
    for port_fit, jax_fit in ((ops.laplace_fit, jlap.laplace_fit),
                              (ops.laplace_fit_per_atom, jlap.laplace_fit_per_atom)):
        for got, want in zip(port_fit(t(v)), jax_fit(jnp.asarray(v))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    col = v[:, 0]
    assert float(ops.laplace_fit_per_atom(t(v))[0][0]) == pytest.approx(np.median(col), abs=1e-7)


def test_conditioned_fit_is_the_jax_one():
    rs = np.random.RandomState(3)
    v = rs.laplace(size=(40, 6)).astype(np.float32)
    groups = rs.randint(-1, 9, size=40)  # -1 and 8 lie outside 8 groups; some are empty
    got = ops.laplace_fit_conditioned(v, groups, 8)
    for g, w, direct in zip(got, jlap.laplace_fit_conditioned(v, groups, 8),
                            ops.laplace_fit_conditioned_direct(v, groups, 8)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, direct, atol=1e-6)


def test_laplace_sample_is_the_inverse_cdf_of_its_uniforms():
    loc, scale = torch.tensor([0.0, 1.0]), torch.tensor([1.0, 0.1])
    got = ops.laplace_sample(torch.Generator().manual_seed(4), loc, scale, (5000, 2))
    r = torch.rand((5000, 2), generator=torch.Generator().manual_seed(4))
    u = (-0.5 + 1e-7) + r * (1 - 2e-7)
    want = loc - scale * torch.sign(u) * torch.log1p(-2 * u.abs())
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.median(0).values.numpy(), loc.numpy(), atol=0.05)


# -- trajectories in float64 ----------------------------------------------


@pytest.mark.parametrize("case", [
    dict(step_size=30.0, learn=True),    # damped line-search iterations
    dict(step_size=0.1, learn=False),    # a frozen D, immediate accepts
    dict(step_size=1.0, learn=False, exhaust=True),
])
def test_adil_fb_trajectory_matches_jax_in_f64(setup, f64, case):
    """The exhausting run freezes a large D and sets lambda_l1 to 0.7 of
    the largest code gradient at v = 0: every active code's gradient is
    then under 5/3 lambda_l1, where the reference's h (its stale l1 term)
    admits no step, so all 50 halvings fail; the full prox step is kept
    and the solver stops."""
    _, _, x, d0 = setup
    labels = f64["labels"]
    lam1 = 1e-3
    d = d0 * 3e4 if case.get("exhaust") else d0
    with jax.enable_x64(True):
        x64, d64 = jnp.asarray(x, jnp.float64), jnp.asarray(d, jnp.float64)
        if case.get("exhaust"):
            g = jax.grad(lambda v: jr._smooth_loss_hp(
                f64["jax_apply"], f64["vars"], d64, v, x64, labels, jnp.float32(0.1),
                jnp.float32(-1.0)))(jnp.zeros((N, K)))
            lam1 = 0.7 * float(jnp.max(jnp.abs(g)))
        kw = dict(n_atoms=K, lambda_l1=lam1, lambda_l2=0.1, targeted=False,
                  step_size=case["step_size"])
        extra = dict(d_init=d64) if case["learn"] else dict(dictionary=d64)
        _forwards(f64)
        dj, vj, tj = jr.adil_fb(f64["jax_apply"], f64["vars"], x64, labels,
                                jr.RegularizedConfig(**kw), jax.random.PRNGKey(0), niter=6, **extra)
        dj, vj, tj = np.asarray(dj), np.asarray(vj), np.asarray(tj)
    extra = dict(d_init=_d64(d)) if case["learn"] else dict(dictionary=_d64(d))
    stats = {}
    dp, vp, tp = pr.adil_fb(f64["port_apply"], _d64(x), torch.as_tensor(labels),
                            RegularizedConfig(**kw), niter=6, stats=stats, **extra)
    jax_fwd, port_fwd = _forwards(f64)
    assert jax_fwd == port_fwd == 2 * stats["iterations"] + stats["halvings"]
    assert np.any(vj != 0)
    np.testing.assert_allclose(vp.numpy(), vj, atol=1e-8)
    np.testing.assert_allclose(dp.numpy(), dj, atol=1e-8)
    np.testing.assert_allclose(tp.numpy(), tj, rtol=1e-9, atol=1e-8)
    if case.get("exhaust"):
        assert stats == dict(iterations=1, halvings=50, exhausted=True)
    elif case["learn"]:
        assert stats["iterations"] == 6 and stats["halvings"] > 0


def test_sadil_updated_trajectory_matches_jax_in_f64(setup, f64):
    """Step 3 over batches of 3 (a ragged tail): halvings in the v searches,
    an epoch whose summed D gradient stays under the 1e-4 gate (no D step,
    no loss), and two D steps."""
    _, _, x, d0 = setup
    labels = f64["labels"]
    kw = dict(n_atoms=K, lambda_l1=1e-3, lambda_l2=0.1, targeted=False, step_size=3.0,
              batch_size=3)
    with jax.enable_x64(True):
        _forwards(f64)
        dj, vj, lj = jr.sadil_updated(f64["jax_apply"], f64["vars"], jnp.asarray(x, jnp.float64),
                                      labels, jr.RegularizedConfig(**kw), jax.random.PRNGKey(0),
                                      nepochs=3, d_init=jnp.asarray(d0, jnp.float64))
        dj, vj = np.asarray(dj), np.asarray(vj)
    stats = {}
    dp, vp, lp = pr.sadil_updated(f64["port_apply"], _d64(x), torch.as_tensor(labels),
                                  RegularizedConfig(**kw), nepochs=3, d_init=_d64(d0),
                                  stats=stats)
    jax_fwd, port_fwd = _forwards(f64)
    assert jax_fwd == port_fwd
    assert stats["epochs"] == 3 and stats["d_steps"] == 2 and stats["halvings"] > 0
    assert len(lp) == 3
    np.testing.assert_allclose(vp.numpy(), vj, atol=1e-8)
    np.testing.assert_allclose(dp.numpy(), dj, atol=1e-8)
    np.testing.assert_allclose(lp, lj, rtol=1e-9, atol=1e-8)


@pytest.mark.parametrize("step_size,lam1,targeted", [
    (1.0, 1e-4, False),  # immediate accepts
    (3.0, 1e-4, False),  # damped accepts that beat the full step
    (5.0, 1e-5, True),   # every search exhausted: the delta^10 candidate kept
])
def test_learn_coding_vectors_trajectory_matches_jax_in_f64(setup, f64, step_size, lam1,
                                                            targeted):
    _, _, x, d0 = setup
    kw = dict(n_atoms=K, lambda_l1=lam1, lambda_l2=0.1, targeted=targeted)
    got_targets = pr._targets(f64["port_apply"], _d64(x), torch.as_tensor(f64["labels"]),
                              targeted)
    with jax.enable_x64(True):
        x64 = jnp.asarray(x, jnp.float64)
        targets = np.asarray(jr._targets(f64["jax_apply"], f64["vars"], x64, f64["labels"],
                                         targeted))
        np.testing.assert_array_equal(got_targets.numpy(), targets)
        _forwards(f64)
        vj = np.asarray(jr.learn_coding_vectors(
            f64["jax_apply"], f64["vars"], jnp.asarray(d0, jnp.float64), x64, targets,
            jr.RegularizedConfig(**kw), niter=12, step_size=step_size))
    stats = {}
    vp = pr.learn_coding_vectors(f64["port_apply"], _d64(d0), _d64(x), got_targets,
                                 RegularizedConfig(**kw), niter=12, step_size=step_size,
                                 stats=stats)
    jax_fwd, port_fwd = _forwards(f64)
    assert jax_fwd == port_fwd == 2 * stats["iterations"] + stats["halvings"]
    assert np.any(vj != 0)
    np.testing.assert_allclose(vp.numpy(), vj, atol=1e-8)


# -- float32 --------------------------------------------------------------


def test_sadil_matches_jax_in_f32(setup):
    jv, pv, x, d0 = setup
    labels = np.asarray(jv.predict(x))
    kw = dict(n_atoms=K, lambda_l1=1e-3, lambda_l2=0.1, targeted=False, step_size=1.0,
              batch_size=3)
    dj, vj, lj = jr.sadil(jv.apply_fn, jv.variables, jnp.asarray(x), labels,
                          jr.RegularizedConfig(**kw), jax.random.PRNGKey(0), nepochs=3,
                          d_init=jnp.asarray(d0))
    dp, vp, lp = pr.sadil(pv, t(x), torch.tensor(labels), RegularizedConfig(**kw), nepochs=3,
                          d_init=t(d0))
    assert np.any(np.asarray(vj) != 0) and len(lp) == len(lj) == 4
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), atol=1e-5)
    np.testing.assert_allclose(lp, lj, rtol=1e-5)


@pytest.mark.parametrize("loss", ["ce", "logits"])
def test_adilr_adamw_matches_jax_over_its_permutations(setup, loss):
    """Three epochs of batches of 3 over 8 images (a padded row), the JAX
    package's permutations, with the per-epoch validation on 4 images."""
    jv, pv, x, d0 = setup
    rng = np.random.default_rng(9)
    d_init = rng.uniform(-1, 1, d0.shape).astype(np.float32)
    v_init = (rng.random((N, K)) * 0.1).astype(np.float32)
    val = rng.random((4, SIZE, SIZE, 3), dtype=np.float32)
    kw = dict(n_atoms=K, lambda_l2=0.5, targeted=False, step_size=0.01, batch_size=3,
              loss=loss, kappa=5.0, eps=2.0)
    key = jax.random.PRNGKey(3)
    dj, vj, lj, fj, valj = jr.adilr_adamw(jv.apply_fn, jv.variables, jnp.asarray(x),
                                          jr.RegularizedConfig(**kw), key, val_images=val,
                                          nepochs=3, d_init=d_init, v_init=v_init)
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(key, ep), 9))
             for ep in range(3)]
    stats = {}
    dp, vp, lp, fp, valp = pr.adilr_adamw(pv, t(x), RegularizedConfig(**kw), val_images=val,
                                          nepochs=3, d_init=d_init, v_init=v_init, perms=perms,
                                          stats=stats)
    assert stats == dict(epochs=3, batches=9, halvings=0)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), atol=2e-3 * 0.01)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=1e-5)
    np.testing.assert_allclose(lp, lj, rtol=1e-5, atol=1e-5)
    assert fp == fj and valp == valj


# -- best of trials, the class, its artifact ------------------------------


def _artifact(rng, n):
    """A dictionary and codes that fool the tiny victim now and then."""
    return dict(d=rng.uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32),
                v=rng.laplace(0.5, 1.0, (n, K)).astype(np.float32))


@pytest.fixture(scope="module")
def unsupervised(setup, tmp_path_factory):
    """One ADILR artifact written by the port, and an unsupervised ADILR of
    each package fitted on it with the same training set, on a tiny victim
    whose classes random codes can flip."""
    x = setup[2]
    jv, _, pv = victim_pair("tiny", key=21)
    rng = np.random.default_rng(13)
    train = rng.random((12, SIZE, SIZE, 3), dtype=np.float32)
    labels = np.asarray(jv.predict(train)).astype(np.int64)
    labels[::3] = (labels[::3] + 1) % 10
    art = _artifact(rng, 12)
    root = str(tmp_path_factory.mktemp("adilr"))
    kw = dict(n_atoms=K, trials=5, attack="unsupervised", model_name="shared",
              data_train=(train, labels))
    key = dict(model="shared", lam1=0.1, lam2=0.1, atoms=K, steps=100, tag="param_selecting")
    ArtifactCache(root).save({**art, "loss": np.zeros(3, np.float32),
                              "labels": labels.astype(np.int32)}, "ADILR", **key)
    want = JaxADILR(jv, cache=JaxArtifactCache(root), **kw)
    got = ADILR(pv, cache=ArtifactCache(root), **kw)
    return want, got, x


def test_laplace_conditioning_matches_jax(unsupervised):
    want, got, _ = unsupervised
    assert sorted(got.mean) == sorted(want.mean) == sorted(ADILR.CONDITIONING)
    for mode in ADILR.CONDITIONING:
        np.testing.assert_allclose(got.mean[mode], want.mean[mode], atol=1e-6)
        np.testing.assert_allclose(got.scale[mode], want.scale[mode], atol=1e-6)


@pytest.mark.parametrize("mode", ADILR.CONDITIONING)
def test_best_of_trials_matches_jax_with_its_draws(unsupervised, mode, monkeypatch):
    want, got, x = unsupervised
    labels = np.array(want.victim.predict(x))
    labels[1] = (labels[1] + 3) % 10
    key = jax.random.PRNGKey(17)
    if mode in ("labels_atoms", "predictions_atoms"):
        target = labels if mode == "labels_atoms" else np.asarray(want.victim.predict(x))
        loc, scale = want.mean[mode][target], want.scale[mode][target]
        adv_j = want.forward_unsupervised_conditioned_target_atoms(
            jnp.asarray(x), labels, key, mode.split("_")[0])
    elif mode == "atoms":
        loc, scale = want.mean[mode][None], want.scale[mode][None]
        adv_j = want.forward_unsupervised_conditioned_atoms(jnp.asarray(x), key)
    else:
        loc, scale = want.mean[mode], want.scale[mode]
        adv_j = want.forward_unsupervised(jnp.asarray(x), key)
    loc = jnp.broadcast_to(jnp.asarray(loc, jnp.float32), (N, K))
    scale = jnp.broadcast_to(jnp.asarray(scale, jnp.float32), (N, K))
    draws = np.stack([np.asarray(jlap.laplace_sample(k, loc, scale, loc.shape))
                      for k in jax.random.split(key, want.cfg.trials)])
    eps = []
    real = pr.fused_perturb
    monkeypatch.setattr(pr, "fused_perturb",
                        lambda v, d, x_, e: eps.append(e) or real(v, d, x_, e))
    xt = t(x)
    if mode in ("labels_atoms", "predictions_atoms"):
        adv_p = got.forward_unsupervised_conditioned_target_atoms(
            xt, torch.tensor(labels), None, mode.split("_")[0], draws=t(draws))
    elif mode == "atoms":
        adv_p = got.forward_unsupervised_conditioned_atoms(xt, None, draws=t(draws))
    else:
        adv_p = got.forward_unsupervised(xt, None, draws=t(draws))
    assert eps == [float("inf")] * want.cfg.trials
    np.testing.assert_allclose(adv_p.numpy(), np.asarray(adv_j), atol=1e-6)
    fooled = got.victim.predict(adv_p) != got.victim.predict(xt)
    assert 0 < int(fooled.sum()) < N  # the selection takes both branches


def _jax_start(cfg_shape):
    """The JAX class's dictionary start: a normal draw from PRNGKey(0)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), cfg_shape))


@pytest.fixture()
def jax_start(monkeypatch):
    """The port's learned dictionaries start where the JAX class's do."""
    def draw(generator, cfg, images, d_init):
        d = torch.tensor(_jax_start((cfg.n_atoms,) + tuple(images.shape[1:])))
        return ops.project_atoms(d.to(images.dtype), cfg.dict_set)

    monkeypatch.setattr(pr, "_draw_dictionary", draw)


def _counting(jv):
    """The JAX victim with its forwards counted by a debug callback."""
    calls = []

    def apply_fn(variables, z):
        jax.debug.callback(lambda: calls.append(1))
        return jv.apply_fn(variables, z)

    return dataclasses.replace(jv, apply_fn=apply_fn), calls


def test_class_learns_serves_and_shares_its_artifact_with_jax(setup, f64, tmp_path, jax_start,
                                                              monkeypatch):
    """``version="deterministic"`` from the JAX start: the artifacts agree,
    each package serves from the other's, and the supervised forward is one
    ``fused_perturb`` launch at eps = budget. Served from the JAX-learned
    artifact (1e-5 from the port's), one f32 line search of
    ``learn_coding_vectors`` takes a different number of halvings in the two
    packages (ROADMAP.md queue 3), and with the port's fp32 victim in
    contiguous NCHW one does from the port-learned one too (the port 23
    halvings, the JAX package 21). Where the counts differ, the same search
    from that artifact's D runs in float64 in both packages: equal
    forwards, codes within 1e-8."""
    jv, pv, x, _ = setup
    jvc, calls = _counting(jv)
    labels = np.asarray(jv.predict(x))
    kw = dict(n_atoms=K, steps=4, lambda_l1=1e-3, targeted=False, step_size=1.0,
              model_name="shared")
    JaxADILR(jv, cache=JaxArtifactCache(str(tmp_path / "jax")), data_train=(x, labels), **kw)
    got = ADILR(pv, cache=ArtifactCache(str(tmp_path / "port")), data_train=(x, labels), **kw)
    assert got.stats["iterations"] == 4
    path = dict(model="shared", lam1=1e-3, lam2=0.1, atoms=K, steps=4, tag="param_selecting")
    a_j = JaxArtifactCache(str(tmp_path / "jax")).load("ADILR", **path)
    a_p = JaxArtifactCache(str(tmp_path / "port")).load("ADILR", **path)  # read by JAX
    assert sorted(a_p) == sorted(a_j) == ["d", "labels", "loss", "v"]
    assert a_p["labels"].dtype == a_j["labels"].dtype and np.any(a_j["v"] != 0)
    np.testing.assert_allclose(a_p["d"], a_j["d"], atol=1e-5)
    np.testing.assert_allclose(a_p["v"], a_j["v"], atol=1e-5)
    np.testing.assert_allclose(a_p["loss"], a_j["loss"], rtol=1e-5)

    eps = []
    real = pr.fused_perturb
    monkeypatch.setattr(pr, "fused_perturb",
                        lambda v, d, x_, e: eps.append(e) or real(v, d, x_, e))
    for root in ("port", "jax"):  # each package serves from each artifact
        j = JaxADILR(jvc, cache=JaxArtifactCache(str(tmp_path / root)), **kw)
        p = ADILR(pv, cache=ArtifactCache(str(tmp_path / root)), **kw)
        calls.clear()
        adv_j = np.asarray(j(jnp.asarray(x), labels))
        jax.effects_barrier()
        adv_p = p(t(x), torch.tensor(labels))
        assert float((adv_p - t(x)).abs().max()) <= 10 / 255 + 1e-6
        assert 0 <= float(adv_p.min()) and float(adv_p.max()) <= 1
        if len(calls) == 2 * p.stats["iterations"] + p.stats["halvings"]:
            np.testing.assert_allclose(adv_p.numpy(), adv_j, atol=1e-5)
            continue
        d = {"port": a_p, "jax": a_j}[root]["d"]
        with jax.enable_x64(True):
            _forwards(f64)
            vj = np.asarray(jr.learn_coding_vectors(
                f64["jax_apply"], f64["vars"], jnp.asarray(d, jnp.float64),
                jnp.asarray(x, jnp.float64), labels, j.cfg))
        stats = {}
        vp = pr.learn_coding_vectors(f64["port_apply"], _d64(d), _d64(x),
                                     torch.tensor(labels), p.cfg, stats=stats)
        jax_fwd, port_fwd = _forwards(f64)
        assert jax_fwd == port_fwd == 2 * stats["iterations"] + stats["halvings"]
        assert np.any(vj != 0)
        np.testing.assert_allclose(vp.numpy(), vj, atol=1e-8)
    assert eps == [10 / 255] * 2


@pytest.mark.parametrize("version", ["deterministic", "adamw", "sadil_updated"])
def test_class_learns_in_each_version_and_serves_in_each_mode(setup, tmp_path, monkeypatch,
                                                              version):
    """Each version learns through the constructor and saves the JAX
    package's artifact; ``adamw`` launches ``fused_adamw_project`` on D and
    on v at each batch; the supervised forward is one ``fused_perturb``
    launch at eps = budget and each unsupervised trial one at eps = inf."""
    _, pv, x, _ = setup
    labels = pv.predict(t(x)).numpy()
    launches = {"perturb": [], "adamw": []}
    real_p, real_a = pr.fused_perturb, pr.fused_adamw_project
    monkeypatch.setattr(pr, "fused_perturb", lambda v, d, x_, e: launches["perturb"].append(e)
                        or real_p(v, d, x_, e))
    monkeypatch.setattr(pr, "fused_adamw_project", lambda p, g, mu, nu, step, lr, clip: (
        launches["adamw"].append((tuple(p.shape), step, clip)) or real_a(p, g, mu, nu, step, lr,
                                                                         clip)))
    attack = ADILR(pv, version=version, steps=2, n_atoms=K, batch_size=4, trials=3,
                   data_train=(x, labels), data_val=(x[:2], labels[:2]),
                   cache=ArtifactCache(str(tmp_path)), attack="unsupervised")
    saved = ArtifactCache(str(tmp_path)).load("ADILR", model="tiny", lam1=0.1, lam2=0.1,
                                               atoms=K, steps=2, tag="param_selecting")
    assert saved["d"].shape == (K, SIZE, SIZE, 3) and saved["v"].shape == (N, K)
    assert saved["labels"].dtype == np.int32 and np.isfinite(saved["loss"]).all()
    inf = float("inf")
    if version == "adamw":
        assert launches["adamw"] == [c for s in (1, 2, 3, 4) for c in (
            ((K, SIZE, SIZE, 3), s, inf), ((N, K), s, inf))]
        assert len(attack.val_fools) == 2
    else:
        assert launches["adamw"] == []
    assert sorted(attack.mean) == sorted(ADILR.CONDITIONING)
    for mode in ADILR.CONDITIONING:
        attack.attack_conditioned = mode
        launches["perturb"].clear()
        adv = attack(t(x), torch.tensor(labels))
        assert launches["perturb"] == [inf] * 3
        assert adv.shape == x.shape and 0 <= float(adv.min()) and float(adv.max()) <= 1
    attack.attack_mode = "supervised"
    launches["perturb"].clear()
    adv = attack(t(x), torch.tensor(labels))
    assert launches["perturb"] == [10 / 255] and attack.stats["iterations"] >= 1
    assert float((adv - t(x)).abs().max()) <= 10 / 255 + 1e-6
    assert kernels.fused_perturb.launches == kernels.fused_adamw_project.launches == 0


# -- the harness ----------------------------------------------------------


def test_harness_learns_adilr_lazily_and_equals_jax(setup, tmp_path, jax_start):
    """An untrained ADILR in ``get_performance``: the first batch with a
    misclassified row learns on its kept rows (``learn_dictionary`` takes
    one argument), then every batch is served."""
    jv, pv, x, _ = setup
    labels = np.array(jv.predict(x)).astype(np.int64)
    labels[[1, 6]] = (labels[[1, 6]] + 1) % 10
    loader = [(x[s:s + 4], labels[s:s + 4]) for s in (0, 4)]
    kw = dict(n_atoms=K, steps=3, lambda_l1=1e-4, targeted=False, step_size=1.0)
    want_atk = JaxADILR(jv, cache=JaxArtifactCache(str(tmp_path / "jax")), **kw)
    got_atk = ADILR(pv, cache=ArtifactCache(str(tmp_path / "port")), **kw)
    seen = []
    real = got_atk.learn_dictionary

    def spy(data_train):
        seen.append(np.asarray(data_train[0]))
        real(data_train)

    got_atk.learn_dictionary = spy
    want = jev.get_performance({"ADILR": [want_atk]}, jv, loader)
    got = ev.get_performance({"ADILR": [got_atk]}, pv, loader)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], x[[0, 2, 3]])
    assert got["sub_names"] == want["sub_names"] and got["group_key"] == want["group_key"]
    key = want["group_key"]["ADILR"]
    assert got["fooling_rate"][key] == want["fooling_rate"][key]
    np.testing.assert_allclose(got["rmse"][key], want["rmse"][key], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got["mse"][key], want["mse"][key], rtol=RTOL, atol=0)


def test_harness_does_not_mask_a_type_error_raised_in_training(setup, tmp_path):
    jv, pv, x, _ = setup
    labels = np.array(jv.predict(x)).astype(np.int64)
    labels[0] = (labels[0] + 1) % 10
    attack = ADILR(pv, n_atoms=K, cache=ArtifactCache(str(tmp_path)))
    calls = []

    def broken(data_train):
        calls.append(1)
        raise TypeError("raised inside training")

    attack.learn_dictionary = broken
    with pytest.raises(TypeError, match="inside training"):
        ev.performance(attack, pv, [(x[:4], labels[:4])])
    assert calls == [1]
