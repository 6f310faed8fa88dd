"""The port's APGD/APGD-T, FAB, Square, OnePixel and AutoAttack against the
JAX package's, on the tiny victim at 32x32 with the same weights
(``victim_pair``) and inputs drawn in numpy from fixed seeds, with JAX's own
draws rebuilt from the key chains it folds and passed to the port; and the
harness over a small grid of them.

The decisions are counted on both sides and must be equal: APGD's
per-image step sizes after each checkpoint, Square's queries and accepted
queries, OnePixel's generations and accepted trials, FAB's found flags and
chosen candidate classes, AutoAttack's robust mask after each member. The
JAX side is counted by running its ``lax`` loops as Python loops over its
own jitted bodies (and recording FAB's ``argsort``/``argmin`` with
``jax.debug.callback``); nothing in the JAX package changes.

Tolerances: the FAB projections within 1e-6 of both JAX forms; l2
trajectories within 1e-5; signed-step l∞ trajectories (APGD, AutoAttack)
within the bound of ``tests/test_torch_parity_uap.py``, atol 2e-3 with under
1% of the elements beyond 5e-5, and the port meets 1e-5 here; FAB, Square
and OnePixel, whose steps are not signs, within 1e-5; the harness's fooling
counts exact, RMSE and MSE within 5e-5 relative.
"""

import contextlib
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu import attacks as jattacks
from dl_attack_on_imagenet_tpu import evaluation as jev
from dl_attack_on_imagenet_tpu.attacks import apgd as japgd
from dl_attack_on_imagenet_tpu.attacks import fab as jfab
from dl_attack_on_imagenet_tpu.attacks import one_pixel as jop
from dl_attack_on_imagenet_tpu.attacks import square as jsq
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu_torch import attacks
from dl_attack_on_imagenet_tpu_torch import evaluation as ev
from dl_attack_on_imagenet_tpu_torch.attacks import apgd, fab, one_pixel, square

from _torch_port import assert_signed_close, call_key, max_err, t, victim_pair

SIZE, N = 32, 8
EPS = 8 / 255
STEPS = 5
QUERIES = 20


@pytest.fixture(scope="module")
def setup():
    jv, variables, pv = victim_pair("tiny", key=21)
    rs = np.random.RandomState(3)
    images = rs.uniform(0.0, 1.0, (N, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray(jv.predict(jnp.asarray(images))).astype(np.int64)
    return jv, variables, pv, images, labels





@contextlib.contextmanager
def _loops_recorded(monkeypatch, which):
    """Run ``jax.lax.<which>`` as a Python loop over its jitted body and
    yield the list of carries after each iteration."""
    carries = []
    real_fori, depth = jax.lax.fori_loop, [0]
    if which == "fori_loop":
        def fori_loop(lower, upper, body, carry):
            if depth[0]:  # a loop inside the recorded loop's body
                return real_fori(lower, upper, body, carry)
            step = jax.jit(body)
            depth[0] += 1
            try:
                for i in range(lower, upper):
                    carry = step(i, carry)
                    carries.append(carry)
            finally:
                depth[0] -= 1
            return carry

        monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    else:
        def while_loop(cond, body, carry):
            test, step = jax.jit(cond), jax.jit(body)
            while bool(test(carry)):
                carry = step(carry)
                carries.append(carry)
            return carry

        monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    try:
        yield carries
    finally:
        monkeypatch.undo()


# -- JAX's draws ------------------------------------------------------------------


def _apgd_u(key, shape, norm="linf"):
    """APGD's start draw, in JAX's default float dtype (float64 under x64)."""
    if norm == "linf":
        return torch.tensor(np.asarray(2.0 * jax.random.uniform(key, shape) - 1.0))
    return torch.tensor(np.asarray(jax.random.normal(key, shape)))


def _square_draws(key, shape, n_queries, p_init=0.8):
    """Square's draws of one run, as ``attacks/square.py`` folds them."""
    n, h, w, c = shape
    sizes = jsq._sizes(p_init, n_queries, h, w)
    sign = lambda k, s: 2.0 * np.asarray(jax.random.bernoulli(k, 0.5, s), np.float32) - 1.0  # noqa: E731
    h0, w0, signs = [], [], []
    for i in range(n_queries):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, i + 1), 3)
        h0.append(np.asarray(jax.random.randint(k1, (n,), 0, h - sizes[i] + 1)))
        w0.append(np.asarray(jax.random.randint(k2, (n,), 0, w - sizes[i] + 1)))
        signs.append(sign(k3, (n, 1, 1, c)).reshape(n, c))
    return dict(stripes=torch.tensor(sign(jax.random.fold_in(key, 0), (n, 1, w, c))),
                h0=torch.tensor(np.stack(h0)), w0=torch.tensor(np.stack(w0)),
                signs=torch.tensor(np.stack(signs)))


def _one_pixel_draws(key, n, pop, dims, steps):
    """OnePixel's draws, as ``attacks/one_pixel.py`` folds them."""
    out = {name: [] for name in ("f", "a", "b", "redraw", "cross", "forced")}
    for step in range(steps):
        kf, ka, kb, kx, kg, kr = jax.random.split(jax.random.fold_in(key, step + 1), 6)
        out["f"].append(np.asarray(jax.random.uniform(kf, (), minval=0.5, maxval=1.0)))
        out["a"].append(np.asarray(jax.random.randint(ka, (n, pop), 0, pop - 1)))
        out["b"].append(np.asarray(jax.random.randint(kb, (n, pop), 0, pop - 2)))
        out["redraw"].append(np.asarray(jax.random.uniform(kg, (n, pop, dims))))
        out["cross"].append(np.asarray(jax.random.uniform(kx, (n, pop, dims))))
        out["forced"].append(np.asarray(jax.random.randint(kr, (n, pop), 0, dims)))
    draws = {name: torch.tensor(np.stack(vals)) for name, vals in out.items()}
    draws["pop0"] = torch.tensor(np.asarray(
        jax.random.uniform(jax.random.fold_in(key, 0), (n, pop, dims))))
    return draws


# -- APGD ----------------------------------------------------------------------------


def test_schedule_matches_jax():
    for n_iter in (1, 5, 10, 100):
        want_ck, want_iv = japgd._schedule(n_iter)
        got_ck, got_iv = apgd._schedule(n_iter)
        assert np.array_equal(got_ck, np.asarray(want_ck))
        assert np.array_equal(got_iv, np.asarray(want_iv))


def _jax_apgd_counted(monkeypatch, jv, variables, x, y, targets, key, loss, norm, eps,
                      eot_iter=1):
    """JAX's apgd result and its step sizes after each checkpoint."""
    is_ck, _ = japgd._schedule(STEPS)
    with _loops_recorded(monkeypatch, "fori_loop") as carries:
        adv, succ = japgd.apgd(jv.apply_fn, variables, jnp.asarray(x), jnp.asarray(y), eps,
                               STEPS, norm=norm, loss=loss, targets=jnp.asarray(targets),
                               eot_iter=eot_iter, key=key)
    # The main loop's carries (13 entries); EOT's own loop runs outside it too.
    carries = [c for c in carries if len(c) == 13]
    steps = [np.asarray(c[9]) for c, ck in zip(carries, np.asarray(is_ck)) if ck]
    return adv, succ, steps


@pytest.mark.parametrize("loss,norm,eot_iter", [
    ("ce", "linf", 1), ("dlr", "linf", 1), ("dlr-targeted", "linf", 1), ("ce", "l2", 1),
    ("ce", "linf", 2)])
def test_apgd_matches_jax_with_equal_step_sizes(setup, monkeypatch, loss, norm, eot_iter):
    jv, variables, pv, x, y = setup
    eps = EPS if norm == "linf" else 0.5
    order = np.argsort(np.asarray(jv(jnp.asarray(x))), -1, kind="stable")
    targets = order[:, -2] if loss == "dlr-targeted" else y
    key = jax.random.fold_in(call_key(4), 0)
    want, want_succ, want_steps = _jax_apgd_counted(monkeypatch, jv, variables, x, y, targets,
                                                    key, loss, norm, eps, eot_iter)
    stats = {}
    got, got_succ = apgd.apgd(pv, t(x), torch.tensor(y), eps, STEPS, norm=norm, loss=loss,
                              targets=torch.tensor(targets), eot_iter=eot_iter,
                              u=_apgd_u(key, x.shape, norm), stats=stats)
    assert len(stats["steps"]) == len(want_steps) >= 2
    for got_step, want_step in zip(stats["steps"], want_steps):
        np.testing.assert_allclose(got_step, want_step, rtol=1e-6)
    assert np.array_equal(got_succ.numpy(), np.asarray(want_succ))
    if norm == "l2":
        assert max_err(got, want) <= 1e-5
    else:
        assert_signed_close(got, want)


def test_apgd_halves_steps_on_this_input(setup, monkeypatch):
    # The decisions compared above are not all "keep": some image halves.
    jv, variables, pv, x, y = setup
    key = jax.random.fold_in(call_key(4), 0)
    stats = {}
    apgd.apgd(pv, t(x), torch.tensor(y), EPS, STEPS, loss="ce", u=_apgd_u(key, x.shape),
              stats=stats)
    assert (stats["steps"][-1] < 2 * EPS - 1e-9).any()


def test_apgd_needs_its_start_draw(setup):
    _, _, pv, x, y = setup
    with pytest.raises(ValueError, match="start draw"):
        apgd.apgd(pv, t(x), torch.tensor(y), EPS, STEPS)


# -- FAB projections ---------------------------------------------------------------------


def _projection_cases():
    rs = np.random.RandomState(0)
    d = 48
    x = rs.uniform(size=(8, d)).astype(np.float32)
    w = rs.normal(size=(8, d)).astype(np.float32)
    hval = rs.normal(size=8).astype(np.float32)
    w[1, ::3] = 0.0  # zero weights among others
    w[2] = 0.0  # all-zero w: unreachable unless hval = 0
    hval[3] = 0.0  # on the hyperplane already: t = 0
    hval[4] = 1e3  # beyond the box: t = inf
    w[5, :] = 0.0
    hval[5] = 0.0  # zero w and hval = 0
    x[6, :4] = [0.0, 1.0, 0.0, 1.0]  # coordinates at the box walls
    return x, w, hval


def test_fab_projections_match_both_jax_forms():
    x, w, hval = _projection_cases()
    want_delta, want_t = jfab.linf_hyperplane_box_project(jnp.asarray(x), jnp.asarray(w),
                                                          jnp.asarray(hval))
    got_delta, got_t = fab.linf_hyperplane_box_project(t(x), t(w), t(hval))
    want_t, want_newton = np.asarray(want_t), np.asarray(
        jfab.linf_hyperplane_box_project_t(jnp.asarray(x), jnp.asarray(w), jnp.asarray(hval)))
    got_newton = fab.linf_hyperplane_box_project_t(t(x), t(w), t(hval)).numpy()
    for got, want in ((got_t.numpy(), want_t), (got_newton, want_newton)):
        assert np.array_equal(np.isinf(got), np.isinf(want))
        finite = np.isfinite(want)
        assert max_err(got[finite], want[finite]) <= 1e-6
    assert np.isinf(want_t[[2, 4]]).all() and want_t[3] == 0.0  # the branches ran
    assert max_err(got_delta, want_delta) <= 1e-6
    capped = np.where(np.isfinite(want_newton), want_newton, 1.0).astype(np.float32)
    got_move = fab.linf_hyperplane_box_delta(t(x), t(w), t(hval), t(capped))
    want_move = jfab.linf_hyperplane_box_delta(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(hval), jnp.asarray(capped))
    assert max_err(got_move, want_move) <= 1e-6


# -- FAB ---------------------------------------------------------------------------------


def _jax_fab_counted(monkeypatch, jv, variables, x, y, x0, targets, n_cand, targeted):
    """JAX's _fab_run result, and each step's chosen candidate classes."""
    ranked, chosen = [], []
    real_argsort, real_argmin = jnp.argsort, jnp.argmin

    def argsort(a, *args, **kwargs):
        out = real_argsort(a, *args, **kwargs)
        jax.debug.callback(lambda v: ranked.append(np.asarray(v)), out, ordered=True)
        return out

    def argmin(a, *args, **kwargs):
        out = real_argmin(a, *args, **kwargs)
        jax.debug.callback(lambda v: chosen.append(np.asarray(v)), out, ordered=True)
        return out

    jnp_recorded = types.SimpleNamespace(**{**vars(jnp), "argsort": argsort, "argmin": argmin})
    monkeypatch.setattr(jfab, "jnp", jnp_recorded)
    with _loops_recorded(monkeypatch, "fori_loop"):
        xb, db, found = jfab._fab_run(jv.apply_fn, variables, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(x0), jnp.asarray(targets), STEPS, n_cand,
                                      targeted)
        jax.effects_barrier()
    rows = np.arange(x.shape[0])
    if targeted:
        classes = [np.asarray(targets) for _ in chosen]
    else:
        classes = [order[:, -n_cand:][rows, c] for order, c in zip(ranked, chosen)]
    return xb, db, found, classes


@pytest.mark.parametrize("targeted", [False, True])
def test_fab_run_matches_jax_with_equal_choices(setup, monkeypatch, targeted):
    jv, variables, pv, x, y = setup
    order = np.argsort(np.asarray(jv(jnp.asarray(x))), -1, kind="stable")
    targets = order[:, -2] if targeted else y
    n_cand = 1 if targeted else 9
    x0 = np.clip(x + 0.01, 0, 1)  # a start off the clean point
    want, want_d, want_found, want_classes = _jax_fab_counted(
        monkeypatch, jv, variables, x, y, x0, targets, n_cand, targeted)
    stats = {}
    got, got_d, got_found = fab._fab_run(pv, t(x), torch.tensor(y), t(x0),
                                         torch.tensor(targets), STEPS, n_cand, targeted, stats)
    assert np.array_equal(got_found.numpy(), np.asarray(want_found))
    assert want_found.any()
    assert len(stats["chosen"]) == len(want_classes) == STEPS
    for got_c, want_c in zip(stats["chosen"], want_classes):
        assert np.array_equal(got_c, want_c)
    assert max_err(got, want) <= 1e-5
    finite = np.isfinite(np.asarray(want_d))
    assert np.array_equal(np.isfinite(got_d.numpy()), finite)
    assert max_err(got_d.numpy()[finite], np.asarray(want_d)[finite]) <= 1e-5


# -- Square ------------------------------------------------------------------------------


def _square_accepts(carries, n):
    """Each image's accepted queries and the queries made, from the JAX
    while-loop's carries (i, x_best, obj_min, margin_min)."""
    accepts, prev = np.zeros(n, int), None
    for carry in carries:
        obj = np.asarray(carry[2])
        if prev is not None:
            accepts += obj != prev
        prev = obj
    return accepts, int(carries[-1][0]) if carries else 0


@pytest.mark.parametrize("loss,targeted", [("margin", False), ("ce", False), ("ce", True)])
def test_square_matches_jax_with_equal_accepts(setup, monkeypatch, loss, targeted):
    jv, variables, pv, x, y = setup
    labels = np.argsort(np.asarray(jv(jnp.asarray(x))), -1)[:, -2] if targeted else y
    key = jax.random.fold_in(call_key(6), 0)
    eps = 16 / 255

    def init_and_run(cond, body, carry):
        carries.append(carry)  # the state before the first query
        return real_while(cond, body, carry)

    with _loops_recorded(monkeypatch, "while_loop") as carries:
        real_while = jax.lax.while_loop
        monkeypatch.setattr(jax.lax, "while_loop", init_and_run)
        want, want_margin = jsq.square_linf(jv.apply_fn, variables, jnp.asarray(x),
                                            jnp.asarray(labels), eps, QUERIES, loss=loss,
                                            targeted=targeted, key=key)
    want_accepts, want_queries = _square_accepts(carries, N)
    stats = {}
    got, got_margin = square.square_linf(pv, t(x), torch.tensor(labels), eps, QUERIES,
                                         _square_draws(key, x.shape, QUERIES), loss=loss,
                                         targeted=targeted, stats=stats)
    assert stats["queries"] == want_queries
    assert np.array_equal(stats["accepts"], want_accepts) and want_accepts.sum() > 0
    assert max_err(got, want) <= 1e-5
    assert max_err(got_margin, want_margin) <= 1e-5


def test_square_leaves_once_every_image_is_fooled(setup):
    _, _, pv, x, y = setup
    draws = square.query_draws(torch.Generator().manual_seed(0), x.shape, 50)
    stats = {}
    _, margin = square.square_linf(pv, t(x), torch.tensor(y), 0.5, 50, draws, stats=stats)
    assert (margin <= 0).all() and stats["queries"] < 50


# -- OnePixel ----------------------------------------------------------------------------


def test_apply_candidate_matches_jax_with_duplicate_coordinates():
    rs = np.random.RandomState(2)
    images = rs.uniform(size=(4, 8, 8, 3)).astype(np.float32)
    cands = np.concatenate([rs.uniform(0, 8, (4, 3, 2)), rs.uniform(size=(4, 3, 3))], -1)
    cands = cands.astype(np.float32)
    cands[:, 2, :2] = cands[:, 0, :2]  # the third pixel lands on the first
    cands[1, 1, :2] = [7.99, 0.5]  # truncation toward zero
    got = one_pixel._apply_candidate(t(images), t(cands))
    want = [np.asarray(jop._apply_candidate(jnp.asarray(im), jnp.asarray(cd), 8, 8))
            for im, cd in zip(images, cands)]
    assert np.array_equal(got.numpy(), np.stack(want))
    rows, cols = cands[:, 0, 0].astype(int), cands[:, 0, 1].astype(int)
    assert np.array_equal(got.numpy()[np.arange(4), rows, cols], cands[:, 2, 2:])


def _one_pixel_counts(carries, n):
    accepts, prev = np.zeros(n, int), None
    for carry in carries:
        e = np.asarray(carry[2])
        if prev is not None:
            accepts += (e != prev).sum(1)
        prev = e
    return accepts, int(carries[-1][0])


@pytest.mark.parametrize("targeted", [False, True])
def test_one_pixel_matches_jax_with_equal_generations(setup, monkeypatch, targeted):
    jv, variables, pv, x, y = setup
    labels = np.argsort(np.asarray(jv(jnp.asarray(x))), -1)[:, -2] if targeted else y
    pixels, gens = 2, 3
    pop = jattacks.OnePixel(jv, pixels=pixels).population(3)
    dims = pixels * 5
    key = jax.random.fold_in(call_key(8), 0)

    def init_and_run(cond, body, carry):
        carries.append(carry)
        return real_while(cond, body, carry)

    with _loops_recorded(monkeypatch, "while_loop") as carries:
        real_while = jax.lax.while_loop
        monkeypatch.setattr(jax.lax, "while_loop", init_and_run)
        want, want_e, want_fool = jop.one_pixel_de(
            jv.apply_fn, variables, jnp.asarray(x), jnp.asarray(labels), steps=gens,
            pixels=pixels, pop=pop, inf_batch=16, targeted=targeted, key=key)
    want_accepts, want_gens = _one_pixel_counts(carries, N)
    stats = {}
    got, got_e, got_fool = one_pixel.one_pixel_de(
        pv, t(x), torch.tensor(labels), steps=gens, pixels=pixels, pop=pop, inf_batch=16,
        targeted=targeted, draws=_one_pixel_draws(key, N, pop, dims, gens), stats=stats)
    assert stats["generations"] == want_gens
    assert np.array_equal(stats["accepts"], want_accepts) and want_accepts.sum() > 0
    assert np.array_equal(got_fool.numpy(), np.asarray(want_fool))
    assert max_err(got, want) <= 1e-5
    assert max_err(got_e, want_e) <= 1e-5


# -- the classes on a fresh instance, with the draws of its first call --------------------


def _class_case(name, jv, pv, x):
    """(JAX instance, port instance, the port's draws of the first call)."""
    base = call_key(0)
    n_classes = 10
    if name == "APGD-dlr-l2":
        return (jattacks.APGD(jv, norm="L2", eps=0.5, steps=STEPS, loss="dlr"),
                attacks.APGD(pv, norm="L2", eps=0.5, steps=STEPS, loss="dlr"),
                [_apgd_u(jax.random.fold_in(base, 0), x.shape, "l2")])
    if name == "APGDT":
        return (jattacks.APGDT(jv, steps=3, n_classes=4),
                attacks.APGDT(pv, steps=3, n_classes=4),
                [_apgd_u(jax.random.fold_in(base, rank * 131), x.shape) for rank in (2, 3, 4)])
    if name == "FAB":
        return (jattacks.FAB(jv, steps=3, n_restarts=2, n_classes=n_classes),
                attacks.FAB(pv, steps=3, n_restarts=2, n_classes=n_classes),
                {1: t(np.asarray(2.0 * jax.random.uniform(jax.random.fold_in(base, 1),
                                                          x.shape) - 1.0))})
    if name == "FAB-T":
        return (jattacks.FAB(jv, steps=3, n_classes=3, targeted=True),
                attacks.FAB(pv, steps=3, n_classes=3, targeted=True), None)
    if name == "Square":
        return (jattacks.Square(jv, eps=16 / 255, n_queries=QUERIES),
                attacks.Square(pv, eps=16 / 255, n_queries=QUERIES),
                [_square_draws(jax.random.fold_in(base, 0), x.shape, QUERIES)])
    if name == "OnePixel":
        j_atk = jattacks.OnePixel(jv, pixels=2, steps=3, inf_batch=32)
        pop = j_atk.population(3)
        return (j_atk, attacks.OnePixel(pv, pixels=2, steps=3, inf_batch=32),
                _one_pixel_draws(base, N, pop, 10, 3))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["APGD-dlr-l2", "APGDT", "FAB", "FAB-T", "Square", "OnePixel"])
def test_class_matches_jax(setup, name):
    jv, _, pv, x, y = setup
    j_atk, p_atk, draws = _class_case(name, jv, pv, x)
    want = j_atk(jnp.asarray(x), jnp.asarray(y))
    got = p_atk(t(x), torch.tensor(y), draws=draws)
    if name.startswith("APGD") and "l2" not in name:
        assert_signed_close(got, want)
    else:
        assert max_err(got, want) <= 1e-5
    assert p_atk._rng_calls == 1
    if name == "OnePixel":
        assert p_atk.population(3) == j_atk.population(3)


class _Victim64(torch.nn.Module):
    """The port's tiny victim in float64 behind ``VictimModel``'s interface
    (which casts to fp32); it promotes its input to float64, as a float64
    Flax layer promotes a float32 one."""

    def __init__(self, pv):
        super().__init__()
        self.net = copy.deepcopy(pv.net).double()
        self.num_classes = pv.num_classes
        self.device = torch.device("cpu")

    def forward(self, z):
        return self.net(z.permute(0, 3, 1, 2).double())

    def predict(self, z):
        return torch.argmax(self(z), dim=-1)


def test_apgd_class_matches_jax_in_float64(setup):
    # In float32 the last step of restart 0 gives one element of image 0
    # the opposite sign: its CE gradient there is 1.6e-8 of the image's
    # largest, at the noise floor. In float64 (JAX under x64, whose APGD
    # promotes its iterates to float64 and keeps its losses float32, and a
    # float64 copy of the port's net) the two agree within 1e-5.
    jv, _, pv, x, y = setup
    with jax.enable_x64(True):
        vars64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv.variables)
        jv64 = jax_create_model("tiny", dtype=jnp.float64, variables=vars64)
        want = jattacks.APGD(jv64, steps=STEPS, n_restarts=2)(jnp.asarray(x, jnp.float64),
                                                               jnp.asarray(y))
        draws = [_apgd_u(jax.random.fold_in(call_key(0), r), x.shape) for r in range(2)]
    assert draws[0].dtype == torch.float64
    p_atk = attacks.APGD(_Victim64(pv), steps=STEPS, n_restarts=2)
    got = p_atk.forward(torch.tensor(x, dtype=torch.float64), torch.tensor(y), draws=draws)
    assert got.dtype == torch.float64 and p_atk._rng_calls == 1
    assert_signed_close(got, want)


@pytest.mark.parametrize("name", ["APGD", "APGDT", "FAB", "Square", "OnePixel"])
def test_class_draws_its_own_in_budget(setup, name):
    _, _, pv, x, y = setup
    p_atk = {"APGD": lambda: attacks.APGD(pv, steps=2, n_restarts=2),
             "APGDT": lambda: attacks.APGDT(pv, steps=2, n_classes=3),
             "FAB": lambda: attacks.FAB(pv, steps=2, n_restarts=2),
             "Square": lambda: attacks.Square(pv, n_queries=5),
             "OnePixel": lambda: attacks.OnePixel(pv, steps=2)}[name]()
    adv = p_atk(t(x), torch.tensor(y))
    assert adv.shape == x.shape and float(adv.min()) >= 0 and float(adv.max()) <= 1
    if name in ("APGD", "APGDT", "Square"):
        assert float((adv - t(x)).abs().max()) <= EPS + 1e-6


# -- AutoAttack -------------------------------------------------------------------------


def _autoattack_draws(x, members):
    """Each member's draws of its first call, by the member's name."""
    base = call_key(0)
    draws = {}
    for name in ("apgd-ce", "apgd-ce-rand", "apgd-dlr-rand"):
        if name in members:
            draws[name] = [_apgd_u(jax.random.fold_in(base, 0), x.shape)]
    if "apgd-t" in members:
        draws["apgd-t"] = [_apgd_u(jax.random.fold_in(base, rank * 131), x.shape)
                           for rank in range(2, 11)]
    if "square" in members:
        draws["square"] = [_square_draws(jax.random.fold_in(base, 0), x.shape, QUERIES)]
    return draws


@pytest.mark.parametrize("version", ["standard", "rand"])
def test_autoattack_matches_jax_with_equal_robust_masks(setup, version):
    jv, _, pv, x, y = setup
    kwargs = dict(steps=3, n_queries=QUERIES, version=version)
    j_aa, p_aa = jattacks.AutoAttack(jv, **kwargs), attacks.AutoAttack(pv, **kwargs)
    outputs = []
    for i, (name, atk) in enumerate(j_aa._attacks):
        def recorded(images, labels, _atk=atk):
            out = _atk(images, labels)
            outputs.append(np.asarray(out))
            return out
        j_aa._attacks[i] = (name, recorded)
    y_mixed = y.copy()
    y_mixed[0] = (y[0] + 1) % 10  # one image the victim already misclassifies
    want = j_aa(jnp.asarray(x), jnp.asarray(y_mixed))
    robust = np.asarray(jv.predict(jnp.asarray(x))) == y_mixed
    want_masks = []
    for cand in outputs:
        dist = np.abs(cand - x).max((1, 2, 3))
        fooled = (np.asarray(jv.predict(jnp.asarray(cand))) != y_mixed) & (dist <= EPS + 1e-6)
        robust = robust & ~fooled
        want_masks.append(robust)
    stats = {}
    got = p_aa(t(x), torch.tensor(y_mixed),
               draws=_autoattack_draws(x, p_aa.attacks_to_run), stats=stats)
    assert len(stats["robust"]) == len(want_masks) >= 1
    for got_mask, want_mask in zip(stats["robust"], want_masks):
        assert np.array_equal(got_mask, want_mask)
    assert_signed_close(got, want)
    changed = (got - t(x)).abs().flatten(1).amax(1)
    assert float(changed.max()) <= EPS + 1e-5 and float(changed[0]) == 0.0


def test_autoattack_builds_the_published_suites(setup):
    pv = setup[2]
    assert attacks.AutoAttack(pv).attacks_to_run == ("apgd-ce", "apgd-t", "fab-t", "square")
    big = attacks.AutoAttack(pv, n_classes=1000)
    assert big._attacks[1][1].n_classes == 10 and big._attacks[2][1].n_classes == 10
    rand = attacks.AutoAttack(pv, version="rand")
    assert [atk.eot_iter for _, atk in rand._attacks] == [20, 20]
    with pytest.raises(ValueError, match="version"):
        attacks.AutoAttack(pv, version="plus")


# -- the harness over a grid of the new attacks ----------------------------------------------


def test_get_performance_over_a_grid_matches_jax(setup):
    jv, _, pv, x, y = setup
    y_mixed = y.copy()
    y_mixed[::3] = (y[::3] + 1) % 10  # rows the victim misclassifies are dropped
    data = [(x, y_mixed)]

    def grids(victim, pkg, is_port):
        atks = {"APGD": pkg.evaluation.get_atks(victim, pkg.attacks.APGD, "eps",
                                                [4 / 255, 8 / 255], norm="Linf", steps=3),
                "CW": pkg.evaluation.get_atks(victim, pkg.attacks.CW, "c", [0.1, 10.0],
                                              steps=3),
                "FGSM": [pkg.attacks.FGSM(victim)]}
        if is_port:
            for atk in atks["APGD"]:
                # JAX's start of each instance's first call, on the padded batch.
                atk.draws = lambda shape: [_apgd_u(jax.random.fold_in(call_key(0), 0), shape)]
        return atks

    import dl_attack_on_imagenet_tpu as jpkg
    import dl_attack_on_imagenet_tpu_torch as ppkg

    want = jev.get_performance(grids(jv, jpkg, False), jv, data)
    got = ev.get_performance(grids(pv, ppkg, True), pv, data)
    assert got["sub_names"] == want["sub_names"]
    assert got["sub_names"]["APGD"] == ["APGD_eps_0.01568627450980392_loss_ce_norm_linf",
                                        "APGD_eps_0.03137254901960784_loss_ce_norm_linf"]
    assert got["sub_names"]["CW"] == ["CW_c_0.1", "CW_c_10.0"]
    assert got["group_key"] == want["group_key"]
    for key in want["fooling_rate"]:
        assert got["fooling_rate"][key] == pytest.approx(want["fooling_rate"][key], abs=0)
        for metric in ("rmse", "mse"):
            np.testing.assert_allclose(got[metric][key], want[metric][key], rtol=5e-5)
