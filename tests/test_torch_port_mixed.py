"""The port's bf16 mixed precision (``perturb_dtype="bfloat16"``) against the
JAX package's, on the tiny victim (n_img 6, batch 4, K 8, 32x32) with the
same state, dictionary and weights carried across.

The JAX functions are compiled with ``xla_allow_excess_precision`` off, so
that XLA rounds to bf16 wherever the JAX code casts to it. By default XLA
may keep fp32 between two casts (a bf16 sum that feeds an fp32
convolution is never rounded), and then the bf16 gradients differ from the
code's own rounding by several percent: enough to flip AdamW's first step
on many D entries. With it off, both packages round at the same places and
differ only in the order of their fp32 sums.

Tolerances, from one bf16 rounding (2^-8 relative): a sum that lands on
another side of a bf16 rounding boundary changes one value by one bf16 unit,
2^-8 of it. So the losses agree within rtol 2^-8 and the fooling counts
exactly; an AdamW step moves an entry by at most its lr, and a 2^-8
relative change of its gradient moves that by 2^-8 of it, so after s steps
D and v agree within 2^-8 * lr * s; the solvers' adversaries move by
code_lr a step in z (or v) and D D† spreads that over the pixels, so they
agree within 4 * 2^-8 * code_lr * steps. Against JAX compiled by default,
the losses hold the JAX package's own bf16-against-fp32 tolerance (rtol
0.02, ``tests/test_mixed_precision.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.models.convert import train_state_from_jax
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import t, victim_pair
from test_torch_port_zoo import zoo_pair

N_IMG, BATCH, K, SIZE = 6, 4, 8, 32
ULP = 2.0 ** -8  # one bf16 rounding, relative
EXACT = {"xla_allow_excess_precision": False}
STEPS = [
    (np.array([3, 0, 5, 0]), np.array([1, 1, 1, 0])),
    (np.array([1, 2, 4, 3]), np.array([1, 1, 1, 1])),
    (np.array([5, 0, 2, 0]), np.array([1, 1, 1, 0])),
]


def exact(fn, *args):
    """``fn`` compiled by XLA with bf16 rounded at every cast."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)


@pytest.fixture(scope="module")
def setup():
    jv, variables, pv = victim_pair("tiny")
    images = np.random.RandomState(0).uniform(0.0, 1.0, (N_IMG, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray(jcore.predict_labels(jv.apply_fn, variables, jnp.asarray(images)))
    return jv, variables, pv, images, labels


def _cfgs(**kw):
    kw = dict(n_atoms=K, batch_size=BATCH, perturb_dtype="bfloat16", **kw)
    return jcore.AdilConfig(**kw), core.AdilConfig(**kw)


@pytest.mark.parametrize("loss", ["logits", "ce"])
def test_bf16_gd_steps_match_jax(setup, loss):
    jv, variables, pv, images, labels = setup
    jcfg, cfg = _cfgs(loss=loss)
    jstate0 = jcore.init_state(jax.random.PRNGKey(1), (SIZE, SIZE, 3), N_IMG, jcfg)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate0), device="cpu")
    jstep_fn = jcore.make_train_step(jv.apply_fn, jcfg, "both")
    step = core.make_train_step(pv, cfg, "both")
    jstate, jdefault = jstate0, jstate0
    for s, (idx, mask) in enumerate(STEPS, start=1):
        args = (variables, jnp.asarray(images[idx]), jnp.asarray(labels[idx]),
                jnp.asarray(idx), jnp.asarray(mask, jnp.float32))
        jstate, jloss, jfool = exact(jstep_fn, jstate, *args)(jstate, *args)
        jdefault, jloss_default, _ = jax.jit(jstep_fn)(jdefault, *args)
        loss_t, fool_t = step(state, t(images[idx]), torch.tensor(labels[idx], dtype=torch.long),
                              torch.tensor(idx), t(mask))
        np.testing.assert_allclose(float(loss_t), float(jloss), rtol=ULP)
        np.testing.assert_allclose(float(loss_t), float(jloss_default), rtol=0.02)
        assert float(fool_t) == float(jfool)
        lr_steps = ULP * cfg.step_size * s
        np.testing.assert_allclose(state.d.numpy(), np.asarray(jstate.d), atol=lr_steps, rtol=0)
        np.testing.assert_allclose(state.v.numpy(), np.asarray(jstate.v), atol=lr_steps, rtol=0)
        # The master state and its moments stay fp32 and projected.
        assert all(x.dtype == torch.float32 for x in (state.d, state.v, state.d_mu, state.v_nu))
        assert float(state.d.abs().max()) <= 1.0
        assert float(state.v.abs().sum(1).max()) <= cfg.eps + 1e-6
    assert state.d_count == state.v_count == len(STEPS)


@pytest.mark.parametrize("solver", ["supervised_ddrague", "supervised_adamw_codes"])
def test_bf16_solvers_match_jax(setup, solver):
    jv, variables, pv, images, _ = setup
    steps = 5
    jcfg, cfg = _cfgs(loss="ce", steps_inference=steps, steps_code=steps)
    d = np.random.RandomState(5).uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)

    def jax_solver(variables, d, x):
        return getattr(jcore, solver)(jv.apply_fn, variables, d, x, jcfg)

    args = (variables, jnp.asarray(d), jnp.asarray(images))
    want = np.asarray(exact(jax_solver, *args)(*args))
    got = getattr(core, solver)(pv, t(d), t(images), cfg)
    assert got.dtype == torch.float32  # read off in fp32
    np.testing.assert_allclose(got.numpy(), want, atol=4 * ULP * cfg.code_lr * steps, rtol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    if solver == "supervised_adamw_codes":  # its hard budget holds in bf16
        assert float((got - t(images)).abs().max()) <= cfg.eps + 1e-5
    # Close to the fp32 solver, as the JAX package holds its own.
    fp32 = getattr(core, solver)(pv, t(d), t(images), dataclasses.replace(cfg, perturb_dtype="float32"))
    assert float((got - fp32).abs().max()) < 0.05


def test_bf16_victim_input_matches_jax():
    # A normalizing victim: both wrappers normalize a bf16 input in bf16,
    # then the fp32 layers take it (ResNet-18 at 32x32).
    jv, pv = zoo_pair("resnet18", 32)
    x = np.random.RandomState(2).uniform(0.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(exact(jv.apply_fn, jv.variables, xb)(jv.variables, xb))
    got = pv(t(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ULP * scale, rtol=0)
    # bf16 really reached the net: the fp32 input gives other logits.
    assert float((pv(t(x)) - got).abs().max()) > 0


def test_resident_set_is_held_in_bf16(setup, tmp_path, monkeypatch):
    # The gd resident path gathers bf16 images; their labels come from fp32.
    _, _, pv, images, labels = setup
    seen = []
    real = core.preslice_epoch

    def recording(imgs, labs, batches):
        seen.append((imgs.dtype, labs.clone()))
        return real(imgs, labs, batches)

    monkeypatch.setattr(core, "preslice_epoch", recording)
    attack = ADIL(pv, n_atoms=K, steps=2, batch_size=BATCH, loss="ce", perturb_dtype="bfloat16",
                  cache=ArtifactCache(str(tmp_path)), data_train=(images, np.zeros(N_IMG)))
    assert attack.cfg.perturb_dtype == "bfloat16"
    assert [dtype for dtype, _ in seen] == [torch.bfloat16] * 2
    np.testing.assert_array_equal(seen[0][1].numpy(), labels)
    # The same epochs on the core step over bf16-cast images give the same D.
    g = torch.Generator().manual_seed(0)
    state = core.init_state(g, (SIZE, SIZE, 3), N_IMG, attack.cfg)
    step = core.make_train_step(pv, attack.cfg, "both")
    x16 = t(images).to(torch.bfloat16)
    for _ in range(2):
        core.run_epoch(step, state, *real(x16, torch.tensor(labels, dtype=torch.long),
                                          core.make_batches(g, N_IMG, BATCH)))
    np.testing.assert_array_equal(attack.dictionary.reshape(K, -1).numpy(), state.d.numpy())


def test_perturb_dtype_is_validated():
    assert core.AdilConfig(perturb_dtype="bfloat16").compute_dtype == torch.bfloat16
    assert core.AdilConfig().compute_dtype is None
    for bad in ("bf16", "float16"):
        with pytest.raises(ValueError, match="perturb_dtype"):
            core.AdilConfig(perturb_dtype=bad)
