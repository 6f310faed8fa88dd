"""Port ADiL training steps against the JAX core on the tiny victim (n_img 6,
batch 4 with one padded slot, K 8, 32x32): both packages start from one
state, carried over with ``train_state_from_jax``, and after every step v,
the loss and the fooling count agree within 1e-5 and D within 2e-3 of its
learning rate (2e-5 in the joint step, 4e-5 in the D phase).

Why D gets more room: AdamW's first steps move each entry by about
``lr * g / (|g| + 1e-8)``, so an entry whose gradient is near 1e-9 sees the
gradient's relative error scaled up by ~1e7. The tiny victim's input
gradient has such entries (cancellations in its backward), where the two
frameworks' fp32 backward passes differ by ~1e-11 in absolute terms; under
CE loss that moved one D entry in 24576 by 1.03e-5 at lr 0.01 on the first
step. Every other entry agrees to ~1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.models.convert import train_state_from_jax

from _torch_port import t, victim_pair

N_IMG, BATCH, K, SIZE = 6, 4, 8, 32
# (idx, mask) per step. The padded slot gathers row 0 with mask 0 beside a
# real row 0, so the gather's gradient must accumulate duplicates.
STEPS = [
    (np.array([3, 0, 5, 0]), np.array([1, 1, 1, 0])),
    (np.array([1, 2, 4, 3]), np.array([1, 1, 1, 1])),
    (np.array([5, 0, 2, 0]), np.array([1, 1, 1, 0])),
]


@pytest.fixture(scope="module")
def setup():
    jv, variables, pv = victim_pair("tiny")
    images = np.random.RandomState(0).uniform(0.0, 1.0, (N_IMG, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray(jcore.predict_labels(jv.apply_fn, variables, jnp.asarray(images)))
    np.testing.assert_array_equal(core.predict_labels(pv, t(images)).numpy(), labels)
    return jv, variables, pv, images, labels


def lab(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.long)


def _cfgs(**kw):
    kw = dict(n_atoms=K, batch_size=BATCH, **kw)
    return jcore.AdilConfig(**kw), core.AdilConfig(**kw)


def _states(jcfg, mode, seed=1):
    jstate = jcore.init_state(jax.random.PRNGKey(seed), (SIZE, SIZE, 3), N_IMG, jcfg, mode=mode)
    if mode == "alter":  # alter starts from v = 0, which gives D no gradient
        codes = jcore.init_codes(jax.random.PRNGKey(seed + 1), N_IMG, jcfg, "gd")
        jstate = jstate.replace(v=codes)
    return jstate, train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


def _assert_state_close(state, jstate, d_lr):
    np.testing.assert_allclose(state.d.numpy(), np.asarray(jstate.d), atol=2e-3 * d_lr, rtol=0)
    np.testing.assert_allclose(state.v.numpy(), np.asarray(jstate.v), atol=1e-5, rtol=0)


@pytest.mark.parametrize("update", ["both", "v", "d"])
@pytest.mark.parametrize("norm", ["linf", "l2"])
@pytest.mark.parametrize("loss", ["logits", "ce"])
def test_train_step_matches_jax(setup, update, norm, loss):
    jv, variables, pv, images, labels = setup
    jcfg, cfg = _cfgs(norm=norm, loss=loss, eps=0.5 if norm == "l2" else 8 / 255)
    mode = "gd" if update == "both" else "alter"
    jstate, state = _states(jcfg, mode)
    jstep = jax.jit(jcore.make_train_step(jv.apply_fn, jcfg, update))
    step = core.make_train_step(pv, cfg, update)
    for idx, mask in STEPS:
        jstate, jloss, jfool = jstep(jstate, variables, jnp.asarray(images[idx]),
                                     jnp.asarray(labels[idx]), jnp.asarray(idx),
                                     jnp.asarray(mask, jnp.float32))
        loss_t, fool_t = step(state, t(images[idx]), lab(labels[idx]),
                              torch.as_tensor(idx), t(mask))
        np.testing.assert_allclose(float(loss_t), float(jloss), atol=1e-5, rtol=0)
        assert float(fool_t) == float(jfool)
        _assert_state_close(state, jstate, cfg.step_size * (2 if update == "d" else 1))
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert (state.d_count, state.v_count) == (want.d_count, want.v_count)
    for name in ("d_mu", "d_nu", "v_mu", "v_nu"):
        np.testing.assert_allclose(getattr(state, name).numpy(), getattr(want, name).numpy(),
                                   atol=1e-6, rtol=0)


def test_train_step_moves_every_row_of_v(setup):
    # Rows outside the batch get a zero gradient, but AdamW's moments and
    # weight decay still move them once they have moments.
    _, _, pv, images, labels = setup
    jcfg, cfg = _cfgs(loss="logits")
    _, state = _states(jcfg, "gd")
    step = core.make_train_step(pv, cfg, "both")
    idx, mask = STEPS[0]
    step(state, t(images[idx]), lab(labels[idx]), torch.as_tensor(idx), t(mask))
    v1 = state.v.clone()
    idx = np.array([1, 2, 1, 2])
    step(state, t(images[idx]), lab(labels[idx]), torch.as_tensor(idx), t(np.ones(4)))
    moved = (state.v - v1).abs().sum(1) > 0
    assert bool(moved[[0, 3, 5]].all())  # rows 0, 3 and 5 sat out this batch


def test_two_presliced_epochs_match_jax(setup):
    jv, variables, pv, images, labels = setup
    jcfg, cfg = _cfgs(loss="logits")
    jstate, state = _states(jcfg, "gd", seed=2)
    jepoch = jcore.make_epoch_fn_presliced(jv.apply_fn, jcfg, "both")
    step = core.make_train_step(pv, cfg, "both")
    rs = np.random.RandomState(7)
    for _ in range(2):
        batches = np.concatenate([rs.permutation(N_IMG), -np.ones(2, np.int64)]).reshape(2, BATCH)
        jstate, jloss, jfool = jepoch(jstate, variables,
                                      *jcore.preslice_epoch(jnp.asarray(images), jnp.asarray(labels),
                                                            jnp.asarray(batches, jnp.int32)))
        loss, fool = core.run_epoch(step, state, *core.preslice_epoch(
            t(images), lab(labels), torch.as_tensor(batches)))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
        assert float(fool) == float(jfool)
        _assert_state_close(state, jstate, cfg.step_size)
    assert state.epoch == int(jstate.epoch) == 2


def test_train_scan_matches_repeated_steps(setup):
    _, _, pv, images, labels = setup
    jcfg, cfg = _cfgs(loss="logits")
    _, a = _states(jcfg, "gd")
    _, b = _states(jcfg, "gd")
    idx, mask = STEPS[0]
    batch = (t(images[idx]), lab(labels[idx]), torch.as_tensor(idx), t(mask))
    losses, foolings = core.make_train_scan(pv, cfg, "both", n_steps=3)(a, *batch)
    step = core.make_train_step(pv, cfg, "both")
    want = [step(b, *batch)[0] for _ in range(3)]
    assert losses.shape == foolings.shape == (3,)
    assert torch.equal(losses, torch.stack(want))
    assert torch.equal(a.d, b.d) and torch.equal(a.v, b.v) and a.d_count == 3


def test_make_batches_pads_with_minus_one():
    batches = core.make_batches(torch.Generator().manual_seed(0), 6, 4)
    assert batches.shape == (2, 4)
    flat = batches.flatten().tolist()
    assert flat[-2:] == [-1, -1] and sorted(flat[:-2]) == list(range(6))


@pytest.mark.parametrize("mode", ["gd", "alter"])
def test_init_state(mode):
    cfg = core.AdilConfig(n_atoms=K)
    state = core.init_state(torch.Generator().manual_seed(0), (4, 4, 3), 5, cfg, mode=mode)
    assert state.d.shape == (K, 48) and state.v.shape == (5, K)
    assert float(state.d.abs().max()) <= 1.0
    assert float(state.v.abs().sum(1).max()) <= cfg.eps + 1e-6
    if mode == "alter":
        assert not bool(state.v.any())
    d_init = torch.ones(K, 4, 4, 3)
    warm = core.init_state(torch.Generator().manual_seed(0), (4, 4, 3), 5, cfg, d_init=d_init)
    warm.d.add_(1.0)
    assert bool((d_init == 1).all())  # the state holds a copy
    assert (warm.d_count, warm.v_count, warm.epoch) == (0, 0, 0)


def test_train_state_from_jax_defaults_to_the_card(monkeypatch):
    # Like every entry point: no device named means CUDA, and no CUDA raises.
    jcfg, _ = _cfgs()
    jstate = jcore.init_state(jax.random.PRNGKey(0), (SIZE, SIZE, 3), N_IMG, jcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
