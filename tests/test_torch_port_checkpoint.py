"""Artifacts move between the packages: the port's msgpack codec writes the
bytes flax writes, a dictionary saved by either ArtifactCache loads
bit-exactly in the other, and the port's ADIL serves a JAX-saved dictionary
as the JAX class does (atol 1e-5 after 5 DDrague steps)."""

import dataclasses

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache, msgpack_codec

from _torch_port import t, victim_pair


def _payload(rs):
    return {
        "d": rs.uniform(-1.0, 1.0, (8, 32, 32, 3)).astype(np.float32),
        "v": rs.uniform(0.0, 0.03, (5, 8)).astype(np.float32),
        "loss": np.asarray([0.5, 0.25, 0.125]),
        "val_fooling": np.asarray(0.75),
        "labels": rs.randint(0, 1000, 7).astype(np.int32),
    }


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        np.testing.assert_array_equal(a[key], b[key])


def test_same_bytes_as_flax(tmp_path):
    payload = _payload(np.random.RandomState(0))
    jax_path = JaxArtifactCache(str(tmp_path / "jax")).save(payload, "ImageNet", model="tiny")
    port_path = ArtifactCache(str(tmp_path / "port")).save(payload, "ImageNet", model="tiny")
    assert port_path.endswith("ImageNet_model_tiny.msgpack")
    with open(jax_path, "rb") as f1, open(port_path, "rb") as f2:
        assert f1.read() == f2.read()


def test_jax_saved_dictionary_loads_bit_exactly_in_the_port(tmp_path):
    payload = _payload(np.random.RandomState(1))
    JaxArtifactCache(str(tmp_path)).save(payload, "ImageNet", model="resnet50")
    cache = ArtifactCache(str(tmp_path))
    assert cache.exists("ImageNet", model="resnet50")
    _assert_same(cache.load("ImageNet", model="resnet50"), payload)


def test_port_saved_dictionary_loads_bit_exactly_in_jax(tmp_path):
    payload = _payload(np.random.RandomState(2))
    ArtifactCache(str(tmp_path)).save({k: torch.from_numpy(v) for k, v in payload.items()},
                                      "ImageNet", model="resnet50")
    loaded = JaxArtifactCache(str(tmp_path)).load("ImageNet", model="resnet50")
    _assert_same({k: np.asarray(v) for k, v in loaded.items()}, payload)
    cache = ArtifactCache(str(tmp_path))
    cache.remove("ImageNet", model="resnet50")
    assert cache.load("ImageNet", model="resnet50") is None


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": -1, "c": 127, "d": 128, "e": -32, "f": -33, "g": 255, "h": 256,
     "i": 65535, "j": 65536, "k": 2**32, "l": -129, "m": -(2**15) - 1, "n": -(2**31) - 1,
     "o": 2**63},
    {"s": "x" * 31, "t": "y" * 32, "u": "z" * 300, "v": "w" * 70000, "b": b"\x00" * 300},
    {"f": 0.1, "n": None, "t": True, "x": False, "l": [1, [2, "three"], {"k": 4.5}]},
    {f"key{i:02d}": i for i in range(20)},
    [list(range(20)), b"", ""],
])
def test_codec_matches_msgpack_for_plain_values(obj):
    def key_sorted(o):  # the codec writes map keys sorted, as flax does
        if isinstance(o, dict):
            return {k: key_sorted(o[k]) for k in sorted(o)}
        return [key_sorted(x) for x in o] if isinstance(o, list) else o

    assert msgpack_codec.pack(obj) == msgpack.packb(key_sorted(obj), use_bin_type=True)
    assert msgpack_codec.unpack(msgpack.packb(obj, use_bin_type=True)) == obj


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "uint8", "bool"])
def test_codec_arrays_round_trip(dtype):
    arr = (np.random.RandomState(0).uniform(-5, 5, (3, 4, 5))).astype(dtype)
    out = msgpack_codec.unpack(msgpack_codec.pack({"a": arr}))["a"]
    assert out.dtype == arr.dtype and out.flags.writeable
    np.testing.assert_array_equal(out, arr)


def test_codec_refuses_what_it_does_not_support():
    with pytest.raises(TypeError):
        msgpack_codec.pack({"x": np.float32(1.0)})  # flax's ext type 3
    with pytest.raises(TypeError):
        msgpack_codec.pack({1: 2})
    with pytest.raises(TypeError):
        msgpack_codec.unpack(msgpack.packb(msgpack.ExtType(3, b"\x00")))
    chunked = {"d": {"__msgpack_chunked_array__": True, "shape": {"0": 1}, "chunks": {}}}
    with pytest.raises(ValueError, match="chunked"):
        msgpack_codec.unpack(msgpack.packb(chunked))
    with pytest.raises(NotImplementedError,
                       match='only orbax.*use backend="msgpack".*ckpt_sharded=True'):
        ArtifactCache("unused", backend="orbax")


def test_adil_forward_on_a_jax_artifact_matches_the_jax_class(tmp_path):
    jv, variables, pv = victim_pair("tiny")
    jv = dataclasses.replace(jv, variables=variables)
    rs = np.random.RandomState(4)
    d = rs.uniform(-1.0, 1.0, (8, 32, 32, 3)).astype(np.float32)
    x = rs.uniform(0.0, 1.0, (4, 32, 32, 3)).astype(np.float32)
    JaxArtifactCache(str(tmp_path)).save({"d": d}, "ImageNet", model="tiny")
    kw = dict(eps=8 / 255, n_atoms=8, loss="logits", steps_inference=5)
    want = JaxADIL(jv, cache=JaxArtifactCache(str(tmp_path)), **kw)(jnp.asarray(x))
    attack = ADIL(pv, cache=ArtifactCache(str(tmp_path)), **kw)
    assert attack.is_trained
    got = attack(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_adil_trains_where_the_jax_class_would_train(tmp_path):
    _, _, pv = victim_pair("tiny")
    cache = ArtifactCache(str(tmp_path))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    trained = ADIL(pv, n_atoms=8, steps=1, cache=cache, data_train=(x.numpy(), np.zeros(2)))
    assert trained.is_trained and cache.exists("ImageNet", model="tiny")
    assert trained.dictionary.shape == (8, 32, 32, 3)
    lazy = ADIL(pv, n_atoms=8, steps=1, steps_inference=2,
                cache=ArtifactCache(str(tmp_path / "lazy")))
    with pytest.raises(FileNotFoundError):
        lazy.forward_supervised_adamw(x)  # it serves only what exists
    assert not lazy.is_trained
    assert lazy(x).shape == x.shape  # forward learns on its batch first
    assert lazy.is_trained


def test_adil_raises_where_the_jax_class_would_train(tmp_path):
    # blocked=True and pipeline_epochs=True, once refused, now train as the
    # JAX class does and give the standard artifact: the tiny victim has no
    # space-to-depth stem, so blocked=True falls back to the standard layout.
    _, _, pv = victim_pair("tiny")
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    plain = ADIL(pv, n_atoms=8, steps=2, cache=ArtifactCache(str(tmp_path / "plain")),
                 data_train=(x.numpy(), np.zeros(2)), blocked=False, pipeline_epochs=False)
    for kwargs in (dict(blocked=True), dict(pipeline_epochs=True)):
        cache = ArtifactCache(str(tmp_path / str(sorted(kwargs))))
        trained = ADIL(pv, n_atoms=8, steps=2, cache=cache, data_train=(x.numpy(), np.zeros(2)),
                       **kwargs)
        assert cache.exists("ImageNet", model="tiny") and not trained.trained_blocked
        assert trained.dictionary.shape == (8, 32, 32, 3)
        assert torch.equal(trained.dictionary, plain.dictionary)
        assert trained.history["loss"] == plain.history["loss"]


def test_adil_trains_in_bf16_where_the_jax_class_would_train(tmp_path):
    # perturb_dtype="bfloat16" is ported (ADIL(mesh=...) is tested in
    # test_torch_port_parallel.py): it trains, checkpoints and resumes, keeps
    # an fp32 artifact, and serves fp32 adversaries.
    _, _, pv = victim_pair("tiny")
    x = torch.rand(6, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    kw = dict(n_atoms=8, steps=3, batch_size=4, perturb_dtype="bfloat16", steps_inference=2,
              data_train=(x.numpy(), np.zeros(6)))
    whole = ADIL(pv, cache=ArtifactCache(str(tmp_path / "whole")), **kw)
    cache = ArtifactCache(str(tmp_path / "resumed"))

    class Killed(Exception):
        pass

    saves = []

    def save_then_kill(state, generator, history):
        saves.append(state.epoch)
        if len(saves) == 2:
            raise Killed  # after the second epoch's checkpoint is due, before it is written
        ADIL._save_train_state(resumed_probe, state, generator, history)

    resumed_probe = ADIL(pv, cache=cache, **{**kw, "data_train": None})
    resumed_probe._save_train_state = save_then_kill
    resumed_probe.checkpoint_every = 1
    with pytest.raises(Killed):
        resumed_probe.learn_dictionary(kw["data_train"])
    assert cache.exists("ImageNet", model="tiny", kind="train_state_torch")
    resumed = ADIL(pv, cache=cache, checkpoint_every=1, **kw)
    assert resumed.history["loss"] == whole.history["loss"]
    np.testing.assert_array_equal(resumed.dictionary.numpy(), whole.dictionary.numpy())
    assert whole.dictionary.dtype == torch.float32
    assert not cache.exists("ImageNet", model="tiny", kind="train_state_torch")
    adv = whole(x[:2])
    assert adv.dtype == torch.float32 and adv.shape == (2, 32, 32, 3)


def test_adil_raises_on_a_folder_dataset(tmp_path):
    # Folder datasets train since the native loader was ported; one whose
    # files cannot be read raises when it is decoded up front (stream=False),
    # by the native loader or, without it, by PIL.
    from dl_attack_on_imagenet_tpu_torch.data import ImageNetFolder

    (tmp_path / "n0").mkdir()
    (tmp_path / "n0" / "a.JPEG").write_bytes(b"not a jpeg")
    folder = ImageNetFolder(str(tmp_path), image_size=32)
    _, _, pv = victim_pair("tiny")
    cache = ArtifactCache(str(tmp_path / "cache"))
    with pytest.raises(OSError):
        ADIL(pv, n_atoms=8, cache=cache, data_train=folder, stream=False)
    assert not cache.exists("ImageNet", model="tiny")


def test_unsupervised_calls_draw_fresh_codes(tmp_path):
    _, _, pv = victim_pair("tiny")
    cache = ArtifactCache(str(tmp_path))
    cache.save({"d": np.random.RandomState(5).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)},
               "ImageNet", model="tiny")
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    a = ADIL(pv, n_atoms=8, cache=cache, attack="unsupervised", trials=2, seed=3)
    b = ADIL(pv, n_atoms=8, cache=cache, attack="unsupervised", trials=2, seed=3)
    first = a(x)
    assert torch.equal(first, b(x))  # same seed, same call count
    assert not torch.equal(first, a(x))  # the next call draws anew
    assert float((first - x).abs().max()) <= 8 / 255 + 1e-6
