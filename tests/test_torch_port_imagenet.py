"""The port's class split, ImageNet folder reader, transform and native
loader against the JAX package: the same indices, samples, class names and
decoded arrays (all exact), the same shuffled loader order, and ADIL trained
straight from a folder of JPEGs."""

import os

import jax
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.data import ArrayDataset as JaxArrayDataset
from dl_attack_on_imagenet_tpu.data import ImageNetFolder as JaxImageNetFolder
from dl_attack_on_imagenet_tpu.data import default_transform as jax_default_transform
from dl_attack_on_imagenet_tpu.data import split_by_class as jax_split_by_class
from dl_attack_on_imagenet_tpu.runtime import HostLoader as JaxHostLoader
from dl_attack_on_imagenet_tpu.runtime import get_runtime as jax_get_runtime
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.data import (
    ArrayDataset,
    ImageNetFolder,
    default_transform,
    load_imagenet,
    read_synset_mapping,
    split_by_class,
)
from dl_attack_on_imagenet_tpu_torch.models.convert import train_state_from_jax
from dl_attack_on_imagenet_tpu_torch.runtime import HostLoader, get_runtime, host_loader
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import victim_pair

WNIDS = ["n01440764", "n01443537", "n01484850"]


def make_ilsvrc(root, sizes=((40, 60), (61, 37), (33, 33), (50, 99))):
    """A fake ILSVRC val tree: 3 classes of 4 JPEGs of odd sizes, and the
    synset mapping file. Returns the root."""
    from PIL import Image

    rng = np.random.default_rng(0)
    val = root / "ILSVRC" / "Data" / "val"
    for w in WNIDS:
        (val / w).mkdir(parents=True)
        for i, (h, wd) in enumerate(sizes):
            arr = (rng.random((h, wd, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(val / w / f"{w}_{i}.JPEG", quality=95)
    (root / "ILSVRC" / "LOC_synset_mapping.txt").write_text(
        "n01440764 tench, Tinca tinca\n"
        "n01443537 goldfish, Carassius auratus\n"
        "n01484850 great white shark, white shark\n")
    return str(root)


@pytest.fixture(scope="module")
def ilsvrc(tmp_path_factory):
    return make_ilsvrc(tmp_path_factory.mktemp("imagenet"))


@pytest.fixture(scope="module")
def runtimes():
    port = get_runtime()
    assert port is not None, f"the port's native loader did not build:\n{host_loader.build_error}"
    jax_rt = jax_get_runtime()
    assert jax_rt is not None, "the JAX package's native loader did not build"
    return port, jax_rt


@pytest.mark.parametrize("labels,per_class,classes", [
    (np.repeat(np.arange(5), 8), [4, 2, 2], 5),
    (np.repeat(np.arange(5), 8), [2, 1], 3),
    (np.asarray([0] * 5 + [1] * 9 + [2] * 7), [2, 2, 1], 3),  # uneven classes
    (np.random.RandomState(1).permutation(np.repeat(np.arange(4), 6)), [2, 1, 1], 4),
])
@pytest.mark.parametrize("seed", [0, 42])
def test_split_by_class_picks_the_jax_indices(labels, per_class, classes, seed):
    images = np.arange(len(labels), dtype=np.float32).reshape(-1, 1, 1, 1)
    got = split_by_class(ArrayDataset(images, labels), per_class, classes, seed)
    want = jax_split_by_class(JaxArrayDataset(images, labels), per_class, classes, seed)
    assert len(got) == len(want) == len(per_class)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)  # the row ids
        np.testing.assert_array_equal(g.labels, w.labels)


def test_split_by_class_raises_where_a_class_has_too_few():
    ds = ArrayDataset(np.zeros((4, 2, 2, 3)), np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="class 0 has 4 samples, need 5"):
        split_by_class(ds, [3, 2], number_of_classes=1)


def test_folder_scan_matches_jax(ilsvrc, tmp_path):
    for split_dir in (ilsvrc, os.path.join(ilsvrc, "ILSVRC", "Data", "val")):
        got, want = ImageNetFolder(split_dir), JaxImageNetFolder(split_dir)
        assert got.samples == want.samples and len(got) == 12
        assert got.wnids == want.wnids == WNIDS
        assert got.classes == want.classes
        assert got.class_to_idx == want.class_to_idx
    assert load_imagenet(ilsvrc).classes == ["tench", "goldfish", "great white shark"]
    mapping = read_synset_mapping(os.path.join(ilsvrc, "ILSVRC", "LOC_synset_mapping.txt"))
    assert mapping["n01484850"] == "great white shark, white shark"
    with pytest.raises(FileNotFoundError):
        ImageNetFolder(str(tmp_path))


@pytest.mark.parametrize("hw", [(100, 200), (37, 61), (61, 37), (257, 256), (300, 301), (99, 150)])
@pytest.mark.parametrize("size,resize", [(224, 256), (32, 40)])
def test_default_transform_is_the_jax_one(hw, size, resize):
    from PIL import Image

    arr = (np.random.default_rng(hw[0] * 1000 + hw[1]).random(hw + (3,)) * 255).astype(np.uint8)
    img = Image.fromarray(arr)
    got = default_transform(img, size=size, resize=resize)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_default_transform(img, size=size, resize=resize))


def test_materialize_matches_jax(ilsvrc, runtimes):
    port_rt, jax_rt = runtimes
    got, want = ImageNetFolder(ilsvrc, image_size=32), JaxImageNetFolder(ilsvrc, image_size=32)
    for rt_got, rt_want in ((None, None), (port_rt, jax_rt)):
        a = got.materialize([5, 0, 11], runtime=rt_got)
        b = want.materialize([5, 0, 11], runtime=rt_want)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(got[3][0], want[3][0])


def test_native_decode_is_the_jax_runtimes(ilsvrc, runtimes):
    port_rt, jax_rt = runtimes
    paths = [p for p, _ in ImageNetFolder(ilsvrc).samples]
    for size, resize in ((32, 40), (224, 256)):
        got = port_rt.decode_batch(paths, size, resize)
        assert got.shape == (12, size, size, 3)
        np.testing.assert_array_equal(got, jax_rt.decode_batch(paths, size, resize))
    with pytest.raises(IOError):
        port_rt.decode_batch([paths[0], "/nonexistent.JPEG"], 32)


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 7919), (True, 3)])
def test_iter_indexed_follows_the_jax_order(ilsvrc, runtimes, shuffle, seed):
    port_rt, jax_rt = runtimes
    folder = ImageNetFolder(ilsvrc)
    paths = [p for p, _ in folder.samples]
    labels = [label for _, label in folder.samples]
    got_loader = HostLoader(port_rt, paths, labels, 5, 32, shuffle=shuffle, seed=seed)
    want_loader = JaxHostLoader(jax_rt, paths, labels, 5, 32, shuffle=shuffle, seed=seed)
    got, want = list(got_loader.iter_indexed()), list(want_loader.iter_indexed())
    got_loader.close()
    want_loader.close()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    rows = np.concatenate([g[3] for g in got])
    assert sorted(rows[rows >= 0]) == list(range(12))  # every row once, then padding
    assert list(np.concatenate([g[2] for g in got])[-3:]) == [-1] * 3


def test_native_build_failure_is_reported(tmp_path, monkeypatch):
    broken = tmp_path / "host_loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(host_loader, "SOURCE", broken)
    monkeypatch.setattr(host_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_loader, "_runtime", None)
    monkeypatch.setattr(host_loader, "_tried", False)
    monkeypatch.setattr(host_loader, "build_error", None)
    assert host_loader.get_runtime() is None
    assert "failed for host_loader.cpp" in host_loader.build_error
    assert "not C++" in host_loader.build_error or "error" in host_loader.build_error
    assert not list((tmp_path / "build").glob("*.so"))


def _jpeg_training_setup(ilsvrc, tmp_path):
    """The tiny victim pair, the 12-JPEG folder at 32x32 for each package, and
    one ADIL configuration: 2 epochs of batches of 8 (one full, one with 4
    padding slots), CW loss."""
    jv, _, pv = victim_pair("tiny")
    kw = dict(steps=2, n_atoms=4, batch_size=8, loss="logits", seed=0, val_every=None,
              model_name="native")
    want = JaxADIL(jv, cache=JaxArtifactCache(str(tmp_path / "jax")), **kw)
    got = ADIL(pv, cache=ArtifactCache(str(tmp_path / "port")), **kw)
    return want, got, JaxImageNetFolder(ilsvrc, image_size=32), ImageNetFolder(ilsvrc, image_size=32)


def test_learn_dictionary_from_a_jpeg_folder_matches_jax(ilsvrc, runtimes, tmp_path, monkeypatch):
    # Both start from the JAX package's initial state (their generators
    # differ); both native loaders shuffle each epoch with the same seed.
    # Tolerances as in test_torch_port_train: loss, fooling and v 1e-5, D
    # 2e-3 of its learning rate.
    want, got, jfolder, folder = _jpeg_training_setup(ilsvrc, tmp_path)
    jstate = jcore.init_state(jax.random.PRNGKey(0), (32, 32, 3), 12, want.cfg, mode="gd")
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    monkeypatch.setattr(got, "_init", lambda *args: state)
    want.learn_dictionary(jfolder, None)
    got.learn_dictionary(folder, None)
    assert len(got.history["loss"]) == 2
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.history["fooling_rate"], want.history["fooling_rate"], atol=1e-5)
    assert got.dictionary.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got.dictionary.numpy(), np.asarray(want.dictionary),
                               atol=2e-3 * 0.01, rtol=0)
    saved = got.cache.load("ImageNet", model="native")
    np.testing.assert_allclose(saved["v"], np.asarray(want.cache.load("ImageNet", model="native")["v"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["gd", "alter"])
def test_folder_falls_back_to_decoded_arrays(ilsvrc, tmp_path, monkeypatch, method):
    # Without the native loader (or for alter) the folder is decoded with
    # PIL and trained on as arrays: the same run as on the decoded arrays.
    from dl_attack_on_imagenet_tpu_torch import runtime

    monkeypatch.setattr(runtime, "get_runtime", lambda: None)
    pv = victim_pair("tiny")[2]
    folder = ImageNetFolder(ilsvrc, image_size=32)
    runs = []
    for i, data in enumerate((folder, folder.materialize())):
        attack = ADIL(pv, steps=2, n_atoms=4, batch_size=8, method=method, seed=0,
                      cache=ArtifactCache(str(tmp_path / str(i))))
        attack.learn_dictionary(data, data)  # a folder val set is decoded too
        runs.append(attack)
    assert runs[0].history["val_fooling"] is not None
    assert runs[0].history == runs[1].history
    assert torch.equal(runs[0].dictionary, runs[1].dictionary)
