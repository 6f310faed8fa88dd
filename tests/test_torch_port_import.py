"""Reference artifacts imported by the port against the JAX package: the
five kinds (``adil``, ``adilr`` in both on-disk formats, ``uappgd``,
``fastuap``, ``universal``) from the same ``torch.save``d files, the same
refusals of a DDP module and of garbage, the ``cli.import_artifacts``
wrapper, and the port's attack classes serving from an imported artifact
as the JAX package's do.

Tolerances: the written payloads equal key by key and array by array (dtype,
shape, values); served adversaries within 1e-5 (``test_torch_port_checkpoint``'s
tolerance for 5 DDrague steps on the tiny victim); the Laplace fit of an
imported ADILR artifact within 1e-6 (``test_torch_port_adilr``'s).
"""

import dataclasses
import os
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.attacks import ADILR as JaxADILR
from dl_attack_on_imagenet_tpu.attacks import UAPPGD as JaxUAPPGD
from dl_attack_on_imagenet_tpu.cli import import_artifacts as jax_cli
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu.utils import import_reference as jax_ref
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL, ADILR, UAPPGD
from dl_attack_on_imagenet_tpu_torch.cli import import_artifacts as cli
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache
from dl_attack_on_imagenet_tpu_torch.utils import import_reference as ref

from _torch_port import t, victim_pair

K, SIZE, N = 4, 32, 6


def _artifacts(root):
    """Reference-format files of every kind, from one seed."""
    rs = np.random.RandomState(0)
    d = torch.tensor(rs.uniform(-1.0, 1.0, (3, SIZE, SIZE, K)).astype(np.float32))
    v = torch.tensor(rs.uniform(0.0, 0.01, (N, K)).astype(np.float32))
    e = torch.tensor(rs.uniform(-0.03, 0.03, (1, 3, SIZE, SIZE)).astype(np.float32))
    labels = torch.tensor(rs.randint(0, 10, N))
    paths = {
        "adil": [d, v, [0.5, 0.25], [0.1, 0.2], 0.75],
        "adilr_class": [d, v, [0.5, 0.4, 0.3], [0.1, 0.2, 0.3], 0.5],
        "adilr_solver": [d, labels, labels, v, torch.tensor([0.9, 0.8])],
        "uappgd": [e, [0.1, 0.3]],
        "fastuap": [e, 0.4],
    }
    out = {}
    for name, payload in paths.items():
        out[name] = str(root / f"{name}.bin")
        torch.save(payload, out[name])
    out["universal"] = str(root / "pert.npy")
    np.save(out["universal"], e.numpy())
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _artifacts(tmp_path_factory.mktemp("ref"))


def _import(module, cache_cls, kind, src, root):
    cache = cache_cls(str(root))
    if kind == "adil":
        return module.import_adil(src, cache, "tiny")
    if kind.startswith("adilr"):
        return module.import_adilr(src, cache, "tiny", 0.1, 0.1)
    return module.import_uap(src, cache, "tiny", {"uappgd": "UAPPGD", "fastuap": "FastUAP"}[kind])


def _assert_same_payload(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("kind", ["adil", "adilr_class", "adilr_solver", "uappgd", "fastuap"])
def test_imports_write_the_jax_payload(files, tmp_path, kind):
    got = _import(ref, ArtifactCache, kind, files[kind], tmp_path / "port")
    want = _import(jax_ref, JaxArtifactCache, kind, files[kind], tmp_path / "jax")
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()  # the same msgpack bytes
    prefix, key = _key(kind)
    _assert_same_payload(ArtifactCache(str(tmp_path / "port")).load(prefix, **key),
                         JaxArtifactCache(str(tmp_path / "jax")).load(prefix, **key))


def _key(kind):
    if kind == "adil":
        return "ImageNet", {"model": "tiny"}
    if kind.startswith("adilr"):
        return "ADILR", dict(model="tiny", lam1=0.1, lam2=0.1, atoms=K, steps=100,
                             tag="param_selecting")
    return {"uappgd": "UAPPGD", "fastuap": "FastUAP"}[kind], {"model": "tiny"}


def test_layout_conversions(files, tmp_path):
    d = np.random.RandomState(1).normal(size=(3, 5, 7, K)).astype(np.float32)
    np.testing.assert_array_equal(ref.ref_dict_to_atoms_first(d), jax_ref.ref_dict_to_atoms_first(d))
    assert ref.ref_dict_to_atoms_first(d).shape == (K, 5, 7, 3)
    e = d[..., 0]
    for arr in (e, e[None]):
        np.testing.assert_array_equal(ref.ref_image_to_nhwc(arr), jax_ref.ref_image_to_nhwc(arr))
    got = ref.import_universal(files["universal"], str(tmp_path / "port"))
    want = jax_ref.import_universal(files["universal"], str(tmp_path / "jax"))
    assert got.endswith("port.npy") and want.endswith("jax.npy")
    np.testing.assert_array_equal(np.load(got), np.load(want))
    assert np.load(got).shape == (SIZE, SIZE, 3) and np.load(got).dtype == np.float32


class _Module(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.d = torch.nn.Parameter(torch.zeros(3, 4, 4, 2))


def _errors(path, tmp_path):
    out = []
    for module, cache_cls in ((ref, ArtifactCache), (jax_ref, JaxArtifactCache)):
        with pytest.raises(ValueError) as err:
            module.import_adil(path, cache_cls(str(tmp_path / module.__name__)), "tiny")
        out.append(str(err.value))
    return out


def test_ddp_and_garbage_artifacts_get_the_jax_errors(tmp_path):
    cases = {}
    torch.save([_Module(), [0.1], [0.2]], tmp_path / "ddp.bin")
    cases["ddp.bin"] = "DDP-format artifact"
    # A module whose class cannot be imported where the file is read.
    fake = types.ModuleType("reference_attacks_only_there")
    cls = type("Attack_dict_model", (torch.nn.Module,), {"__module__": fake.__name__})
    fake.Attack_dict_model = cls
    sys.modules[fake.__name__] = fake
    try:
        torch.save([cls(), [0.1]], tmp_path / "foreign.bin")
    finally:
        del sys.modules[fake.__name__]
    cases["foreign.bin"] = "unpickling needs the reference's own classes"
    torch.save("not a list", tmp_path / "garbage.bin")
    cases["garbage.bin"] = r"expected the reference's \[d, v, ...\] list"
    torch.save([torch.zeros(3, 4, 4, 2), torch.zeros(5, 3)], tmp_path / "shapes.bin")
    cases["shapes.bin"] = "do not look like the reference's"
    for name, match in cases.items():
        got, want = _errors(str(tmp_path / name), tmp_path)
        assert got == want
        assert re.search(match, got), got
    for module in (ref, jax_ref):
        with pytest.raises(ValueError, match="kind must be UAPPGD or FastUAP"):
            module.import_uap(str(tmp_path / "garbage.bin"), None, "tiny", kind="ADIL")


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_cli_matches_the_jax_cli(files, tmp_path, capsys):
    assert _defaults(cli.build_argparser()) == _defaults(jax_cli.build_argparser())
    for kind in ("adil", "adilr", "uappgd", "fastuap"):
        src = files["adilr_solver" if kind == "adilr" else kind]
        argv = ["--kind", kind, "--src", src, "--model", "tiny"]
        got = cli.main(argv + ["--cache", str(tmp_path / "port")])
        want = jax_cli.main(argv + ["--cache", str(tmp_path / "jax")])
        with open(got, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read()
    got = cli.main(["--kind", "universal", "--src", files["universal"]])
    assert got == os.path.splitext(files["universal"])[0] + "_nhwc.npy" and os.path.exists(got)
    assert f"imported universal artifact -> {got}" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--kind", "adil", "--src", files["adil"]])  # --model is required
    with pytest.raises(NotImplementedError, match='use backend="msgpack".*ckpt_sharded=True'):
        cli.main(["--kind", "adil", "--src", files["adil"], "--model", "tiny",
                  "--cache", str(tmp_path / "orbax"), "--backend", "orbax"])


def test_classes_serve_from_imported_artifacts_as_jax_does(files, tmp_path):
    jv, variables, pv = victim_pair("tiny")
    jv = dataclasses.replace(jv, variables=variables)
    x = np.random.RandomState(4).uniform(0.0, 1.0, (N, SIZE, SIZE, 3)).astype(np.float32)
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    for module, cache_cls, root in ((ref, ArtifactCache, port_root),
                                    (jax_ref, JaxArtifactCache, jax_root)):
        module.import_adil(files["adil"], cache_cls(root), "tiny")
        module.import_uap(files["uappgd"], cache_cls(root), "tiny")
    kw = dict(n_atoms=K, loss="logits", steps_inference=5, eps=8 / 255)
    attack = ADIL(pv, cache=ArtifactCache(port_root), **kw)
    assert attack.is_trained
    want = JaxADIL(jv, cache=JaxArtifactCache(jax_root), **kw)(jnp.asarray(x))
    np.testing.assert_allclose(attack(t(x)).numpy(), np.asarray(want), atol=1e-5, rtol=0)
    uap = UAPPGD(pv, cache=ArtifactCache(port_root))
    assert uap.is_trained
    want = JaxUAPPGD(jv, cache=JaxArtifactCache(jax_root))(jnp.asarray(x))
    np.testing.assert_allclose(uap(t(x)).numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # ADILR from the solver format: the same dictionary, and the same
    # Laplace fit of the imported codes by the labels they were saved with.
    ref.import_adilr(files["adilr_solver"], ArtifactCache(port_root), "tiny", 0.1, 0.1)
    jax_ref.import_adilr(files["adilr_solver"], JaxArtifactCache(jax_root), "tiny", 0.1, 0.1)
    kw = dict(n_atoms=K, attack="unsupervised", data_train=(x, np.zeros(N, np.int64)))
    got = ADILR(pv, cache=ArtifactCache(port_root), **kw)
    want = JaxADILR(jv, cache=JaxArtifactCache(jax_root), **kw)
    assert got.is_trained
    np.testing.assert_array_equal(got._load_dictionary().numpy(),
                                  np.asarray(want._load_dictionary()))
    assert sorted(got.mean) == sorted(want.mean)
    for mode in got.mean:
        np.testing.assert_allclose(got.mean[mode], want.mean[mode], atol=1e-6)
        np.testing.assert_allclose(got.scale[mode], want.scale[mode], atol=1e-6)
