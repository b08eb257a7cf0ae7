"""The port's native batched image loader (``alink_tpu_torch/data/
native_loader.py``: ``native/loader.cc`` built by ``_build.build_host``),
its callers, and ``entry()``, against the JAX package on the CPU.

- the eight cases of ``tests/test_native_loader.py`` on the port's binding;
- the port's ``decode_resize_batch`` bit-equal to the JAX binding's, exact
  and with ``dct_scale``, on PNG, JPEG, a missing file, a tiny source and a
  source 4x the target or more.  The JAX binding is pointed at the port's
  built library (``_LIB_PATH``), so no test runs ``make -C native``;
- ``drivers.common.load_dfw`` through both packages with the native
  library on both sides: bit-equal raw stacks at a downscaling
  ``image_res``, where PIL's resize (the port's only decoder before it had
  the native one) differs from the C++ loader's by up to ~73 levels;
- ``ingest_dct_scale`` reaching the decoder from ``load_dfw`` and from
  ``run_alink_mtp``'s three loads;
- ``build_host``: hash-named under the build directory, atomic, the
  compiler's reason kept on failure; ``as_device``;
- ``entry()``'s forward against the JAX package's ``entry()`` on the same
  weights (probabilities within 2e-2, the CPU bound of the K1 tests).

Every test that needs the library skips, with the compiler's reason, where
it cannot be built (no ``g++``, or no libjpeg / libpng headers).
"""

from __future__ import annotations

import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from alink_tpu.config import ALinkConfig as JALinkConfig
from alink_tpu.data import loader as jloader
from alink_tpu.data import native_loader as jnative
from alink_tpu.drivers import common as jcommon
from alink_tpu_torch import _build
from alink_tpu_torch.config import ALinkConfig, MTPConfig
from alink_tpu_torch.convert import state_dict_from_flax
from alink_tpu_torch.data import loader, make_synthetic_dfw, synth
from alink_tpu_torch.data import native_loader
from alink_tpu_torch.data.loader import (PersonStacks, as_device,
                                         load_image_list)
from alink_tpu_torch.drivers import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(images):
    """A featurizer for both packages: the pixels, flattened."""
    return images.reshape(images.shape[0], -1)


@pytest.fixture
def lib():
    """The port's library, built (or found) under build/alink_tpu_torch/."""
    if not native_loader.available():
        pytest.skip("the native loader cannot be built here (needs g++ and "
                    "the libjpeg / libpng headers): "
                    f"{native_loader.build_error()}")
    return native_loader.get_lib()


@pytest.fixture
def jax_on_port_lib(lib, monkeypatch):
    """The JAX binding loads the port's library (the same ``loader.cc``
    and flags), so it never builds into ``native/``."""
    path = _build.build_host("alloader", [native_loader.SOURCE],
                             native_loader.FLAGS, native_loader.LIBS)
    monkeypatch.setattr(jnative, "_LIB_PATH", str(path))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    assert jnative.available()


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, ext in enumerate(["jpg", "png", "jpg", "png"]):
        arr = rng.integers(0, 255, (40 + 4 * i, 30 + 2 * i, 3),
                           dtype=np.uint8)
        p = str(d / f"img_{i}.{ext}")
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def _smooth(rng, size_hw, base=24):
    """A smooth photo: low-resolution noise, bilinearly upscaled."""
    low = rng.normal(128, 40, (base, base, 3)).clip(0, 255).astype(np.uint8)
    return np.asarray(Image.fromarray(low).resize(size_hw[::-1],
                                                  Image.BILINEAR))


# -- the eight cases of tests/test_native_loader.py, on the port's binding ---

def test_decode_shapes_and_range(lib, image_files):
    out, failures = native_loader.decode_resize_batch(image_files, (16, 24))
    assert failures == 0
    assert out.shape == (4, 24, 16, 3)  # (w, h) convention -> (n, h, w, 3)
    assert out.min() >= 0.0 and out.max() <= 255.0
    assert out.std() > 1.0


def test_png_decode_matches_pil(lib, image_files):
    png = [p for p in image_files if p.endswith(".png")][0]
    with Image.open(png) as im:
        w, h = im.size
        ref = np.asarray(im.convert("RGB"), np.float32)
    out, failures = native_loader.decode_resize_batch([png], (w, h))
    assert failures == 0
    np.testing.assert_allclose(out[0], ref, atol=0.51)


def test_jpeg_decode_close_to_pil(lib, image_files):
    jpg = [p for p in image_files if p.endswith(".jpg")][0]
    with Image.open(jpg) as im:
        w, h = im.size
        ref = np.asarray(im.convert("RGB"), np.float32)
    out, _ = native_loader.decode_resize_batch([jpg], (w, h))
    assert np.mean(np.abs(out[0] - ref)) < 2.0


def test_missing_file_zero_filled(lib, image_files, tmp_path):
    paths = [image_files[0], str(tmp_path / "nope.jpg")]
    out, failures = native_loader.decode_resize_batch(paths, (8, 8))
    assert failures == 1
    assert out[1].sum() == 0.0
    assert out[0].sum() > 0.0


def test_loader_backend_integration(lib, image_files):
    native = load_image_list(image_files, (12, 12), backend="native")
    pil = load_image_list(image_files, (12, 12), backend="pil")
    assert native.shape == pil.shape == (4, 12, 12, 3)
    assert abs(float(native.mean()) - float(pil.mean())) < 8.0


def test_dct_scale_identical_when_not_engaged(lib, image_files):
    exact, _ = native_loader.decode_resize_batch(image_files, (20, 27))
    fast, _ = native_loader.decode_resize_batch(image_files, (20, 27),
                                                dct_scale=True)
    np.testing.assert_array_equal(exact, fast)


def test_dct_scale_approximates_large_jpeg(lib, tmp_path):
    big = _smooth(np.random.default_rng(3), (512, 640))
    jpg, png = str(tmp_path / "big.jpg"), str(tmp_path / "big.png")
    Image.fromarray(big).save(jpg, quality=92)
    Image.fromarray(big).save(png)
    exact, _ = native_loader.decode_resize_batch([jpg, png], (80, 64))
    fast, _ = native_loader.decode_resize_batch([jpg, png], (80, 64),
                                                dct_scale=True)
    assert np.abs(exact[0] - fast[0]).mean() < 3.0
    assert np.abs(exact[0] - fast[0]).max() < 40.0
    assert not np.array_equal(exact[0], fast[0])  # it did engage
    np.testing.assert_array_equal(exact[1], fast[1])


def test_dct_scale_never_upscales_tiny_sources(lib, tmp_path):
    small = np.random.default_rng(4).integers(0, 255, (20, 18, 3),
                                              dtype=np.uint8)
    p = str(tmp_path / "small.jpg")
    Image.fromarray(small).save(p, quality=92)
    exact, _ = native_loader.decode_resize_batch([p], (64, 64))
    fast, _ = native_loader.decode_resize_batch([p], (64, 64),
                                                dct_scale=True)
    np.testing.assert_array_equal(exact, fast)


# -- bit for bit against the JAX binding --------------------------------------

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One file of each kind the decoder treats apart, and a target (w, h)
    for it: PNG and JPEG below 2x the target, a missing file, a source
    smaller than the target, and a JPEG 4x the target or more (the scaled
    decode engages)."""
    d = tmp_path_factory.mktemp("kinds")
    rng = np.random.default_rng(11)
    photo = _smooth(rng, (90, 70))
    Image.fromarray(photo).save(d / "photo.png")
    Image.fromarray(photo).save(d / "photo.jpg", quality=90)
    Image.fromarray(rng.integers(0, 255, (12, 10, 3), np.uint8)).save(
        d / "tiny.jpg", quality=90)
    Image.fromarray(_smooth(rng, (480, 400))).save(d / "large.jpg",
                                                   quality=90)
    return {"png": (str(d / "photo.png"), (48, 56)),
            "jpeg": (str(d / "photo.jpg"), (48, 56)),
            "missing": (str(d / "missing.jpg"), (48, 56)),
            "tiny": (str(d / "tiny.jpg"), (40, 40)),
            "large": (str(d / "large.jpg"), (96, 112))}


@pytest.mark.parametrize("dct_scale", [False, True])
@pytest.mark.parametrize("kind", ["png", "jpeg", "missing", "tiny", "large"])
def test_decode_matches_the_jax_binding(sources, jax_on_port_lib, kind,
                                        dct_scale):
    path, res = sources[kind]
    want, jfail = jnative.decode_resize_batch([path], res,
                                              dct_scale=dct_scale)
    got, tfail = native_loader.decode_resize_batch([path], res,
                                                   dct_scale=dct_scale)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tfail == jfail == int(kind == "missing")
    if kind == "large" and dct_scale:
        exact, _ = native_loader.decode_resize_batch([path], res)
        assert not np.array_equal(got, exact)    # the scaled decode ran


def test_auto_takes_native_and_native_raises_without_it(lib, sources,
                                                        monkeypatch):
    paths = [sources[k][0] for k in ("png", "jpeg", "large")]
    native, _ = native_loader.decode_resize_batch(paths, (48, 56))
    np.testing.assert_array_equal(load_image_list(paths, (48, 56)), native)
    np.testing.assert_array_equal(
        load_image_list(paths, (48, 56), backend="native"), native)
    assert not np.array_equal(
        load_image_list(paths, (48, 56), backend="pil"), native)
    with pytest.raises(ValueError, match="backend"):
        load_image_list(paths, (48, 56), backend="cv2")
    monkeypatch.setattr(native_loader, "available", lambda: False)
    with pytest.raises(RuntimeError, match="unavailable"):
        load_image_list(paths, (48, 56), backend="native")
    np.testing.assert_array_equal(
        load_image_list(paths, (48, 56)),
        load_image_list(paths, (48, 56), backend="pil"))


# -- the fault: the port decoded other pixels than the JAX package ----------

def _dfw_tree(tmp_path):
    return make_synthetic_dfw(str(tmp_path / "dfw"), num_people=3,
                              image_size=64, seed=7)


@pytest.mark.parametrize("res", [(32, 40), (24, 24)])
def test_load_dfw_stacks_match_jax_when_downscaling(tmp_path, monkeypatch,
                                                    jax_on_port_lib, res):
    """``load_dfw`` through both packages at an ``image_res`` below the
    64^2 sources: the same raw stacks and features, bit for bit.  On the
    port's PIL path (its only one before) they differ by tens of levels."""
    root = _dfw_tree(tmp_path)
    cfg = dict(data_dir_prefix=root, image_res=res)
    want = jcommon.load_dfw(JALinkConfig(**cfg), _flat)
    got = common.load_dfw(ALinkConfig(**cfg), _flat, device="cpu")
    for name in ("plain_raw", "dig_raw", "imp_feats"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.images, b.images)
    with monkeypatch.context() as m:
        m.setattr(native_loader, "available", lambda: False)
        pil = common.load_dfw(ALinkConfig(**cfg), _flat, device="cpu")
    assert np.abs(pil.plain_raw.images - want.plain_raw.images).max() > 5.0


def _tap(monkeypatch):
    """Record the ``dct_scale`` of every native decode, and its output."""
    calls = []
    real = native_loader.decode_resize_batch

    def tapped(paths, image_res, threads=None, dct_scale=False):
        out = real(paths, image_res, threads=threads, dct_scale=dct_scale)
        calls.append((dct_scale, out[0]))
        return out

    monkeypatch.setattr(native_loader, "decode_resize_batch", tapped)
    return calls


def test_ingest_dct_scale_reaches_the_decoder_from_load_dfw(
        tmp_path, jax_on_port_lib, monkeypatch):
    root = _dfw_tree(tmp_path)
    cfg = dict(data_dir_prefix=root, image_res=(24, 24),
               ingest_dct_scale=True)
    calls = _tap(monkeypatch)
    got = common.load_dfw(ALinkConfig(**cfg), _flat, device="cpu")
    assert [c[0] for c in calls] == [True] * 3
    want = jcommon.load_dfw(JALinkConfig(**cfg), _flat)
    exact = jcommon.load_dfw(JALinkConfig(**dict(cfg, ingest_dct_scale=False)),
                             _flat)
    np.testing.assert_array_equal(got.plain_raw.images,
                                  want.plain_raw.images)
    np.testing.assert_array_equal(got.dig_raw.images, want.dig_raw.images)
    np.testing.assert_array_equal(got.imp_feats.images,
                                  want.imp_feats.images)
    assert not np.array_equal(got.plain_raw.images, exact.plain_raw.images)


def test_ingest_dct_scale_reaches_the_decoder_from_alink_mtp(
        tmp_path, jax_on_port_lib, monkeypatch):
    """``run_alink_mtp``'s three loads (the pool at the teacher's and the
    student's resolution, the gallery at the student's) pass the flag; each
    load equals the JAX package's ``load_person_stacks`` under it."""
    from alink_tpu_torch.drivers import alink_mtp as tmtp

    synth.make_synthetic_mtp(str(tmp_path / "train"), num_subjects=4,
                             image_size=16, seed=0)
    synth.make_synthetic_mtp(str(tmp_path / "test"), num_subjects=3,
                             image_size=16, seed=9)
    kw = dict(data_dir_prefix=str(tmp_path / "train"),
              test_dir=str(tmp_path / "test"),
              out_model=str(tmp_path / "post"),
              ensemble_basepath=str(tmp_path / "ens"),
              lowres_basemodel=str(tmp_path / "low"), noise=("gaussian",),
              image_res=(16, 16), normal_res=(16, 16), feature_res=768,
              low_res=12, lowres_epochs=1, highres_epochs=1, ft_epochs=1,
              alink_bs=2, batch_send=4, batch_size=8, seed=1,
              ingest_dct_scale=True)
    loads = []
    real_load = tmtp.load_person_stacks

    def load(groups, res, **k):
        loads.append((groups, res, k))
        return real_load(groups, res, **k)

    monkeypatch.setattr(tmtp, "load_person_stacks", load)
    calls = _tap(monkeypatch)
    tmtp.run_alink_mtp(MTPConfig(**kw), featurize=lambda x: _flat(x) / 256,
                       n_steps=8, device="cpu")
    assert len(loads) == len(calls) == 3
    assert [c[0] for c in calls] == [True] * 3
    for (groups, res, k), (_, flat) in zip(loads, calls):
        assert k == {"dct_scale": True}
        want = jloader.load_person_stacks(groups, res, dct_scale=True)
        np.testing.assert_array_equal(
            flat, want.images[want.mask()].reshape(flat.shape))


# -- build_host and as_device -------------------------------------------------

def test_build_host_names_by_hash_and_never_writes_into_native(
        lib, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    native_dir = os.path.join(REPO, "native")
    src = os.path.join(native_dir, "loader.cc")
    path = _build.build_host("alloader", [src], native_loader.FLAGS,
                             native_loader.LIBS)
    assert path.parent == tmp_path / "build"
    assert re.fullmatch(r"liballoader_[0-9a-f]{16}\.so", path.name)
    # Nothing of build_host's lands in native/ (the JAX package's own
    # `make -C native` may write liballoader.so there meanwhile).
    assert not [n for n in os.listdir(native_dir)
                if n.startswith("liballoader_") or n.endswith(".tmp")
                or n.endswith(".build.log")]
    assert sorted(p.name for p in path.parent.iterdir()) == [
        "alloader.build.log", path.name]          # no temporary left
    mtime = path.stat().st_mtime_ns
    assert _build.build_host("alloader", [src], native_loader.FLAGS,
                             native_loader.LIBS) == path
    assert path.stat().st_mtime_ns == mtime       # found, not rebuilt
    other = _build.build_host("alloader", [src], ("-O2", "-fPIC"),
                              native_loader.LIBS)
    assert other != path                          # the flags are hashed


def test_build_failure_keeps_the_compilers_reason(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    bad = tmp_path / "bad.cc"
    bad.write_text('#include "no_such_header_here.h"\n')
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no_such_header_here"):
        _build.build_host("bad", [bad], native_loader.FLAGS)
    assert not any(p.suffix == ".so" or p.name.endswith(".tmp")
                   for p in (tmp_path / "build").iterdir())
    # The binding reports the same reason and answers "unavailable".
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    assert not native_loader.available()
    assert "no_such_header_here" in native_loader.build_error()
    with pytest.raises(RuntimeError, match="no_such_header_here"):
        native_loader.decode_resize_batch([str(bad)], (8, 8))


def test_as_device_moves_the_pixels_once():
    rng = np.random.default_rng(2)
    stacks = PersonStacks(rng.uniform(0, 255, (3, 2, 4, 5, 3)).astype(
        np.float32), np.asarray([2, 1, 2], np.int32))
    moved = as_device(stacks, "cpu")
    assert isinstance(moved.images, torch.Tensor)
    assert moved.images.device == torch.device("cpu")
    np.testing.assert_array_equal(moved.images.numpy(), stacks.images)
    assert moved.counts is stacks.counts
    np.testing.assert_array_equal(moved.mask(), stacks.mask())
    assert loader.as_device is as_device


# -- entry() against the JAX package's --------------------------------------

def test_entry_forward_matches_jax():
    """The port's ``entry()`` forward on the JAX ``entry()``'s weights
    (converted) and on seeded random 112^2 pairs: the embeddings within
    2e-2 and the probabilities within 2e-2 of JAX's (both bf16).  JAX's
    r100 runs op by op (a jit of r100 compiles for ~25 s on the CPU)."""
    from __graft_entry__ import entry as jentry
    from alink_tpu_torch.tools.dryrun_multichip import entry

    jforward, (jep, jhp, jexample, _) = jentry()
    forward, (estate, hstate, example, _) = entry(device="cpu")
    assert tuple(example.shape) == tuple(jexample.shape) == (8, 112, 112, 3)
    ep = state_dict_from_flax(jax.tree.map(np.asarray, jep))
    hp = state_dict_from_flax(jax.tree.map(np.asarray, jhp))
    assert ep.keys() == estate.keys() and hp.keys() == hstate.keys()
    rng = np.random.default_rng(12)
    left, right = (rng.uniform(0, 255, (8, 112, 112, 3)).astype(np.float32)
                   for _ in range(2))
    from alink_tpu.models import ArcFaceResNet100 as JArcFace
    from alink_tpu_torch.convert import load_flax
    from alink_tpu_torch.models import ArcFaceResNet100

    jemb = np.asarray(JArcFace().apply(jep, jnp.asarray(left)))
    want = np.asarray(jforward(jep, jhp, left, right))
    with torch.no_grad():
        got = forward(ep, hp, torch.as_tensor(left), torch.as_tensor(right))
        emb = load_flax(ArcFaceResNet100(), jax.tree.map(np.asarray, jep))(
            torch.as_tensor(left))
    assert got.shape == (8, 2) and emb.shape == (8, 512)
    assert np.abs(emb.numpy() - jemb).max() < 2e-2
    assert np.abs(got.numpy() - want).max() < 2e-2
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)
