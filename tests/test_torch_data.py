"""The ImageNet directory loaders of the port against the JAX package's, on
the CPU, over a directory the test writes (``train/`` and ``val/``, JPEG and
PNG images of several aspect ratios):

* ``_list_val_samples`` (integer class folders map to their own index,
  other names to their sorted order), ``imagenet_val_batches`` (a last
  partial batch included) and ``imagenet_train_batches`` with its seed:
  equal to JAX's batches exactly (both are the same PIL + numpy pipeline);
* the native loader (``runtime/image_loader.cc``, built at first use into
  the port's build directory): within ``tests/test_native_loader.py``'s
  tolerance of the PIL pipeline (2/255 before normalization a pixel, a
  quarter of that on average), and equal to the JAX package's native
  batches;
* ``validate-quantized --images-dir`` on a tiny ViT: evaluation from
  ``val/`` and calibration from ``train/`` (through ``--native-loader``
  too, and the PIL pipeline with the JAX package's warning where the
  library does not build).
"""

import functools
import os

import numpy as np
import pytest
import torch

from fp8_quantization_tpu.eval import data as jdata
from fp8_quantization_tpu.eval import native_data as jnative
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch.eval import data as tdata
from fp8_quantization_tpu_torch.eval import native_data as tnative
from fp8_quantization_tpu_torch.models.vit import ViTSpec

Image = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

SIZE = 32


def write_images(root, classes=("0", "1", "2"), per_class=3, seed=0):
    """``root/{train,val}/<class>/img_<i>.{jpg,png}``: smooth gradients with
    noise, sides 40..90 (portrait and landscape)."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for ci, cls in enumerate(classes):
            d = root / split / cls
            d.mkdir(parents=True, exist_ok=True)
            for i in range(per_class):
                w, h = (int(v) for v in rng.integers(40, 90, size=2))
                yy, xx = np.mgrid[0:h, 0:w]
                arr = np.stack([xx * 255 / (w - 1), yy * 255 / (h - 1),
                                rng.uniform(0, 255, (h, w))], axis=-1).astype(np.uint8)
                img = Image.fromarray(arr)
                if (i + ci) % 2:
                    img.save(d / f"img_{i}.png")
                else:
                    img.save(d / f"img_{i}.jpg", quality=95)
    (root / "val" / classes[0] / "notes.txt").write_text("not an image")
    return root


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return write_images(tmp_path_factory.mktemp("imagenet"), classes=("0", "3", "7"))


def _equal_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for (x, y), (jx, jy) in zip(ours, theirs):
        assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    return ours


@pytest.mark.parametrize("classes", [("0", "3", "7"), ("cat", "ant", "dog")],
                         ids=["integer_classes", "named_classes"])
def test_samples_match_jax(tmp_path, classes):
    root = write_images(tmp_path, classes=classes, per_class=1)
    samples = tdata._list_val_samples(str(root / "val"))
    assert samples == jdata._list_val_samples(str(root / "val"))
    labels = sorted({lab for _, lab in samples})
    assert labels == ([0, 3, 7] if classes[0] == "0" else [0, 1, 2])


@pytest.mark.parametrize("batch,max_batches", [(4, None), (2, 3)])
def test_val_batches_match_jax(images, batch, max_batches):
    out = _equal_batches(
        tdata.imagenet_val_batches(str(images), batch, image_size=SIZE, max_batches=max_batches),
        jdata.imagenet_val_batches(str(images), batch, image_size=SIZE, max_batches=max_batches))
    assert out[0][0].shape == (batch, SIZE, SIZE, 3)
    assert sum(len(y) for _, y in out) == (9 if max_batches is None else batch * max_batches)


def test_train_batches_match_jax(images):
    _equal_batches(tdata.imagenet_train_batches(str(images), 4, image_size=SIZE, seed=5),
                   jdata.imagenet_train_batches(str(images), 4, image_size=SIZE, seed=5))
    a = next(tdata.imagenet_train_batches(str(images), 4, image_size=SIZE, seed=6))[0]
    b = next(tdata.imagenet_train_batches(str(images), 4, image_size=SIZE, seed=5))[0]
    assert not np.array_equal(a, b)


def test_native_loader_within_tolerance(images):
    """The native batches against the PIL pipeline's, and equal to the JAX
    package's native batches."""
    if not tnative.available():
        pytest.fail(f"the native loader did not build: {tnative.build_error}")
    path = tnative.library_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR and os.path.exists(path)
    native = list(tnative.imagenet_val_batches_native(str(images), 4, image_size=SIZE,
                                                      num_threads=2))
    pil = list(tdata.imagenet_val_batches(str(images), 4, image_size=SIZE))
    assert [len(y) for _, y in native] == [4, 4, 1]
    tol = 2.0 / 255.0 / min(tdata.IMAGENET_STD)
    for (x, y), (px, py) in zip(native, pil):
        np.testing.assert_array_equal(y, py)
        diff = np.abs(x - px)
        assert diff.max() <= tol and diff.mean() <= tol / 4
    if jnative.available():
        _equal_batches(native, jnative.imagenet_val_batches_native(str(images), 4,
                                                                   image_size=SIZE))
    with pytest.raises(IOError):
        tnative.preprocess_files([str(images / "val" / "0" / "notes.txt")], image_size=SIZE)


TINY_VIT = ViTSpec(hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64, patch_size=8,
                   image_size=SIZE, num_classes=10)


@pytest.mark.parametrize("loader", ["pil", "native", "native_unavailable"])
def test_cli_images_dir(images, tmp_path, monkeypatch, capsys, loader):
    """``--images-dir``: the eval batches are ``val/``'s (all 9 images at
    batch 4), the calibration batch ``train/``'s first (seed 10)."""
    from fp8_quantization_tpu_torch.eval import driver

    monkeypatch.setattr(tcli, "build_model", functools.partial(tcli.build_model, spec=TINY_VIT))
    seen = []
    real = driver.calibrate
    monkeypatch.setattr(driver, "calibrate", lambda model, batches, **kw: (
        seen.append(list(batches)), real(model, seen[-1], **kw))[1])
    if loader == "native_unavailable":
        monkeypatch.setattr(tnative, "available", lambda: False)
    argv = ["validate-quantized", "--architecture", "vit_quantized", "--no-cuda",
            "--images-dir", str(images), "--batch-size", "4", "--qmethod", "fp_quantizer",
            "--per-channel", "--act-quant-method", "allminmax", "--quantize-input",
            "--res-quantizer-flag", "--original-quantize-res", "--fp8-set-maxval",
            "--no-fp8-mse-include-mantissa-bits", "--approx-output-dir", str(tmp_path),
            "--num-workers", "2"] + ([] if loader == "pil" else ["--native-loader"])
    out = tcli.main(argv)
    assert out["images"] == 4 + 9 and np.isfinite(out["metrics"]["loss"])
    (x, y), = seen[0]
    jx, jy = next(jdata.imagenet_train_batches(str(images), 4, image_size=SIZE, seed=10))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    warned = "native loader unavailable, using PIL pipeline" in capsys.readouterr().out
    assert warned == (loader == "native_unavailable")
