"""The port's ``vision.transforms`` and image backend against the JAX
package's, on the CPU.

Spec: ``tests/test_transforms_extra.py``.  Every class and functional runs
on the same seeded uint8 and float HWC images in both packages, the
random ones after the same ``random.seed`` (and ``np.random.seed`` for
``RandomErasing``'s random fill): both compute in numpy, so every result
must be bitwise equal, and the two packages must leave Python's
``random`` in the same state.  A transform given its own
``random.Random`` draws from it alone, as the module's ``random`` seeded
alike would.
"""
import random

import numpy as np
import pytest
import torch

from paddle_tpu.vision import image as jimage
from paddle_tpu.vision import transforms as JT
import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import image as timage
from paddle_tpu_torch.vision import transforms as TT


def _img(dtype, h=13, w=17, c=3, seed=0):
    rs = np.random.RandomState(seed)
    if dtype == "uint8":
        return rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    return rs.rand(h, w, c).astype(np.float32)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _run(make, img, seed=5):
    """``make(module)(img)`` in both packages after the same seeds;
    the results equal and ``random``'s state the same after each."""
    out = []
    for mod in (JT, TT):
        random.seed(seed)
        np.random.seed(seed)
        out.append(make(mod)(img.copy()))
        out.append(random.random())
    _equal(out[2], out[0])
    assert out[3] == out[1]
    return out[2]


CLASSES = {
    "Compose": lambda T: T.Compose([T.CenterCrop(8), T.ToTensor()]),
    "ToTensor": lambda T: T.ToTensor(),
    "ToTensor_HWC": lambda T: T.ToTensor("HWC"),
    "Normalize": lambda T: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                       data_format="HWC"),
    "Resize_int": lambda T: T.Resize(7),
    "Resize_pair": lambda T: T.Resize((9, 20)),
    "CenterCrop": lambda T: T.CenterCrop((6, 9)),
    "RandomCrop": lambda T: T.RandomCrop(8, padding=2),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(0.5),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(0.5),
    "Transpose": lambda T: T.Transpose(),
    "BrightnessTransform": lambda T: T.BrightnessTransform(0.4),
    "ContrastTransform": lambda T: T.ContrastTransform(0.4),
    "SaturationTransform": lambda T: T.SaturationTransform(0.4),
    "HueTransform": lambda T: T.HueTransform(0.3),
    "ColorJitter": lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "Grayscale": lambda T: T.Grayscale(3),
    "Pad": lambda T: T.Pad((1, 2, 3, 4), fill=7),
    "Pad_reflect": lambda T: T.Pad(2, padding_mode="reflect"),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(9),
    "RandomResizedCrop_pair": lambda T: T.RandomResizedCrop(
        (6, 10), scale=(0.5, 1.0)),
    "RandomRotation": lambda T: T.RandomRotation(30, fill=3),
    "RandomRotation_expand": lambda T: T.RandomRotation(40, expand=True),
    "RandomAffine": lambda T: T.RandomAffine(
        20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=(-5, 5, -3, 3)),
    "RandomAffine_shear": lambda T: T.RandomAffine(10, shear=8),
    "RandomPerspective": lambda T: T.RandomPerspective(1.0, 0.4),
    "RandomErasing": lambda T: T.RandomErasing(1.0),
    "RandomErasing_random": lambda T: T.RandomErasing(1.0,
                                                      value="random"),
}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_transform_classes_bitwise(name, dtype):
    for seed in (5, 6, 7):
        _run(CLASSES[name], _img(dtype), seed)


FUNCTIONALS = {
    "to_tensor": lambda T, a: T.to_tensor(a),
    "normalize": lambda T, a: T.normalize(a.transpose(2, 0, 1), 0.5, 0.25),
    "resize": lambda T, a: T.resize(a, 10),
    "hflip": lambda T, a: T.hflip(a),
    "vflip": lambda T, a: T.vflip(a),
    "center_crop": lambda T, a: T.center_crop(a, 5),
    "adjust_brightness": lambda T, a: T.adjust_brightness(a, 1.7),
    "adjust_contrast": lambda T, a: T.adjust_contrast(a, 0.6),
    "adjust_saturation": lambda T, a: T.adjust_saturation(a, 1.4),
    "adjust_hue": lambda T, a: T.adjust_hue(a, -0.2),
    "to_grayscale": lambda T, a: T.to_grayscale(a),
    "pad": lambda T, a: T.pad(a, (2, 3), fill=1),
    "pad_edge": lambda T, a: T.pad(a, 1, padding_mode="edge"),
    "pad_symmetric": lambda T, a: T.pad(a, [1, 0, 2, 3],
                                        padding_mode="symmetric"),
    "crop": lambda T, a: T.crop(a, 2, 3, 5, 6),
    "erase": lambda T, a: T.erase(a, 1, 2, 4, 5, 9),
    "affine": lambda T, a: T.affine(a, 15, (1, -2), 1.1, (4, 2)),
    "rotate": lambda T, a: T.rotate(a, 33, center=(4, 5)),
    "rotate_expand": lambda T, a: T.rotate(a, 70, expand=True, fill=2),
    "perspective": lambda T, a: T.perspective(
        a, [(0, 0), (16, 0), (16, 12), (0, 12)],
        [(1, 2), (15, 0), (14, 11), (2, 10)]),
}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
def test_functionals_bitwise(name, dtype):
    img = _img(dtype, seed=1)
    _equal(FUNCTIONALS[name](TT, img.copy()),
           FUNCTIONALS[name](JT, img.copy()))


def test_grayscale_image_and_hue_range():
    gray = _img("uint8", c=1)[..., 0]
    _equal(TT.ToTensor()(gray), JT.ToTensor()(gray))
    _equal(TT.resize(gray, (4, 5)), JT.resize(gray, (4, 5)))
    with pytest.raises(ValueError):
        TT.adjust_hue(_img("uint8"), 0.7)
    with pytest.raises(ValueError):
        TT.HueTransform(0.6)


def test_resize_takes_nearest_neighbours():
    """``Resize`` ignores ``interpolation``, as the JAX package's does."""
    img = _img("uint8", h=4, w=6)
    out = TT.Resize((2, 3), interpolation="bilinear")(img)
    _equal(out, img[::2, ::2])


@pytest.mark.parametrize("name", ["RandomCrop", "RandomResizedCrop",
                                  "ColorJitter", "RandomAffine",
                                  "RandomPerspective", "RandomErasing",
                                  "RandomHorizontalFlip"])
def test_own_random_generator(name):
    """``rng=random.Random(s)`` gives what ``random.seed(s)`` gives, and
    leaves the module's ``random`` alone."""
    img = _img("uint8", seed=3)
    t = CLASSES[name](TT)
    random.seed(11)
    want = t(img.copy())
    t.rng = random.Random(11)
    for sub in getattr(t, "transforms", []):
        sub.rng = t.rng
    random.seed(99)
    got = t(img.copy())
    after = random.random()
    random.seed(99)
    assert after == random.random()
    _equal(got, want)


def test_generator_is_a_keyword():
    own = random.Random(0)
    assert TT.RandomCrop(8).rng is None
    assert TT.RandomResizedCrop(9, rng=own).rng is own
    cj = TT.ColorJitter(0.1, 0.1, 0.1, 0.1, rng=own)
    assert all(t.rng is own for t in cj.transforms)


def test_image_backend(tmp_path):
    from PIL import Image

    img = _img("uint8", seed=2)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    assert timage.get_image_backend() == jimage.get_image_backend() == "pil"
    with pytest.raises(ValueError, match="backend"):
        timage.set_image_backend("numpy")
    pil = timage.image_load(path)
    _equal(np.asarray(pil), np.asarray(jimage.image_load(path)))
    with paddle.device_guard("cpu"):
        t = timage.image_load(path, backend="tensor")
    assert t.dtype == torch.uint8 and tuple(t.shape) == (3, 13, 17)
    _equal(t.numpy(), np.asarray(jimage.image_load(path, "tensor").numpy()))
    timage.set_image_backend("tensor")
    try:
        assert paddle.vision.get_image_backend() == "tensor"
    finally:
        timage.set_image_backend("pil")
