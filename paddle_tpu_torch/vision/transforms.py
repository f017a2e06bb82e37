"""Vision transforms (port of ``paddle_tpu/vision/transforms.py``).

Host-side numpy on HWC uint8 or float arrays, as the JAX package's: the
device sees only the batch that ``io.DataLoader`` makes of the results, and
every result is bitwise the JAX package's.  ``Resize`` and the resize of
``RandomResizedCrop`` take nearest neighbours whatever ``interpolation``
says, and ``affine``/``rotate``/``perspective`` sample bilinearly.

The random transforms draw from Python's ``random`` in the JAX package's
order, so one ``random.seed`` gives both packages the same crops, flips and
angles.  Each also takes ``rng=``, a ``random.Random`` of its own to draw
from instead (``ColorJitter`` hands its one to its four parts).
"""
from __future__ import annotations

import numbers
import random

import numpy as np

__all__ = [
    "Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
    "CenterCrop", "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
    "Transpose", "BrightnessTransform", "to_tensor", "normalize", "resize",
    "hflip", "vflip", "center_crop", "adjust_brightness", "adjust_contrast",
    "adjust_saturation", "adjust_hue", "to_grayscale", "pad", "crop", "erase",
    "affine", "rotate", "perspective", "ContrastTransform",
    "SaturationTransform", "HueTransform", "ColorJitter", "Grayscale", "Pad",
    "RandomResizedCrop", "RandomRotation", "RandomAffine",
    "RandomPerspective", "RandomErasing"
]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    #: the ``random.Random`` a random transform draws from; None draws from
    #: the ``random`` module's
    rng = None

    def __call__(self, img):
        return self._apply_image(img)

    @property
    def _random(self):
        return random if self.rng is None else self.rng


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, dtype=np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (arr - self.mean.reshape(shape)) / self.std.reshape(shape)


def _resize_np(arr, size):
    """Nearest-neighbor resize for HWC numpy arrays."""
    h, w = arr.shape[:2]
    if isinstance(size, numbers.Number):
        if h < w:
            nh, nw = size, int(w * size / h)
        else:
            nh, nw = int(h * size / w), size
    else:
        nh, nw = size
    rows = (np.arange(nh) * h / nh).astype(np.int64).clip(0, h - 1)
    cols = (np.arange(nw) * w / nw).astype(np.int64).clip(0, w - 1)
    return arr[rows][:, cols]


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = size

    def _apply_image(self, img):
        return _resize_np(np.asarray(img), self.size)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", rng=None):
        self.rng = rng
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.padding = padding

    def _apply_image(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            p = (p, p) if isinstance(p, numbers.Number) else p
            pads = [(p[1], p[1]), (p[0], p[0])] + \
                ([(0, 0)] if arr.ndim == 3 else [])
            arr = np.pad(arr, pads)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = self._random.randint(0, max(h - th, 0))
        j = self._random.randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, rng=None):
        self.rng = rng
        self.prob = prob

    def _apply_image(self, img):
        if self._random.random() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, rng=None):
        self.rng = rng
        self.prob = prob

    def _apply_image(self, img):
        if self._random.random() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, rng=None):
        self.rng = rng
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = 1 + self._random.uniform(-self.value, self.value)
        arr = np.asarray(img).astype(np.float32) * factor
        return arr.clip(0, 255).astype(np.asarray(img).dtype)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


# -- color / photometric functional ops (reference
# vision/transforms/functional.py adjust_* family; numpy host math) -----

def _as_float(img):
    arr = np.asarray(img)
    return arr.astype(np.float32), arr.dtype


def _restore(arr, dtype):
    if np.issubdtype(dtype, np.integer):
        return arr.clip(0, 255).astype(dtype)
    return arr.astype(dtype)


def adjust_brightness(img, brightness_factor):
    """out = img * factor (reference functional adjust_brightness)."""
    arr, dt = _as_float(img)
    return _restore(arr * brightness_factor, dt)


def adjust_contrast(img, contrast_factor):
    """Blend with the grayscale mean."""
    arr, dt = _as_float(img)
    gray = arr.mean() if arr.ndim == 2 else (
        arr[..., 0] * 0.299 + arr[..., 1] * 0.587
        + arr[..., 2] * 0.114).mean()
    return _restore(gray + contrast_factor * (arr - gray), dt)


def _rgb_to_hsv(arr):
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = np.max(arr, axis=-1)
    minc = np.min(arr, axis=-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc == 0, 0, d / np.maximum(maxc, 1e-12))
    rc = (maxc - r) / np.maximum(d, 1e-12)
    gc = (maxc - g) / np.maximum(d, 1e-12)
    bc = (maxc - b) / np.maximum(d, 1e-12)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(d == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out


def adjust_saturation(img, saturation_factor):
    arr, dt = _as_float(img)
    hsv = _rgb_to_hsv(arr / 255.0 if np.issubdtype(dt, np.integer)
                      else arr)
    hsv[..., 1] = np.clip(hsv[..., 1] * saturation_factor, 0, 1)
    out = _hsv_to_rgb(hsv)
    if np.issubdtype(dt, np.integer):
        out = out * 255.0
    return _restore(out, dt)


def adjust_hue(img, hue_factor):
    """hue_factor in [-0.5, 0.5] — shift the hue channel."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr, dt = _as_float(img)
    hsv = _rgb_to_hsv(arr / 255.0 if np.issubdtype(dt, np.integer)
                      else arr)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv)
    if np.issubdtype(dt, np.integer):
        out = out * 255.0
    return _restore(out, dt)


def to_grayscale(img, num_output_channels=1):
    arr, dt = _as_float(img)
    gray = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587
            + arr[..., 2] * 0.114)
    out = np.repeat(gray[..., None], num_output_channels, axis=-1)
    return _restore(out, dt)


def pad(img, padding, fill=0, padding_mode='constant'):
    arr = np.asarray(img)
    if isinstance(padding, numbers.Number):
        pl = pt = pr = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    pads = [(pt, pb), (pl, pr)] + [(0, 0)] * (arr.ndim - 2)
    if padding_mode == 'constant':
        return np.pad(arr, pads, mode='constant', constant_values=fill)
    mode = {'reflect': 'reflect', 'edge': 'edge',
            'symmetric': 'symmetric'}[padding_mode]
    return np.pad(arr, pads, mode=mode)


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width].copy()


def erase(img, i, j, h, w, v, inplace=False):
    """Zero/assign a region (reference functional erase — the
    RandomErasing primitive)."""
    arr = np.asarray(img) if inplace else np.asarray(img).copy()
    arr[i:i + h, j:j + w] = v
    return arr


def _affine_grid_sample(arr, matrix, out_h, out_w, fill=0):
    """Inverse-warp sampling with bilinear interpolation; matrix maps
    OUTPUT pixel coords to INPUT coords ([2, 3] affine)."""
    ys, xs = np.meshgrid(np.arange(out_h), np.arange(out_w),
                         indexing='ij')
    sx = matrix[0, 0] * xs + matrix[0, 1] * ys + matrix[0, 2]
    sy = matrix[1, 0] * xs + matrix[1, 1] * ys + matrix[1, 2]
    return _warp_sample(arr, sx, sy, fill)


def _warp_sample(arr, sx, sy, fill=0):
    """Bilinear gather at float source coords (sx, sy); out-of-bounds
    pixels take `fill`. Shared by affine, rotate and perspective."""
    H, W = arr.shape[:2]
    out_h, out_w = sx.shape
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = sx - x0
    wy = sy - y0
    out = np.zeros((out_h, out_w) + arr.shape[2:], np.float32)
    total_w = np.zeros((out_h, out_w), np.float32)
    for dy, wyv in ((0, 1 - wy), (1, wy)):
        for dx, wxv in ((0, 1 - wx), (1, wx)):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            xi_c = np.clip(xi, 0, W - 1)
            yi_c = np.clip(yi, 0, H - 1)
            wgt = (wxv * wyv * valid).astype(np.float32)
            sample = arr[yi_c, xi_c].astype(np.float32)
            out += sample * (wgt[..., None] if arr.ndim == 3 else wgt)
            total_w += wgt
    if np.isscalar(fill):
        fillv = fill
    else:
        fillv = np.asarray(fill, np.float32)
    miss = total_w <= 1e-6
    if arr.ndim == 3:
        out[miss] = fillv
    else:
        out[miss] = fill if np.isscalar(fill) else float(fill[0])
    return out.clip(0, 255).astype(arr.dtype) if np.issubdtype(
        arr.dtype, np.integer) else out.astype(arr.dtype)


def _affine_matrix(angle, translate, scale, shear, center):
    rot = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    cx, cy = center
    tx, ty = translate
    # forward matrix = T(center) R S Sh T(-center) T(translate)
    a = np.cos(rot - sy) / max(np.cos(sy), 1e-9)
    b = -np.cos(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) \
        - np.sin(rot)
    c = np.sin(rot - sy) / max(np.cos(sy), 1e-9)
    d = -np.sin(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) \
        + np.cos(rot)
    M = np.array([[a * scale, b * scale, 0.0],
                  [c * scale, d * scale, 0.0]], np.float64)
    M[0, 2] = cx + tx - (M[0, 0] * cx + M[0, 1] * cy)
    M[1, 2] = cy + ty - (M[1, 0] * cx + M[1, 1] * cy)
    # invert for sampling (output -> input)
    full = np.vstack([M, [0, 0, 1]])
    inv = np.linalg.inv(full)
    return inv[:2]


def affine(img, angle, translate, scale, shear, interpolation='nearest',
           fill=0, center=None):
    arr = np.asarray(img)
    H, W = arr.shape[:2]
    if center is None:
        center = ((W - 1) * 0.5, (H - 1) * 0.5)
    if isinstance(shear, numbers.Number):
        shear = (shear, 0.0)
    M = _affine_matrix(angle, translate, scale, shear, center)
    return _affine_grid_sample(arr, M, H, W, fill)


def rotate(img, angle, interpolation='nearest', expand=False, center=None,
           fill=0):
    arr = np.asarray(img)
    H, W = arr.shape[:2]
    if center is None:
        center = ((W - 1) * 0.5, (H - 1) * 0.5)
    if expand:
        rad = np.deg2rad(angle)
        new_w = int(abs(W * np.cos(rad)) + abs(H * np.sin(rad)) + 0.5)
        new_h = int(abs(H * np.cos(rad)) + abs(W * np.sin(rad)) + 0.5)
    else:
        new_w, new_h = W, H
    M = _affine_matrix(angle, (0, 0), 1.0, (0.0, 0.0), center)
    if expand:
        M[0, 2] += (W - new_w) * 0.5 * M[0, 0] + (H - new_h) * 0.5 * M[0, 1]
        M[1, 2] += (W - new_w) * 0.5 * M[1, 0] + (H - new_h) * 0.5 * M[1, 1]
    return _affine_grid_sample(arr, M, new_h, new_w, fill)


def perspective(img, startpoints, endpoints, interpolation='nearest',
                fill=0):
    """Warp mapping endpoints back to startpoints (reference functional
    perspective)."""
    arr = np.asarray(img)
    H, W = arr.shape[:2]
    A = []
    bvec = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        A.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        bvec += [sx, sy]
    coeffs = np.linalg.lstsq(np.asarray(A, np.float64),
                             np.asarray(bvec, np.float64), rcond=None)[0]
    a, b, c, d, e, f, g, h = coeffs
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    den = g * xs + h * ys + 1.0
    sx = (a * xs + b * ys + c) / den
    sy = (d * xs + e * ys + f) / den
    return _warp_sample(arr, sx, sy, fill)


# -- transform classes --------------------------------------------------

class ContrastTransform(BaseTransform):
    def __init__(self, value, rng=None):
        self.rng = rng
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_contrast(
            img, 1 + self._random.uniform(-self.value, self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value, rng=None):
        self.rng = rng
        if value < 0:
            raise ValueError("saturation value must be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_saturation(
            img, 1 + self._random.uniform(-self.value, self.value))


class HueTransform(BaseTransform):
    def __init__(self, value, rng=None):
        self.rng = rng
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img,
                          self._random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order
    (reference transforms ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng=None):
        self.rng = rng
        self.transforms = [BrightnessTransform(brightness, rng),
                           ContrastTransform(contrast, rng),
                           SaturationTransform(saturation, rng),
                           HueTransform(hue, rng)]

    def _apply_image(self, img):
        order = list(self.transforms)
        self._random.shuffle(order)
        for t in order:
            img = t(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode='constant'):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop then resize (reference
    RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation='bilinear', rng=None):
        self.rng = rng
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = np.asarray(img)
        H, W = arr.shape[:2]
        area = H * W
        for _ in range(10):
            target = self._random.uniform(*self.scale) * area
            ar = np.exp(self._random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                top = self._random.randint(0, H - h)
                left = self._random.randint(0, W - w)
                return _resize_np(crop(arr, top, left, h, w), self.size)
        return _resize_np(arr, self.size)   # fallback: whole image


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation='nearest', expand=False,
                 center=None, fill=0, rng=None):
        self.rng = rng
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = self._random.uniform(*self.degrees)
        return rotate(img, angle, expand=self.expand, center=self.center,
                      fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation='nearest', fill=0, center=None, rng=None):
        self.rng = rng
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.translate = translate
        self.scale_rng = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        arr = np.asarray(img)
        H, W = arr.shape[:2]
        angle = self._random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            r = self._random
            tx = r.uniform(-self.translate[0], self.translate[0]) * W
            ty = r.uniform(-self.translate[1], self.translate[1]) * H
        sc = (self._random.uniform(*self.scale_rng) if self.scale_rng
              else 1.0)
        sh = (0.0, 0.0)
        if self.shear is not None:
            s = self.shear
            if isinstance(s, numbers.Number):
                sh = (self._random.uniform(-s, s), 0.0)
            elif len(s) == 2:
                sh = (self._random.uniform(s[0], s[1]), 0.0)
            else:
                sh = (self._random.uniform(s[0], s[1]),
                      self._random.uniform(s[2], s[3]))
        return affine(arr, angle, (tx, ty), sc, sh, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation='nearest', fill=0, rng=None):
        self.rng = rng
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if self._random.random() >= self.prob:
            return np.asarray(img)
        arr = np.asarray(img)
        H, W = arr.shape[:2]
        d = self.distortion_scale
        half_w, half_h = int(W * d / 2), int(H * d / 2)
        tl = (self._random.randint(0, max(half_w, 1)),
              self._random.randint(0, max(half_h, 1)))
        tr = (W - 1 - self._random.randint(0, max(half_w, 1)),
              self._random.randint(0, max(half_h, 1)))
        br = (W - 1 - self._random.randint(0, max(half_w, 1)),
              H - 1 - self._random.randint(0, max(half_h, 1)))
        bl = (self._random.randint(0, max(half_w, 1)),
              H - 1 - self._random.randint(0, max(half_h, 1)))
        start = [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)]
        end = [tl, tr, br, bl]
        return perspective(arr, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    """Random rectangular erase (reference RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, rng=None):
        self.rng = rng
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if self._random.random() >= self.prob:
            return np.asarray(img)
        arr = np.asarray(img)
        H, W = arr.shape[:2]
        area = H * W
        for _ in range(10):
            target = self._random.uniform(*self.scale) * area
            ar = self._random.uniform(*self.ratio)
            h = int(round(np.sqrt(target / ar)))
            w = int(round(np.sqrt(target * ar)))
            if h < H and w < W:
                i = self._random.randint(0, H - h)
                j = self._random.randint(0, W - w)
                v = self.value
                if v == 'random':
                    v = np.random.rand(h, w, *arr.shape[2:]) * 255
                return erase(arr, i, j, h, w, v, self.inplace)
        return arr
