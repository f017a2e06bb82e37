"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``).

Parsers of local files only, as the JAX package's: MNIST and
FashionMNIST read the gzipped idx files, Cifar10 and Cifar100 the
python-pickle tarballs, ``DatasetFolder`` a ``root/<class>/<file>`` tree;
a missing file raises ``FileNotFoundError`` (nothing is downloaded).
``FakeData`` draws image ``idx`` from ``np.random.RandomState(idx)``, so
its images are bitwise the JAX package's.  Samples are numpy arrays and
``np.int64`` labels; ``io.DataLoader`` makes the batches tensors.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["FakeData", "MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "DatasetFolder"]


def _missing(what: str, path: str):
    return FileNotFoundError(
        f"{what} not found at {path}; nothing is downloaded: place the "
        f"file there, or pass its path")


class FakeData(Dataset):
    """Synthetic image classification data, deterministic per index:
    ``rand(*image_shape)`` of ``RandomState(idx)`` as float32, label
    ``idx % num_classes``."""

    def __init__(self, size=1000, image_shape=(3, 32, 32), num_classes=10,
                 transform=None):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform

    def __getitem__(self, idx):
        img = np.random.RandomState(idx).rand(*self.image_shape).astype(
            np.float32)
        label = np.int64(idx % self.num_classes)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.size


class MNIST(Dataset):
    """MNIST from local gzipped idx files (``image_path``/``label_path``,
    or ``<data_dir>/{train,t10k}-{images-idx3,labels-idx1}-ubyte.gz``)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend="cv2",
                 data_dir=None):
        self.transform = transform
        base = data_dir or os.path.expanduser("~/.cache/paddle_tpu/mnist")
        tag = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            base, f"{tag}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            base, f"{tag}-labels-idx1-ubyte.gz")
        if not os.path.exists(image_path):
            raise _missing("MNIST images", image_path)
        with gzip.open(image_path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, rows, cols)
        with gzip.open(label_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), dtype=np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    def __init__(self, **kwargs):
        kwargs.setdefault("data_dir", os.path.expanduser(
            "~/.cache/paddle_tpu/fashion_mnist"))
        super().__init__(**kwargs)


def _read_cifar(data_file: str, names, label_keys):
    xs, ys = [], []
    with tarfile.open(data_file) as tar:
        for m in tar.getmembers():
            if any(m.name.endswith(n) for n in names):
                d = pickle.load(tar.extractfile(m), encoding="bytes")
                xs.append(d[b"data"])
                ys.extend(next(d[k] for k in label_keys if k in d))
    return (np.concatenate(xs).reshape(-1, 3, 32, 32),
            np.asarray(ys, dtype=np.int64))


class Cifar10(Dataset):
    """CIFAR-10 from a local python-pickle tarball; an image is
    ``[3, 32, 32]`` uint8 (HWC through ``transform``)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend="cv2"):
        self.transform = transform
        data_file = data_file or os.path.expanduser(
            "~/.cache/paddle_tpu/cifar/cifar-10-python.tar.gz")
        if not os.path.exists(data_file):
            raise _missing("CIFAR-10 tarball", data_file)
        names = ([f"data_batch_{i}" for i in range(1, 6)] if mode == "train"
                 else ["test_batch"])
        self.data, self.labels = _read_cifar(data_file, names,
                                             (b"labels", b"fine_labels"))

    def __getitem__(self, idx):
        img = self.data[idx]
        if self.transform is not None:
            img = self.transform(img.transpose(1, 2, 0))
        return img, self.labels[idx]

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    """CIFAR-100 (its fine labels) from a local python-pickle tarball."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend="cv2"):
        self.transform = transform
        data_file = data_file or os.path.expanduser(
            "~/.cache/paddle_tpu/cifar/cifar-100-python.tar.gz")
        if not os.path.exists(data_file):
            raise _missing("CIFAR-100 tarball", data_file)
        self.data, self.labels = _read_cifar(
            data_file, ["train"] if mode == "train" else ["test"],
            (b"fine_labels",))


class DatasetFolder(Dataset):
    """``root/<class>/<file>``: classes in sorted order, files with one of
    ``extensions`` in sorted order, each read by ``loader`` (``np.load``
    by default)."""

    def __init__(self, root, loader=None, extensions=(".npy",),
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or np.load
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.endswith(tuple(extensions)):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)

    def __len__(self):
        return len(self.samples)
