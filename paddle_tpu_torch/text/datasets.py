"""The text datasets (port of ``paddle_tpu/text/datasets.py``).

Paddle's Dataset API and file formats, on local files only: nothing is
downloaded, so with no local ``data_file`` a dataset raises and says what
to fetch.  ``Conll05st``, ``Movielens``, ``WMT14`` and ``WMT16`` raise at
construction, as in the JAX package (their parsers are not written).
"""
from __future__ import annotations

import gzip
import os
import re
import tarfile
from typing import List, Optional

import numpy as np

from ..io import Dataset

__all__ = ["UCIHousing", "Imdb", "Imikolov", "Conll05st", "Movielens",
           "WMT14", "WMT16"]


def _require(data_file: Optional[str], name: str, url_hint: str) -> str:
    if data_file and os.path.exists(data_file):
        return data_file
    raise RuntimeError(
        f"{name}: no local data_file, and nothing is downloaded. Fetch "
        f"{url_hint} and pass data_file=...")


class UCIHousing(Dataset):
    """Boston housing regression (reference: uci_housing.py — 13 features,
    80/20 train/test split, feature-wise max-min normalization)."""

    FEATURE_NUM = 14

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 download: bool = True):
        assert mode in ("train", "test")
        path = _require(data_file, "UCIHousing",
                        "https://archive.ics.uci.edu/ml/machine-learning-"
                        "databases/housing/housing.data")
        raw = np.loadtxt(path).astype(np.float32)
        raw = raw.reshape(-1, self.FEATURE_NUM)
        maxi, mini = raw.max(axis=0), raw.min(axis=0)
        avg = raw.mean(axis=0)
        span = np.where(maxi - mini == 0, 1.0, maxi - mini)
        feats = (raw - avg) / span
        raw = np.concatenate(
            [feats[:, :-1], raw[:, -1:]], axis=1)
        split = int(len(raw) * 0.8)
        self.data = raw[:split] if mode == "train" else raw[split:]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        row = self.data[i]
        return row[:-1].astype(np.float32), row[-1:].astype(np.float32)


class Imdb(Dataset):
    """IMDB sentiment (reference: imdb.py — aclImdb tgz, word-frequency
    vocabulary with a cutoff of 150, <unk> id = len(vocab))."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, download: bool = True):
        assert mode in ("train", "test")
        path = _require(data_file, "Imdb",
                        "https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz")
        # one decompression pass collects the vocab counts (train split)
        # and this mode's tokenized documents together — the tarball is
        # ~50k files and re-scanning it per purpose triples load time
        from collections import Counter

        pos_pat = re.compile(rf"aclImdb/{mode}/pos/.*\.txt$")
        neg_pat = re.compile(rf"aclImdb/{mode}/neg/.*\.txt$")
        train_pat = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
        freq: Counter = Counter()
        pos_docs: List[List[str]] = []
        neg_docs: List[List[str]] = []
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                name = m.name or ""
                is_pos = bool(pos_pat.match(name))
                is_neg = bool(neg_pat.match(name))
                is_train = bool(train_pat.match(name))
                if not (is_pos or is_neg or is_train):
                    continue
                words = tf.extractfile(m).read().decode("latin-1") \
                    .lower().replace("<br />", " ").split()
                if is_train:
                    freq.update(words)
                if is_pos:
                    pos_docs.append(words)
                elif is_neg:
                    neg_docs.append(words)
        freq.pop("<unk>", None)
        vocab = [w for w, c in freq.items() if c > cutoff]
        vocab.sort(key=lambda w: (-freq[w], w))
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        unk = len(self.word_idx)
        self.docs: List[np.ndarray] = []
        self.labels: List[int] = []
        for docs, label in ((pos_docs, 0), (neg_docs, 1)):
            for d in docs:
                self.docs.append(np.array(
                    [self.word_idx.get(w, unk) for w in d], dtype=np.int64))
                self.labels.append(label)

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        # reference imdb.py:142 — label as a shape-(1,) array
        return self.docs[i], np.array([self.labels[i]], dtype=np.int64)


class Imikolov(Dataset):
    """PTB n-gram LM dataset (reference: imikolov.py — train/valid from the
    simple-examples tgz; n-gram or sequence data_type)."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size: int = -1, mode: str = "train",
                 min_word_freq: int = 50, download: bool = True):
        assert mode in ("train", "test")
        assert data_type in ("NGRAM", "SEQ")
        path = _require(data_file, "Imikolov",
                        "https://dataset.bj.bcebos.com/imikolov%2F"
                        "simple-examples.tar.gz")
        self.window_size = window_size
        self.data_type = data_type
        # reference imikolov.py:143 — mode names the file directly
        # (ptb.test.txt for test; ptb.valid.txt only feeds the vocab)
        fname = f"./simple-examples/data/ptb.{mode}.txt"
        self.word_idx = self._build_vocab(path, min_word_freq)
        self.data = []
        with tarfile.open(path) as tf:
            f = tf.extractfile(fname)
            lines = f.read().decode("utf-8").splitlines()
        unk = self.word_idx["<unk>"]
        for ln in lines:
            words = ln.strip().split()
            ids = [self.word_idx["<s>"]] + \
                [self.word_idx.get(w, unk) for w in words] + \
                [self.word_idx["<e>"]]
            if data_type == "NGRAM":
                if window_size <= 0:
                    raise ValueError("NGRAM needs window_size > 0")
                # reference imikolov.py:153 — window_size ids per item
                for i in range(window_size, len(ids) + 1):
                    self.data.append(
                        np.array(ids[i - window_size:i], dtype=np.int64))
            else:
                src, tgt = ids[:-1], ids[1:]
                # reference imikolov.py:160 — drop over-long sequences
                if window_size > 0 and len(src) > window_size:
                    continue
                self.data.append((np.array(src, dtype=np.int64),
                                  np.array(tgt, dtype=np.int64)))

    def _build_vocab(self, path, min_word_freq):
        """Reference _build_work_dict: counts over train+valid with one
        <s>/<e> per line (so the markers get frequency-ranked ids), strict
        cutoff, <unk> appended last."""
        from collections import Counter

        freq = Counter()
        with tarfile.open(path) as tf:
            for split in ("train", "valid"):
                f = tf.extractfile(f"./simple-examples/data/ptb.{split}.txt")
                for ln in f.read().decode("utf-8").splitlines():
                    freq.update(ln.strip().split())
                    freq["<s>"] += 1
                    freq["<e>"] += 1
        freq.pop("<unk>", None)
        words = [w for w, c in freq.items() if c > min_word_freq]
        words.sort(key=lambda w: (-freq[w], w))
        idx = {w: i for i, w in enumerate(words)}
        idx["<unk>"] = len(idx)
        return idx

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class _DownloadDataset(Dataset):
    """A corpus Paddle fetches from its dataset server: the port
    downloads nothing and has no parser for its archive, so construction
    raises and says so."""

    _NAME = "dataset"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"paddle.text.{self._NAME} downloads and parses its corpus "
            "from the dataset server, and nothing is downloaded; load "
            "the data with paddle.io.Dataset over local files instead")


class Conll05st(_DownloadDataset):
    """CoNLL-2005 SRL (reference text/datasets/conll05.py)."""

    _NAME = "Conll05st"


class Movielens(_DownloadDataset):
    """MovieLens-1M ratings (reference text/datasets/movielens.py)."""

    _NAME = "Movielens"


class WMT14(_DownloadDataset):
    """WMT14 en-fr (reference text/datasets/wmt14.py)."""

    _NAME = "WMT14"


class WMT16(_DownloadDataset):
    """WMT16 en-de (reference text/datasets/wmt16.py)."""

    _NAME = "WMT16"
