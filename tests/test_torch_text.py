"""The port's ``text`` against the JAX package's, on the CPU.

Spec: ``tests/test_text.py``.  ``viterbi_decode`` runs seeded potentials
through both packages: the scores are held at ``TOL`` (1e-5 absolute and
relative: both sum the same f32 terms in the same order) and the paths
must be equal, ties included (integer-valued potentials make many; both
take the first tag); each path also reaches the brute-force optimum.  The
dataset parsers read tiny files this test writes, against the JAX parsers
on the same files.
"""
import itertools
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import text as jtext
from paddle_tpu.distributed import mesh as mesh_mod
import paddle_tpu_torch as paddle
from paddle_tpu_torch import text as ttext

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with paddle.device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _path_score(pot_b, trans, p, length, include):
    N = pot_b.shape[1]
    s = pot_b[0, p[0]] + (trans[N - 1, p[0]] if include else 0.0)
    for t in range(1, length):
        s += trans[p[t - 1], p[t]] + pot_b[t, p[t]]
    if include:
        s += trans[p[length - 1], N - 2]
    return s


def _brute_force(pot_b, trans, length, include):
    N = pot_b.shape[1]
    return max(_path_score(pot_b, trans, p, length, include)
               for p in itertools.product(range(N), repeat=length))


def _decode_both(pot, trans, lengths, include):
    js, jp = jtext.viterbi_decode(jpaddle.to_tensor(pot),
                                  jpaddle.to_tensor(trans),
                                  jpaddle.to_tensor(lengths), include)
    ts, tp = ttext.viterbi_decode(torch.tensor(pot), torch.tensor(trans),
                                  torch.tensor(lengths), include)
    assert tp.dtype == torch.int64
    np.testing.assert_allclose(_np(ts), _np(js), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    return _np(ts), _np(tp)


@pytest.mark.parametrize("include", [False, True])
def test_viterbi_matches_jax_and_brute_force(include):
    rs = np.random.RandomState(0)
    B, S, N = 3, 5, 4
    pot = rs.rand(B, S, N).astype(np.float32)
    trans = rs.rand(N, N).astype(np.float32)
    lengths = np.array([5, 3, 1], dtype=np.int64)
    scores, paths = _decode_both(pot, trans, lengths, include)
    assert paths.shape == (3, 5)
    for b in range(B):
        L = int(lengths[b])
        want = _brute_force(pot[b], trans, L, include)
        np.testing.assert_allclose(scores[b], want, rtol=1e-5)
        np.testing.assert_allclose(
            _path_score(pot[b], trans, list(paths[b][:L]), L, include),
            want, rtol=1e-5)
        assert (paths[b][L:] == 0).all()


@pytest.mark.parametrize("include", [False, True])
def test_viterbi_ties_take_the_first_tag(include):
    rs = np.random.RandomState(1)
    pot = rs.randint(0, 3, (4, 7, 5)).astype(np.float32)
    trans = rs.randint(0, 2, (5, 5)).astype(np.float32)
    _decode_both(pot, trans, np.array([7, 6, 2, 4], np.int64), include)


def test_viterbi_cuts_the_paths_to_the_longest_length():
    rs = np.random.RandomState(2)
    pot = rs.randn(3, 9, 6).astype(np.float32)
    trans = rs.randn(6, 6).astype(np.float32)
    _, paths = _decode_both(pot, trans, np.array([4, 6, 1], np.int64),
                            True)
    assert paths.shape == (3, 6)


def test_viterbi_decoder_layer():
    rs = np.random.RandomState(1)
    trans = rs.rand(4, 4).astype(np.float32)
    pot = rs.rand(2, 4, 4).astype(np.float32)
    lens = np.array([4, 3], dtype=np.int64)
    ts, tp = ttext.ViterbiDecoder(torch.tensor(trans), False)(
        torch.tensor(pot), torch.tensor(lens))
    js, jp = jtext.ViterbiDecoder(jpaddle.to_tensor(trans), False)(
        jpaddle.to_tensor(pot), jpaddle.to_tensor(lens))
    np.testing.assert_allclose(_np(ts), _np(js), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    assert tuple(tp.shape) == (2, 4)


def test_text_exports_the_reference_names():
    assert ttext.__all__ == jtext.__all__
    assert paddle.text is ttext


# ---- datasets ------------------------------------------------------------------

def _same(t, j):
    assert len(t) == len(j)
    for i in range(len(j)):
        a, b = t[i], j[i]
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


def test_uci_housing(tmp_path):
    raw = np.random.RandomState(0).rand(50, 14).astype(np.float32)
    f = tmp_path / "housing.data"
    np.savetxt(f, raw)
    for mode in ("train", "test"):
        _same(ttext.UCIHousing(data_file=str(f), mode=mode),
              jtext.UCIHousing(data_file=str(f), mode=mode))
    x, y = ttext.UCIHousing(data_file=str(f))[0]
    assert x.shape == (13,) and y.shape == (1,)
    with pytest.raises(RuntimeError, match="data_file"):
        ttext.UCIHousing(mode="train")


def test_imdb(tmp_path):
    root = tmp_path / "aclImdb"
    texts = {
        "train/pos/0.txt": "a good good movie the the the best",
        "train/pos/1.txt": "good the fine a<br />a",
        "train/neg/0.txt": "a bad the movie the worst the",
        "test/pos/0.txt": "good the",
        "test/neg/0.txt": "bad the a",
    }
    for rel, content in texts.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
    tgz = tmp_path / "aclImdb_v1.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(root, arcname="aclImdb")
    for mode in ("train", "test"):
        t = ttext.Imdb(data_file=str(tgz), mode=mode, cutoff=2)
        j = jtext.Imdb(data_file=str(tgz), mode=mode, cutoff=2)
        assert t.word_idx == j.word_idx
        _same(t, j)


def test_imikolov(tmp_path):
    lines = {"train": ["the cat sat on the mat"] * 30
             + ["a dog ran fast"] * 20,
             "valid": ["the dog sat"] * 5, "test": ["the cat ran"] * 4}
    root = tmp_path / "simple-examples" / "data"
    root.mkdir(parents=True)
    for split, ls in lines.items():
        (root / f"ptb.{split}.txt").write_text("\n".join(ls))
    tgz = tmp_path / "simple-examples.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(tmp_path / "simple-examples", arcname="./simple-examples")
    for kw in (dict(data_type="NGRAM", window_size=2, mode="train"),
               dict(data_type="SEQ", mode="test"),
               dict(data_type="SEQ", mode="train", window_size=6)):
        t = ttext.Imikolov(data_file=str(tgz), min_word_freq=10, **kw)
        j = jtext.Imikolov(data_file=str(tgz), min_word_freq=10, **kw)
        assert t.word_idx == j.word_idx and len(t) > 0
        _same(t, j)


@pytest.mark.parametrize("name", ["Conll05st", "Movielens", "WMT14",
                                  "WMT16"])
def test_server_datasets_raise(name):
    with pytest.raises(NotImplementedError, match="downloaded"):
        getattr(ttext, name)()
