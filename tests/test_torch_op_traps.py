"""Where Paddle's meaning differs from torch's, held to the JAX package on
the CPU: tie orders (descending ``argsort``/``sort`` as the flip of a
stable ascending sort, ``topk``'s lower index first, ``kthvalue`` and
``mode``), ``median``'s averaged middle pair, ``gather`` as an
index-select, ``scatter``'s duplicates, ``split``/``expand``/``reshape``
markers, ``pad``'s order and format, ``floor_divide``/``remainder`` on
negative integers, ``unique``'s flags and linalg invariants (vectors are
free in sign and phase); then the random ops' same-seed replay and laws,
and the data-dependent ops' ``CaptureError``.  Each tolerance is stated
where it is used.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu.distributed import mesh as mesh_mod

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with paddle.device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _j(a):
    return jpaddle.to_tensor(a)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.numpy())


TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0],
                 [0.0, 0.0, 5.0, 5.0, 0.0, 1.0]], np.float32)


@pytest.mark.parametrize("descending", [False, True])
def test_argsort_sort_tie_order(descending):
    """Descending is the flip of a stable ascending sort: a tie's last
    index first (``torch.sort(descending=True, stable=True)`` gives the
    first index first)."""
    x = torch.tensor(TIES)
    got = paddle.argsort(x, axis=-1, descending=descending)
    want = jpaddle.argsort(_j(TIES), axis=-1, descending=descending)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(paddle.sort(x, descending=descending)),
        _np(jpaddle.sort(_j(TIES), descending=descending)))
    if descending:
        assert _np(got)[0, :3].tolist() == [5, 2, 0]


@pytest.mark.parametrize("largest", [True, False])
def test_topk_tie_order(largest):
    """``lax.top_k``'s order: a tie's lower index first."""
    vals, idx = paddle.topk(torch.tensor(TIES), 4, largest=largest)
    jv, ji = jpaddle.topk(_j(TIES), 4, largest=largest)
    np.testing.assert_array_equal(_np(idx), _np(ji))
    np.testing.assert_array_equal(_np(vals), _np(jv))


def test_kthvalue_and_mode_tie_index():
    x = torch.tensor(TIES)
    for k in (1, 2, 4):
        v, i = paddle.kthvalue(x, k, axis=-1)
        jv, ji = jpaddle.kthvalue(_j(TIES), k, axis=-1)
        np.testing.assert_array_equal(_np(i), _np(ji))
        np.testing.assert_array_equal(_np(v), _np(jv))
    v, i = paddle.mode(x, axis=-1)
    jv, ji = jpaddle.mode(_j(TIES), axis=-1)
    np.testing.assert_array_equal(_np(v), _np(jv))
    np.testing.assert_array_equal(_np(i), _np(ji))


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_median_averages_the_middle_pair(axis):
    """``jnp.median``: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one); NaN-skipping in
    ``nanmedian``."""
    a = np.random.RandomState(3).rand(4, 6).astype(np.float32)
    ax = list(axis) if isinstance(axis, tuple) else axis
    np.testing.assert_allclose(_np(paddle.median(torch.tensor(a), axis=ax)),
                               _np(jpaddle.median(_j(a), axis=ax)),
                               rtol=1e-6)
    a[1, 2] = np.nan
    np.testing.assert_allclose(
        _np(paddle.nanmedian(torch.tensor(a), axis=ax, keepdim=True)),
        _np(jpaddle.nanmedian(_j(a), axis=ax, keepdim=True)), rtol=1e-6)
    assert float(paddle.median(torch.tensor([1.0, 2.0, 3.0, 10.0]))) == 2.5


def test_gather_is_index_select():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    idx = np.array([3, 0, 3], np.int64)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            _np(paddle.gather(torch.tensor(a), torch.tensor(idx), axis)),
            _np(jpaddle.gather(_j(a), _j(idx), axis)))
    two_d = np.array([[1], [2]], np.int64)
    np.testing.assert_array_equal(
        _np(paddle.gather(torch.tensor(a), torch.tensor(two_d))),
        _np(jpaddle.gather(_j(a), _j(two_d))))


@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter_duplicates(overwrite):
    """``overwrite=False`` zeroes the target rows, then sums the updates
    of duplicate indices."""
    x = np.ones((5, 3), np.float32)
    idx = np.array([1, 3, 1], np.int64)
    upd = np.arange(9, dtype=np.float32).reshape(3, 3)
    got = _np(paddle.scatter(torch.tensor(x), torch.tensor(idx),
                             torch.tensor(upd), overwrite=overwrite))
    want = _np(jpaddle.scatter(_j(x), _j(idx), _j(upd), overwrite=overwrite))
    if overwrite:
        # a duplicate row takes the last update (the JAX package's
        # sequential scatter on the CPU; the port's on every device)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[1], upd[2])
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[1], upd[0] + upd[2])


def test_put_along_axis_duplicates_last_wins():
    """Duplicate indices along the axis: the last write wins, as the JAX
    package's scatter on the CPU (the port's on the card too); ``add``
    sums them."""
    a = np.zeros((2, 4), np.float32)
    idx = np.array([[1, 1, 3], [0, 2, 0]], np.int64)
    v = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    for reduce in ("assign", "add"):
        got = _np(paddle.put_along_axis(torch.tensor(a), torch.tensor(idx),
                                        torch.tensor(v), 1, reduce=reduce))
        want = _np(jpaddle.put_along_axis(_j(a), _j(idx), _j(v), 1,
                                          reduce=reduce))
        np.testing.assert_array_equal(got, want)
    assert got[0, 1] == 3.0 and got[1, 0] == 10.0


def test_split_sections_and_expand_keep():
    a = np.arange(30, dtype=np.float32).reshape(3, 10)
    for sections in (5, [2, -1, 3], [4, 6]):
        got = paddle.split(torch.tensor(a), sections, axis=1)
        want = jpaddle.split(_j(a), sections, axis=1)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
    b = np.arange(3, dtype=np.float32).reshape(3, 1)
    np.testing.assert_array_equal(
        _np(paddle.expand(torch.tensor(b), [2, -1, 4])),
        _np(jpaddle.expand(_j(b), [2, -1, 4])))
    np.testing.assert_array_equal(
        _np(paddle.reshape(torch.tensor(a), [0, 2, -1])),
        _np(jpaddle.reshape(_j(a), [0, 2, -1])))


@pytest.mark.parametrize("mode,pad,fmt", [
    ("constant", [1, 2, 0, 3], "NCHW"), ("reflect", [1, 2, 2, 1], "NCHW"),
    ("replicate", [2, 0, 1, 1], "NHWC"), ("constant", [1, 1, 1, 1, 0, 2,
                                                        1, 0], "NCHW")])
def test_pad_order_and_format(mode, pad, fmt):
    a = np.random.RandomState(1).rand(2, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(
        _np(paddle.pad(torch.tensor(a), pad, mode=mode, value=0.5,
                       data_format=fmt)),
        _np(jpaddle.pad(_j(a), pad, mode=mode, value=0.5, data_format=fmt)))


def test_floor_divide_remainder_negative_ints():
    a = np.array([-7, -6, -1, 0, 5, 7], np.int64)
    b = np.array([2, -4, 3, -3, -2, 3], np.int64)
    for op in ("floor_divide", "remainder", "mod"):
        np.testing.assert_array_equal(
            _np(getattr(paddle, op)(torch.tensor(a), torch.tensor(b))),
            _np(getattr(jpaddle, op)(_j(a), _j(b))))
    np.testing.assert_array_equal(
        _np(paddle.floor_divide(torch.tensor(a), torch.tensor(b))),
        np.floor_divide(a, b))


def test_unique_flags():
    a = np.array([[3, 1, 2], [1, 3, 3]], np.int64)
    got = paddle.unique(torch.tensor(a), return_index=True,
                        return_inverse=True, return_counts=True)
    want = jpaddle.unique(_j(a), return_index=True, return_inverse=True,
                          return_counts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g).reshape(-1),
                                      _np(w).reshape(-1))
    rows = paddle.unique(torch.tensor(a), axis=1, return_counts=True)
    jrows = jpaddle.unique(_j(a), axis=1, return_counts=True)
    for g, w in zip(rows, jrows):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_linalg_invariants():
    """Vectors of ``svd``/``eig``/``eigh``/``qr`` have free signs and
    phases: each is held to reconstruction and orthogonality, and the
    eigenvalues sorted to the JAX ones; ``lu`` keeps Paddle's 1-based
    pivots and reconstructs through ``lu_unpack``."""
    rs = np.random.RandomState(5)
    a = rs.randn(5, 4).astype(np.float64)
    sq = rs.randn(4, 4).astype(np.float64)
    t = torch.tensor(a)
    u, s, vh = paddle.linalg.svd(t)
    np.testing.assert_allclose(_np(u @ torch.diag(s) @ vh), a, atol=1e-10)
    np.testing.assert_allclose(_np(s), _np(jpaddle.linalg.svd(
        _j(a.astype(np.float32)))[1]), rtol=1e-5)
    q, r = paddle.linalg.qr(t)
    np.testing.assert_allclose(_np(q @ r), a, atol=1e-10)
    np.testing.assert_allclose(_np(q.T @ q), np.eye(4), atol=1e-10)
    sym = torch.tensor(sq + sq.T)
    w, v = paddle.linalg.eigh(sym)
    np.testing.assert_allclose(_np(v @ torch.diag(w) @ v.T), sq + sq.T,
                               atol=1e-10)
    np.testing.assert_allclose(_np(w), np.sort(_np(jpaddle.linalg.eigh(
        _j((sq + sq.T).astype(np.float32)))[0])), rtol=1e-4, atol=1e-5)
    ew, ev = paddle.linalg.eig(torch.tensor(sq))
    assert ew.is_complex() and ev.is_complex()
    np.testing.assert_allclose(_np(torch.tensor(sq).to(ev.dtype) @ ev),
                               _np(ev * ew), atol=1e-10)
    jw = _np(jpaddle.linalg.eigvals(_j(sq.astype(np.float32))))
    np.testing.assert_allclose(np.sort_complex(_np(ew)), np.sort_complex(jw),
                               rtol=1e-4, atol=1e-5)
    lu_, piv = paddle.linalg.lu(torch.tensor(sq))
    jlu, jpiv = jpaddle.linalg.lu(_j(sq.astype(np.float32)))
    np.testing.assert_array_equal(_np(piv), _np(jpiv))
    assert _np(piv).min() >= 1
    P, L, U = paddle.linalg.lu_unpack(lu_, piv)
    np.testing.assert_allclose(_np(P @ L @ U), sq, atol=1e-10)
    jP = jpaddle.lu_unpack(jlu, jpiv)[0]
    np.testing.assert_array_equal(_np(P), _np(jP))


# -- random ops -------------------------------------------------------------

def test_random_same_seed_replays_bitwise():
    draws = []
    for _ in range(2):
        paddle.seed(1234)
        draws.append([_np(paddle.rand([100])), _np(paddle.randn([3, 7])),
                      _np(paddle.randint(0, 9, [50])),
                      _np(paddle.randperm(20)),
                      _np(paddle.multinomial(torch.ones(2, 6), 3))])
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)
    paddle.seed(1235)
    assert not np.array_equal(_np(paddle.rand([100])), draws[0][0])


def test_random_laws():
    """Moments and ranges on 50k draws: a mean within 5 standard errors,
    a variance within 4%."""
    paddle.seed(7)
    n = 50_000
    u = _np(paddle.uniform([n], min=-2.0, max=4.0)).astype(np.float64)
    assert u.min() >= -2.0 and u.max() < 4.0
    assert abs(u.mean() - 1.0) < 5 * 6 / np.sqrt(12 * n)
    z = _np(paddle.normal(1.5, 2.0, [n])).astype(np.float64)
    assert abs(z.mean() - 1.5) < 5 * 2.0 / np.sqrt(n)
    assert abs(z.var() / 4.0 - 1) < 0.04
    k = _np(paddle.randint(3, 10, [n]))
    assert k.min() == 3 and k.max() == 9
    assert np.allclose(np.bincount(k - 3) / n, 1 / 7, atol=0.005)
    for lam in (0.7, 4.0, 25.0, 300.0):
        p = _np(paddle.poisson(torch.full([n], lam))).astype(np.float64)
        assert abs(p.mean() - lam) < 5 * np.sqrt(lam / n), lam
        assert abs(p.var() / lam - 1) < 0.04, lam
    b = _np(paddle.bernoulli(torch.full([n], 0.3)))
    assert abs(b.mean() - 0.3) < 5 * np.sqrt(0.21 / n)
    perm = _np(paddle.randperm(1000))
    assert sorted(perm.tolist()) == list(range(1000))
    w = torch.tensor([[0.1, 0.2, 0.7]])
    m = _np(paddle.multinomial(w.expand(n // 10, 3).contiguous(), 1,
                               replacement=True)).reshape(-1)
    assert np.allclose(np.bincount(m, minlength=3) / m.size,
                       [0.1, 0.2, 0.7], atol=0.01)
    first = _np(paddle.multinomial(w.expand(n // 10, 3).contiguous(), 2))
    assert (first[:, 0] != first[:, 1]).all()
    assert abs((first[:, 0] == 2).mean() - 0.7) < 0.01
    e = _np(paddle.exponential_(torch.empty(n), lam=2.0)).astype(np.float64)
    assert e.min() >= 0 and abs(e.mean() - 0.5) < 5 * 0.5 / np.sqrt(n)


# -- data-dependent shapes inside a capture ---------------------------------

@pytest.mark.parametrize("op", ["nonzero", "masked_select", "unique",
                                "unique_consecutive", "bincount", "where"])
def test_data_dependent_ops_raise_capture_error(op, monkeypatch):
    """On a capturing stream each of these raises ``CaptureError`` naming
    the op, rather than reading the device silently (the capture is
    stood in for, so that the test runs without a card)."""
    from paddle_tpu_torch.jit import CaptureError

    x = torch.tensor([1, 0, 2, 2])
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    calls = {"nonzero": lambda: paddle.nonzero(x),
             "masked_select": lambda: paddle.masked_select(x, x > 0),
             "unique": lambda: paddle.unique(x),
             "unique_consecutive": lambda: paddle.unique_consecutive(x),
             "bincount": lambda: paddle.bincount(x),
             "where": lambda: paddle.where(x > 0)}
    name = "nonzero" if op == "where" else op
    with pytest.raises(CaptureError, match=f"paddle.{name}"):
        calls[op]()
