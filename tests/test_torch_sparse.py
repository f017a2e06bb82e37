"""The port's ``sparse`` against the JAX package's, on the CPU.

Spec: ``tests/test_sparse.py``, case by case.  Both packages take the
same seeded numpy inputs (and, for the layers, the same numpy weights
through ``from_jax_state_dict``); tolerances:

- indices, crows, cols, output sites and rulebook pairs equal, row for
  row (a coalesced or strided result is row-major, a submanifold result
  keeps its input's order);
- values within 1e-5, gradients within 1e-4 (absolute, on values of
  order one).

The JAX rulebook is a Python loop over every site and offset, so the
grids are tiny.  The port's rulebook is built on the tensors' device with
one host read each: ``test_rulebook_host_reads_are_bounded`` counts every
call that reads a device value to the host while layers run.
"""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import paddle_tpu as paddle
from paddle_tpu import sparse as jsparse
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.sparse import nn as jsnn
from paddle_tpu_torch import incubate, sparse
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.device import device_guard
from paddle_tpu_torch.models import from_jax_state_dict

torch.set_num_threads(2)
VAL, GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _rand_coo(shape, nnz, seed=0, dense_dims=0):
    rs = np.random.RandomState(seed)
    sd = len(shape) - dense_dims
    flat = rs.choice(int(np.prod(shape[:sd])), nnz, replace=False)
    idx = np.stack(np.unravel_index(flat, shape[:sd])).astype(np.int64)
    vals = rs.randn(nnz, *shape[sd:]).astype(np.float32)
    return idx, vals


def _pair(idx, vals, shape, grad=False):
    """The same COO tensor in both packages."""
    j = jsparse.sparse_coo_tensor(idx, vals, shape, stop_gradient=not grad)
    p = sparse.sparse_coo_tensor(idx, vals, shape, stop_gradient=not grad)
    return j, p


def _same_coo(p, j, tol=VAL):
    np.testing.assert_array_equal(_np(p.indices()), _np(j.indices()))
    assert p.shape == j.shape
    np.testing.assert_allclose(_np(p.values()), _np(j.values()), atol=tol,
                               rtol=0)


def _weights(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _backward(jout, pout, seed=99):
    """``sum(out · c)`` backward in both packages, ``c`` seeded."""
    c = _weights(tuple(pout.shape), seed)
    (jout * paddle.to_tensor(c)).sum().backward()
    (pout * torch.from_numpy(c)).sum().backward()


# -- tensors ------------------------------------------------------------------

class TestSparseTensors:
    def test_coo_create_to_dense(self):
        idx, vals = _rand_coo((4, 5), 6)
        j, p = _pair(idx, vals, (4, 5))
        assert p.is_sparse_coo() and not p.is_sparse_csr()
        assert p.nnz() == j.nnz() == 6
        assert p.indices().dtype == torch.int64
        np.testing.assert_allclose(_np(p.to_dense()), _np(j.to_dense()))

    def test_coo_shape_inferred(self):
        idx, vals = _rand_coo((4, 5, 3), 7, seed=3, dense_dims=1)
        j = jsparse.sparse_coo_tensor(idx, vals)
        p = sparse.sparse_coo_tensor(idx, vals)
        assert p.shape == j.shape

    @pytest.mark.parametrize("seed", [0, 1])
    def test_coo_coalesce_sums_duplicates_row_major(self, seed):
        rs = np.random.RandomState(seed)
        idx = rs.randint(0, 4, size=(2, 12))          # duplicates, unsorted
        vals = rs.randn(12, 3).astype(np.float32)
        j, p = _pair(idx, vals, (4, 4, 3), grad=True)
        jc, pc = j.coalesce(), p.coalesce()
        _same_coo(pc, jc)
        _backward(jc.values(), pc.values())
        np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)

    def test_coalesce_idempotent_fast_path(self):
        idx, vals = _rand_coo((4, 4), 3, seed=21)
        t = sparse.sparse_coo_tensor(idx, vals, (4, 4)).coalesce()
        assert t.coalesce() is t

    def test_csr_roundtrip(self):
        idx, vals = _rand_coo((5, 6), 8, seed=1)
        j, p = _pair(idx, vals, (5, 6))
        jc, pc = j.to_sparse_csr(), p.to_sparse_csr()
        assert pc.is_sparse_csr()
        for a, b in ((pc.crows(), jc.crows()), (pc.cols(), jc.cols())):
            np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_allclose(_np(pc.values()), _np(jc.values()))
        np.testing.assert_allclose(_np(pc.to_dense()), _np(jc.to_dense()))
        _same_coo(pc.to_sparse_coo(), jc.to_sparse_coo())

    def test_csr_create(self):
        crows, cols = [0, 2, 3, 5], [1, 3, 2, 0, 1]
        vals = [1.0, 2.0, 3.0, 4.0, 5.0]
        j = jsparse.sparse_csr_tensor(crows, cols, vals, (3, 4))
        p = sparse.sparse_csr_tensor(crows, cols, vals, (3, 4))
        np.testing.assert_allclose(_np(p.to_dense()), _np(j.to_dense()))
        assert p.nnz() == 5

    def test_csr_stop_gradient_property(self):
        t = sparse.sparse_csr_tensor([0, 1], [0], [1.0], (1, 2))
        assert t.stop_gradient is True
        t.stop_gradient = False
        assert t.values().requires_grad

    def test_dense_to_sparse_coo(self):
        d = np.array([[0., 1.], [3., 0.]], np.float32)
        j = paddle.to_tensor(d).to_sparse_coo(2)
        p = sparse.to_sparse_coo(torch.from_numpy(d), 2)
        _same_coo(p, j)
        d3 = np.array([[[1., 2.], [0., 0.]], [[0., 0.], [3., 4.]]],
                      np.float32)
        j3 = paddle.to_tensor(d3).to_sparse_coo(2)
        p3 = sparse.to_sparse_coo(torch.from_numpy(d3), 2)
        _same_coo(p3, j3)
        np.testing.assert_allclose(_np(p3.to_dense()), d3)

    def test_dense_to_sparse_coo_grads_flow(self):
        d = np.array([[0., 1.], [3., 0.]], np.float32)
        jx = paddle.to_tensor(d, stop_gradient=False)
        px = torch.tensor(d, requires_grad=True)
        js, ps = jx.to_sparse_coo(2), sparse.to_sparse_coo(px, 2)
        assert ps.stop_gradient is js.stop_gradient is False
        w = np.array([2., 5.], np.float32)
        (js.values() * paddle.to_tensor(w)).sum().backward()
        (ps.values() * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(_np(px.grad), _np(jx.grad))

    def test_to_sparse_coo_refuses_a_bad_sparse_dim(self):
        with pytest.raises(ValueError):
            sparse.to_sparse_coo(torch.zeros(2, 2), 3)


# -- ops ----------------------------------------------------------------------

class TestSparseOps:
    @pytest.mark.parametrize("name", ["sqrt", "sin", "tanh", "relu", "abs"])
    def test_unary(self, name):
        idx, vals = _rand_coo((4, 4), 5, seed=2)
        if name == "sqrt":
            vals = np.abs(vals) + 0.5
        j, p = _pair(idx, vals, (4, 4), grad=True)
        jo, po = getattr(jsparse, name)(j), getattr(sparse, name)(p)
        _same_coo(po, jo)
        _backward(jo.values(), po.values())
        np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)

    def test_unary_refuses_a_dense_tensor(self):
        with pytest.raises(TypeError):
            sparse.sqrt(torch.ones(2))

    @pytest.mark.parametrize("layout", ["coo", "csr"])
    def test_matmul_and_grads(self, layout):
        idx, vals = _rand_coo((6, 5), 9, seed=3)
        j, p = _pair(idx, vals, (6, 5), grad=True)
        d = np.random.RandomState(0).randn(5, 7).astype(np.float32)
        jd = paddle.to_tensor(d, stop_gradient=False)
        pd = torch.tensor(d, requires_grad=True)
        if layout == "csr":
            jo = jsparse.matmul(j.to_sparse_csr(), jd)
            po = sparse.matmul(p.to_sparse_csr(), pd)
        else:
            jo, po = jsparse.matmul(j, jd), sparse.matmul(p, pd)
        np.testing.assert_allclose(_np(po), _np(jo), atol=VAL)
        _backward(jo, po)
        np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)
        np.testing.assert_allclose(_np(pd.grad), _np(jd.grad), atol=GRAD)

    def test_matmul_shape_validation(self):
        idx, vals = _rand_coo((6, 5), 4, seed=20)
        t = sparse.sparse_coo_tensor(idx, vals, (6, 5))
        with pytest.raises(ValueError):
            sparse.matmul(t, torch.zeros(3, 7))
        with pytest.raises(ValueError):
            sparse.masked_matmul(torch.zeros(4, 3), torch.zeros(5, 4), t)

    @pytest.mark.parametrize("layout", ["coo", "csr"])
    def test_masked_matmul(self, layout):
        rs = np.random.RandomState(5)
        a = rs.randn(4, 3).astype(np.float32)
        b = rs.randn(3, 4).astype(np.float32)
        idx, vals = _rand_coo((4, 4), 6, seed=6)
        jm, pm = _pair(idx, vals, (4, 4))
        if layout == "csr":
            jm, pm = jm.to_sparse_csr(), pm.to_sparse_csr()
        ja, jb = (paddle.to_tensor(v, stop_gradient=False) for v in (a, b))
        pa, pb = (torch.tensor(v, requires_grad=True) for v in (a, b))
        jo = jsparse.masked_matmul(ja, jb, jm)
        po = sparse.masked_matmul(pa, pb, pm)
        if layout == "csr":
            assert po.is_sparse_csr()
            np.testing.assert_array_equal(_np(po.crows()), _np(jo.crows()))
            np.testing.assert_array_equal(_np(po.cols()), _np(jo.cols()))
            np.testing.assert_allclose(_np(po.values()), _np(jo.values()),
                                       atol=VAL)
        else:
            _same_coo(po, jo)
        _backward(jo.values(), po.values())
        np.testing.assert_allclose(_np(pa.grad), _np(ja.grad), atol=GRAD)
        np.testing.assert_allclose(_np(pb.grad), _np(jb.grad), atol=GRAD)

    def test_masked_matmul_duplicate_mask(self):
        one = np.ones((2, 2), np.float32)
        dup = np.array([[0, 0], [1, 1]])                # (0, 1) twice
        mask = sparse.sparse_coo_tensor(dup, np.ones(2, np.float32), (2, 2))
        out = sparse.masked_matmul(torch.from_numpy(one),
                                   torch.from_numpy(one), mask)
        assert out.nnz() == 1
        np.testing.assert_allclose(_np(out.to_dense())[0, 1], 2.0)

    @pytest.mark.parametrize("name", ["add", "subtract", "multiply",
                                      "divide"])
    def test_ewise(self, name):
        ia, va = _rand_coo((4, 4), 5, seed=7)
        ib, vb = _rand_coo((4, 4), 6, seed=8)
        ja, pa = _pair(ia, va, (4, 4), grad=True)
        jb, pb = _pair(ib, vb, (4, 4), grad=True)
        jo, po = getattr(jsparse, name)(ja, jb), getattr(sparse, name)(pa, pb)
        _same_coo(po, jo)
        finite = np.isfinite(_np(jo.values()))
        _backward(jo.values() * paddle.to_tensor(finite.astype(np.float32)),
                  po.values() * torch.from_numpy(finite.astype(np.float32)))
        for p, j in ((pa, ja), (pb, jb)):
            np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)

    def test_ewise_csr_stays_csr(self):
        ia, va = _rand_coo((4, 4), 5, seed=7)
        ib, vb = _rand_coo((4, 4), 6, seed=8)
        ja, pa = _pair(ia, va, (4, 4))
        jb, pb = _pair(ib, vb, (4, 4))
        jo = jsparse.add(ja.to_sparse_csr(), jb.to_sparse_csr())
        po = sparse.add(pa.to_sparse_csr(), pb.to_sparse_csr())
        assert po.is_sparse_csr()
        np.testing.assert_array_equal(_np(po.crows()), _np(jo.crows()))
        np.testing.assert_allclose(_np(po.values()), _np(jo.values()),
                                   atol=VAL)


# -- rulebooks ----------------------------------------------------------------

RULEBOOKS = [
    # (batch, spatial, nnz, kernel, stride, padding, subm)
    (2, (5, 6, 7), 40, 3, 1, 1, True),
    (2, (5, 6, 7), 40, 3, 1, 0, True),            # centred whatever
    (1, (5, 6, 7), 30, (3, 1, 3), 1, 0, True),
    (2, (5, 6, 7), 40, 3, 2, 1, False),
    (2, (5, 6, 7), 40, 3, 2, (0, 1, 1), False),
    (2, (5, 6, 7), 40, (3, 1, 1), (2, 1, 1), 0, False),
    (1, (6, 6, 6), 30, 2, 2, 0, False),           # a pool's window
    (1, (4, 4, 4), 20, 3, 1, 1, False),
]


def _scan(batch, spatial, nnz, seed):
    """``nnz`` distinct sites in a random order."""
    rs = np.random.RandomState(seed)
    flat = rs.choice(batch * int(np.prod(spatial)), nnz, replace=False)
    return np.stack(np.unravel_index(flat, (batch,) + spatial)).astype(
        np.int64)


@pytest.mark.parametrize("case", RULEBOOKS, ids=lambda c: f"{c[3:]}")
def test_rulebook_equals_jax(case):
    batch, spatial, nnz, k, s, p, subm = case
    idx = _scan(batch, spatial, nnz, seed=nnz)
    t = jsnn._triple
    sites, out_sp, pairs = jsnn._conv_out_sites(idx, spatial, t(k), t(s),
                                                t(p), subm)
    rb = sparse.nn.build_rulebook(torch.from_numpy(idx), spatial, k, s, p,
                                  subm)
    assert rb.out_spatial == tuple(out_sp)
    np.testing.assert_array_equal(_np(rb.out_indices),
                                  np.asarray(sites).reshape(-1, 4).T)
    np.testing.assert_array_equal(_np(rb.in_rows),
                                  np.concatenate([a for a, _ in pairs]))
    np.testing.assert_array_equal(_np(rb.out_rows),
                                  np.concatenate([b for _, b in pairs]))
    assert rb.counts == [len(a) for a, _ in pairs]


def test_subm_rulebook_with_duplicate_sites_takes_the_last():
    idx = np.array([[0, 0, 0], [1, 2, 1], [1, 1, 1], [1, 1, 1]])
    t = jsnn._triple
    sites, _, pairs = jsnn._conv_out_sites(idx, (4, 4, 4), t(3), t(1), t(1),
                                           True)
    rb = sparse.nn.build_rulebook(torch.from_numpy(idx), (4, 4, 4), 3, 1, 1,
                                  True)
    np.testing.assert_array_equal(_np(rb.out_rows),
                                  np.concatenate([b for _, b in pairs]))


class _HostReads(TorchFunctionMode):
    """Counts the calls that read a device value to the host."""

    READS = {torch.Tensor.tolist, torch.Tensor.item, torch.Tensor.__bool__,
             torch.Tensor.__int__, torch.Tensor.__float__,
             torch.Tensor.__index__, torch.Tensor.cpu, torch.Tensor.numpy,
             torch.nonzero, torch.Tensor.nonzero, torch.unique,
             torch.unique_consecutive, torch.masked_select,
             torch.Tensor.masked_select, torch.repeat_interleave,
             torch.Tensor.repeat_interleave, torch.bincount}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.READS:
            self.reads.append(getattr(func, "__name__", str(func)))
        elif func is torch.Tensor.__getitem__ and any(
                isinstance(a, torch.Tensor) and a.dtype == torch.bool
                for a in (args[1] if isinstance(args[1], tuple)
                          else (args[1],))):
            self.reads.append("bool mask index")
        return func(*args, **kwargs)


def test_rulebook_host_reads_are_bounded():
    """Each layer that builds a rulebook reads the host once (its sizes);
    a layer over indices whose rulebook is built reads nothing, and
    neither do the norm and the activation."""
    idx = _scan(2, (8, 8, 8), 60, seed=4)
    vals = np.random.RandomState(4).randn(60, 4).astype(np.float32)
    x = sparse.sparse_coo_tensor(idx, vals, (2, 8, 8, 8, 4))
    layers = [sparse.nn.SubmConv3D(4, 8, 3, padding=1, bias_attr=False),
              sparse.nn.BatchNorm(8), sparse.nn.ReLU(),
              sparse.nn.SubmConv3D(8, 8, 3, padding=1, bias_attr=False),
              sparse.nn.Conv3D(8, 16, 3, stride=2, padding=1,
                               bias_attr=False),
              sparse.nn.SubmConv3D(16, 16, 3, padding=1),
              sparse.nn.MaxPool3D(2, stride=2)]
    want = [1, 0, 0, 0, 1, 1, 1]
    for layer, n in zip(layers, want):
        before = dict(sparse.nn.HOST_READS)
        with _HostReads() as mode:
            x = layer(x)
        assert len(mode.reads) == n, (type(layer).__name__, mode.reads)
        assert sparse.nn.HOST_READS["reads"] - before["reads"] == n
    with _HostReads() as mode:
        x.values().sum().backward()
    assert mode.reads == []


# -- layers -------------------------------------------------------------------

def _layer_pair(jlayer, player):
    from_jax_state_dict(player, {k: _np(v) for k, v in
                                 jlayer.state_dict().items()})
    return jlayer, player


class TestSparseNN:
    def test_relu_softmax(self):
        idx, vals = _rand_coo((4, 5), 7, seed=9)
        j, p = _pair(idx, vals, (4, 5), grad=True)
        _same_coo(sparse.nn.ReLU()(p), jsparse.nn.ReLU()(j))
        jc, pc = j.to_sparse_csr(), p.to_sparse_csr()
        jo, po = jsparse.nn.Softmax()(jc), sparse.nn.Softmax()(pc)
        np.testing.assert_allclose(_np(po.values()), _np(jo.values()),
                                   atol=VAL)
        _backward(jo.values(), po.values())
        np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)

    def test_relu_layer_type_error(self):
        with pytest.raises(TypeError):
            sparse.nn.ReLU()(torch.zeros(3))

    def test_batch_norm_train_and_eval(self):
        idx, vals = _rand_coo((2, 4, 4, 4, 3), 10, seed=10, dense_dims=1)
        j, p = _pair(idx, vals, (2, 4, 4, 4, 3), grad=True)
        jb, pb = _layer_pair(jsparse.nn.BatchNorm(3, momentum=0.99,
                                                  epsilon=1e-3),
                             sparse.nn.BatchNorm(3, momentum=0.99,
                                                 epsilon=1e-3))
        jo, po = jb(j), pb(p)
        _same_coo(po, jo)
        np.testing.assert_allclose(_np(pb._mean), _np(jb._mean), atol=VAL)
        np.testing.assert_allclose(_np(pb._variance), _np(jb._variance),
                                   atol=VAL)
        _backward(jo.values(), po.values())
        np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)
        np.testing.assert_allclose(_np(pb.weight.grad), _np(jb.weight.grad),
                                   atol=GRAD)
        jb.eval()
        pb.eval()
        _same_coo(pb(p), jb(j))

    def test_subm_conv3d_sites_values_grads(self):
        idx, vals = _rand_coo((1, 4, 4, 4, 4), 6, seed=11, dense_dims=1)
        j, p = _pair(idx, vals, (1, 4, 4, 4, 4), grad=True)
        jc, pc = _layer_pair(jsparse.nn.SubmConv3D(4, 4, 3, padding=1),
                             sparse.nn.SubmConv3D(4, 4, 3, padding=1))
        jo, po = jc(j), pc(p)
        _same_coo(po, jo)
        np.testing.assert_array_equal(_np(po.indices()), idx)
        _backward(jo.values(), po.values())
        for a, b in ((p.grad, j.grad), (pc.weight.grad, jc.weight.grad),
                     (pc.bias.grad, jc.bias.grad)):
            np.testing.assert_allclose(_np(a), _np(b), atol=GRAD)

    def test_conv3d_expands_pattern(self):
        idx = np.array([[0], [1], [1], [1]])
        vals = np.ones((1, 1), np.float32)
        j, p = _pair(idx, vals, (1, 4, 4, 4, 1))
        jc, pc = _layer_pair(
            jsparse.nn.Conv3D(1, 1, 3, padding=1, bias_attr=False),
            sparse.nn.Conv3D(1, 1, 3, padding=1, bias_attr=False))
        jo, po = jc(j), pc(p)
        assert po.nnz() == 27
        _same_coo(po, jo)

    def test_maxpool3d(self):
        idx, vals = _rand_coo((1, 4, 4, 4, 2), 9, seed=12, dense_dims=1)
        j, p = _pair(idx, np.abs(vals), (1, 4, 4, 4, 2), grad=True)
        jo = jsparse.nn.MaxPool3D(2, stride=2)(j)
        po = sparse.nn.MaxPool3D(2, stride=2)(p)
        _same_coo(po, jo)
        _backward(jo.values(), po.values())
        np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)

    def test_subm_conv_no_padding_boundary(self):
        idx = np.array([[0], [3], [3], [3]])
        vals = np.ones((1, 2), np.float32)
        j, p = _pair(idx, vals, (1, 4, 4, 4, 2))
        jc, pc = _layer_pair(
            jsparse.nn.SubmConv3D(2, 3, 3, bias_attr=False),
            sparse.nn.SubmConv3D(2, 3, 3, bias_attr=False))
        po = pc(p)
        assert po.shape == [1, 4, 4, 4, 3]
        _same_coo(po, jc(j))

    def test_subm_conv_rejects_stride_and_even_kernel(self):
        x = sparse.sparse_coo_tensor(np.zeros((4, 1), np.int64),
                                     np.ones((1, 2), np.float32),
                                     (1, 4, 4, 4, 2))
        with pytest.raises(ValueError):
            sparse.nn.SubmConv3D(2, 2, kernel_size=3, stride=2)(x)
        with pytest.raises(ValueError):
            sparse.nn.SubmConv3D(2, 2, kernel_size=2)(x)

    def test_maxpool_unsupported_args_raise(self):
        with pytest.raises(NotImplementedError):
            sparse.nn.MaxPool3D(2, return_mask=True)
        with pytest.raises(NotImplementedError):
            sparse.nn.MaxPool3D(2, ceil_mode=True)

    def test_incubate_alias(self):
        assert incubate.sparse is sparse

    def test_stacked_subm_layers_share_one_rulebook(self):
        idx, vals = _rand_coo((1, 5, 5, 5, 2), 20, seed=15, dense_dims=1)
        x = sparse.sparse_coo_tensor(idx, vals, (1, 5, 5, 5, 2))
        net = pnn.Sequential(sparse.nn.SubmConv3D(2, 4, 3, padding=1),
                             sparse.nn.BatchNorm(4), sparse.nn.ReLU(),
                             sparse.nn.SubmConv3D(4, 4, 3, padding=1),
                             sparse.nn.SubmConv3D(4, 4, 3, padding=1))
        before = sparse.nn.HOST_READS["rulebooks"]
        out = net(x)
        assert sparse.nn.HOST_READS["rulebooks"] - before == 1
        assert out.indices() is x.indices()


def _encoder(pkg):
    """A 3-layer sparse encoder of SECOND's blocks: SubmConv3D → BatchNorm
    → ReLU, a strided Conv3D → BatchNorm → ReLU, SubmConv3D (one width
    throughout, so that the JAX ops compile once a shape)."""
    s = pkg.sparse.nn
    return pkg.nn.Sequential(
        s.SubmConv3D(4, 4, 3, padding=1, bias_attr=False),
        s.BatchNorm(4, momentum=0.99, epsilon=1e-3), s.ReLU(),
        s.Conv3D(4, 4, 3, stride=2, padding=1, bias_attr=False),
        s.BatchNorm(4, momentum=0.99, epsilon=1e-3), s.ReLU(),
        s.SubmConv3D(4, 4, 3, padding=1))


def test_whole_encoder_matches_jax_in_sites_values_and_grads():
    import paddle_tpu_torch as pt

    paddle.seed(3)
    jnet = _encoder(paddle)
    with device_guard("cpu"):
        pnet = _encoder(pt)
    _layer_pair(jnet, pnet)
    idx = _scan(2, (5, 5, 4), 16, seed=5)
    vals = np.random.RandomState(5).randn(16, 4).astype(np.float32)
    j, p = _pair(idx, vals, (2, 5, 5, 4, 4), grad=True)
    jo, po = jnet(j), pnet(p)
    _same_coo(po, jo)
    _backward(jo.values(), po.values())
    np.testing.assert_allclose(_np(p.grad), _np(j.grad), atol=GRAD)
    jparams = dict(jnet.named_parameters())
    for name, param in pnet.named_parameters():
        np.testing.assert_allclose(_np(param.grad),
                                   _np(jparams[name].grad), atol=GRAD,
                                   err_msg=name)
    jbuf = jnet.state_dict()
    for name, buf in pnet.named_buffers():
        np.testing.assert_allclose(_np(buf), _np(jbuf[name]), atol=VAL,
                                   err_msg=name)
