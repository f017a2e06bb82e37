"""The port's ``incubate`` surface against the JAX package's, on the CPU:
the graph samplers, the fused bias-dropout-residual layer norm,
``LookAhead`` and ``ModelAverage``, and ASP's 2:4 masks.

Spec: ``tests/test_incubate.py:97-316`` and the ASP cases of
``tests/test_meta_optimizers.py`` (``TestASP``, ``test_asp_skips_
embedding``).  Both packages start from the same numpy weights and take
the same inputs; tolerances:

- samplers: bitwise where every neighbour is taken (``sample_size`` -1 or
  at least the degree, and ``graph_reindex``); below the degree the draws
  are the port's own (``rng=``), held to their laws (counts, valid
  neighbours, no repeats, edge ids that belong to the edges);
- the fused layer norm at dropout 0: 1e-6 absolute (the same f32
  arithmetic); at dropout > 0, the keep mask's law and the output
  against the plain composition on the same mask;
- the optimizers: weights within 1e-6 (f32) after each of 2k + 1 steps,
  and under AMP O2 the bf16 weights equal and the f32 masters within
  1e-6;
- ASP: masks identical, weights bitwise after pruning and within 1e-6
  after training.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.incubate import asp as jasp
from paddle_tpu_torch import incubate, nn as pnn, optimizer as popt, rng
from paddle_tpu_torch.incubate import asp
from paddle_tpu_torch.models import from_jax_state_dict

torch.set_num_threads(2)
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy())


# -- the graph samplers -------------------------------------------------------

def _csc_graph():
    # node0 <- {1, 2}; node1 <- {3}; node2 <- {0, 3, 4}; node3 <- {};
    # node4 <- {2}
    row = np.array([1, 2, 3, 0, 3, 4, 2], np.int64)
    colptr = np.array([0, 2, 3, 6, 6, 7], np.int64)
    return row, colptr


def _edges(row, colptr):
    return {(c, int(r)) for c in range(len(colptr) - 1)
            for r in row[colptr[c]:colptr[c + 1]]}


def test_graph_reindex_bitwise():
    x = np.array([0, 1, 2], np.int64)
    nb = np.array([8, 9, 0, 4, 7, 6, 7], np.int64)
    ct = np.array([2, 3, 2], np.int32)
    jout = paddle.incubate.graph_reindex(
        paddle.to_tensor(x), paddle.to_tensor(nb), paddle.to_tensor(ct))
    tout = incubate.graph_reindex(torch.from_numpy(x), torch.from_numpy(nb),
                                  torch.from_numpy(ct))
    for t, j in zip(tout, jout):
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


@pytest.mark.parametrize("size", [-1, 3, 5])
def test_sample_neighbors_whole_degree_bitwise(size):
    row, colptr = _csc_graph()
    nodes = np.array([0, 2, 3, 4], np.int64)
    eids = np.arange(len(row), dtype=np.int64) * 10
    jout = paddle.incubate.graph_sample_neighbors(
        paddle.to_tensor(row), paddle.to_tensor(colptr),
        paddle.to_tensor(nodes), eids=paddle.to_tensor(eids),
        sample_size=size, return_eids=True)
    tout = incubate.graph_sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr),
        torch.from_numpy(nodes), eids=torch.from_numpy(eids),
        sample_size=size, return_eids=True)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


def test_sample_neighbors_capped_law():
    row, colptr = _csc_graph()
    edges = _edges(row, colptr)
    nodes = np.array([0, 2, 3, 2], np.int64)
    eids = np.arange(len(row), dtype=np.int64)
    seen = set()
    for seed in range(20):
        nb, ct, es = incubate.graph_sample_neighbors(
            torch.from_numpy(row), torch.from_numpy(colptr),
            torch.from_numpy(nodes), eids=torch.from_numpy(eids),
            sample_size=2, return_eids=True, rng=seed)
        assert ct.tolist() == [2, 2, 0, 2]
        off = np.concatenate([[0], np.cumsum(ct.numpy())])
        for i, n in enumerate(nodes):
            got = nb.numpy()[off[i]:off[i + 1]]
            assert len(set(got)) == len(got)
            assert all((int(n), int(v)) in edges for v in got)
            # each edge id is the id of the edge it sampled
            assert all(row[e] == v for e, v in
                       zip(es.numpy()[off[i]:off[i + 1]], got))
        seen.add(tuple(nb.numpy()[2:4]))
    assert len(seen) > 1                    # node 2's draws vary by seed
    again = incubate.graph_sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr),
        torch.from_numpy(nodes), sample_size=2, rng=3)
    first = incubate.graph_sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr),
        torch.from_numpy(nodes), sample_size=2, rng=3)
    assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_khop_whole_degree_bitwise():
    row, colptr = _csc_graph()
    eids = np.arange(len(row), dtype=np.int64)
    args = ([0, 4], [5, 5])
    jout = paddle.incubate.graph_khop_sampler(
        paddle.to_tensor(row), paddle.to_tensor(colptr),
        paddle.to_tensor(np.array(args[0], np.int64)), args[1],
        sorted_eids=paddle.to_tensor(eids), return_eids=True)
    tout = incubate.graph_khop_sampler(
        torch.from_numpy(row), torch.from_numpy(colptr),
        torch.tensor(args[0]), args[1], sorted_eids=torch.from_numpy(eids),
        return_eids=True)
    assert len(tout) == len(jout) == 5
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


def test_khop_capped_law():
    row, colptr = _csc_graph()
    edges = _edges(row, colptr)
    for seed in range(10):
        src, dst, nodes, reindex = incubate.graph_khop_sampler(
            torch.from_numpy(row), torch.from_numpy(colptr),
            torch.tensor([0, 4]), [1, 1], rng=seed)
        nodes = nodes.numpy()
        assert src.shape[1] == dst.shape[1] == 1
        assert src.shape[0] == dst.shape[0] > 0
        np.testing.assert_array_equal(nodes[:2], [0, 4])
        np.testing.assert_array_equal(reindex.numpy(), [0, 1])
        for s, d in zip(src[:, 0].tolist(), dst[:, 0].tolist()):
            assert (int(nodes[d]), int(nodes[s])) in edges


def test_samplers_refuse_missing_eids():
    row, colptr = _csc_graph()
    with pytest.raises(ValueError):
        incubate.graph_sample_neighbors(
            torch.from_numpy(row), torch.from_numpy(colptr),
            torch.tensor([0]), return_eids=True)
    with pytest.raises(ValueError):
        incubate.graph_khop_sampler(
            torch.from_numpy(row), torch.from_numpy(colptr),
            torch.tensor([0]), [1], return_eids=True)


# -- fused bias-dropout-residual layer norm -----------------------------------

def _ln_inputs(seed=0, h=16):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32)
            for s in ((2, 5, h), (2, 5, h), (h,), (h,), (h,))]


@pytest.mark.parametrize("with_affine", [True, False])
def test_fused_ln_matches_jax_without_dropout(with_affine):
    from paddle_tpu.ops.pallas import \
        fused_bias_dropout_residual_layer_norm as jfused

    x, res, b, g, beta = _ln_inputs()
    extra = (b, g, beta) if with_affine else (None, None, None)
    jt = [None if a is None else paddle.to_tensor(a) for a in extra]
    tt = [None if a is None else torch.from_numpy(a) for a in extra]
    jx, jr = paddle.to_tensor(x), paddle.to_tensor(res)
    jx.stop_gradient = False
    tx = torch.from_numpy(x).requires_grad_()
    jo = jfused(jx, jr, *jt, dropout_rate=0.0)
    to = incubate.fused_bias_dropout_residual_layer_norm(
        tx, torch.from_numpy(res), *tt, dropout_rate=0.0)
    np.testing.assert_allclose(_np(to), _np(jo), atol=ATOL)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), atol=1e-5)


def test_fused_ln_eval_ignores_dropout():
    x, res, b, g, beta = _ln_inputs(1)
    args = [torch.from_numpy(a) for a in (x, res, b, g, beta)]
    a = incubate.fused_bias_dropout_residual_layer_norm(
        *args, dropout_rate=0.5, training=False)
    c = incubate.fused_bias_dropout_residual_layer_norm(
        *args, dropout_rate=0.0)
    assert torch.equal(a, c)


def test_fused_ln_dropout_law():
    x, res, b, g, beta = _ln_inputs(2, h=256)
    x = np.repeat(x, 40, axis=0)
    res = np.repeat(res, 40, axis=0)
    args = [torch.from_numpy(a) for a in (x, res, b, g, beta)]
    p = 0.3
    rng.seed(5)
    gen = rng.default_generator("cpu")
    state = gen.get_state()
    out = incubate.fused_bias_dropout_residual_layer_norm(
        *args, dropout_rate=p)
    gen.set_state(state)
    keep = rng.dropout_keep(gen.draw(), x.shape, p)
    assert abs(keep.float().mean().item() - (1 - p)) < 0.01
    a = torch.where(keep, (args[0] + args[2]) / (1 - p),
                    torch.zeros_like(args[0]))
    ref = torch.nn.functional.layer_norm(args[1] + a, (256,), args[3],
                                         args[4], 1e-5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


# -- LookAhead / ModelAverage -------------------------------------------------

def _nets(seed=7):
    paddle.seed(seed)
    jl = jnn.Linear(4, 3)
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tl = from_jax_state_dict(pnn.Linear(4, 3, device="cpu"), sd)
    return jl, tl


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(6, 4).astype(np.float32), rs.randn(6, 3).astype(np.float32)


def _step(net, opt, x, y, jax: bool):
    if jax:
        loss = ((net(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
    else:
        loss = ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


@pytest.mark.parametrize("inner", ["SGD", "AdamW"])
def test_lookahead_matches_jax_over_2k_plus_1_steps(inner):
    k = 2
    jl, tl = _nets()
    jopt = paddle.incubate.LookAhead(getattr(paddle.optimizer, inner)(
        learning_rate=0.1, parameters=jl.parameters()), alpha=0.5, k=k)
    topt = incubate.LookAhead(getattr(popt, inner)(tl.parameters(), lr=0.1),
                              alpha=0.5, k=k)
    x, y = _data()
    for _ in range(2 * k + 1):
        _step(jl, jopt, x, y, True)
        _step(tl, topt, x, y, False)
        np.testing.assert_allclose(_np(tl.weight).T, _np(jl.weight),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(tl.bias), _np(jl.bias), atol=ATOL)


def test_lookahead_syncs_only_at_multiples_of_k():
    """Slow and fast weights meet after steps k, 2k and at no other."""
    k = 3
    _, tl = _nets()
    topt = incubate.LookAhead(popt.SGD(tl.parameters(), lr=0.1), k=k)
    x, y = _data(1)
    for step in range(1, 2 * k + 2):
        _step(tl, topt, x, y, False)
        slow = topt.state[tl.weight]["slow"]
        met = torch.equal(slow, tl.weight.detach())
        # (the slow weights start as the fast ones after the first step)
        assert met == (step % k == 0 or step == 1), step


def test_lookahead_validation():
    _, tl = _nets()
    inner = popt.SGD(tl.parameters(), lr=0.1)
    with pytest.raises(ValueError):
        incubate.LookAhead(inner, alpha=2.0)
    with pytest.raises(ValueError):
        incubate.LookAhead(inner, k=0)
    with pytest.raises(TypeError):
        incubate.LookAhead(object())


def test_lookahead_amp_o2_shares_inner_master():
    """Under O2 the fast weights are the inner optimizer's f32 masters:
    the weights keep moving, and both packages agree."""
    k = 2
    jl, tl = _nets()
    jinner = paddle.optimizer.SGD(learning_rate=0.5,
                                  parameters=jl.parameters())
    jl, jinner = paddle.amp.decorate(jl, optimizers=jinner, level="O2")
    tinner = popt.SGD(tl.parameters(), lr=0.5)
    from paddle_tpu_torch import amp

    tl, tinner = amp.decorate(tl, optimizers=tinner, level="O2")
    jopt = paddle.incubate.LookAhead(jinner, alpha=0.5, k=k)
    topt = incubate.LookAhead(tinner, alpha=0.5, k=k)
    # gradients bf16 holds exactly, so both packages see the same ones
    gs = torch.from_numpy(np.random.RandomState(3).randn(
        2 * k + 1, 3, 4).astype(np.float32)).bfloat16().float().numpy()
    prev = _np(tl.weight).copy()
    for g in gs:
        jl.weight.grad = paddle.to_tensor(g.T.copy())
        jl.bias.grad = paddle.to_tensor(np.zeros(3, np.float32))
        tl.weight.grad = torch.from_numpy(g).to(torch.bfloat16)
        tl.bias.grad = torch.zeros(3, dtype=torch.bfloat16)
        jopt.step()
        topt.step()
        now = _np(tl.weight)
        assert not np.allclose(now, prev)
        prev = now.copy()
        np.testing.assert_array_equal(now.T, _np(jl.weight))
        master = tinner.state[tl.weight]["master_weight"]
        jmaster = jinner._master_value(jl.weight)
        np.testing.assert_allclose(master.numpy().T, np.asarray(jmaster),
                                   atol=ATOL)


def test_model_average_matches_jax_apply_restore():
    jl, tl = _nets()
    jsgd = paddle.optimizer.SGD(learning_rate=0.05,
                                parameters=jl.parameters())
    tsgd = popt.SGD(tl.parameters(), lr=0.05)
    kw = dict(min_average_window=2, max_average_window=10)
    jma = paddle.incubate.ModelAverage(0.15, parameters=jl.parameters(), **kw)
    tma = incubate.ModelAverage(0.15, parameters=tl.parameters(), **kw)
    x, y = _data(2)
    for _ in range(5):
        _step(jl, jsgd, x, y, True)
        _step(tl, tsgd, x, y, False)
        jma.step()
        tma.step()
    w_train = _np(tl.weight).copy()
    with jma.apply(), tma.apply():
        avg = _np(tl.weight)
        assert not np.allclose(avg, w_train)
        np.testing.assert_allclose(avg.T, _np(jl.weight), atol=ATOL)
    np.testing.assert_array_equal(_np(tl.weight), w_train)
    np.testing.assert_allclose(_np(tl.weight).T, _np(jl.weight), atol=ATOL)


def test_model_average_window_average_exact():
    _, tl = _nets()
    ma = incubate.ModelAverage(1.0, parameters=tl.parameters(),
                               min_average_window=10000,
                               max_average_window=10000)
    for i in range(3):
        with torch.no_grad():
            tl.weight.fill_(float(i + 1))
        ma.step()
    with ma.apply():
        np.testing.assert_allclose(tl.weight.detach().numpy(),
                                   np.full((3, 4), 2.0, np.float32),
                                   rtol=1e-6)
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  np.full((3, 4), 3.0, np.float32))


def test_model_average_apply_without_restore():
    _, tl = _nets()
    ma = incubate.ModelAverage(1.0, parameters=tl.parameters(),
                               min_average_window=10000,
                               max_average_window=10000)
    for v in (1.0, 3.0):
        with torch.no_grad():
            tl.weight.fill_(v)
        ma.step()
    with ma.apply(need_restore=False):
        pass
    assert torch.all(tl.weight == 2.0)
    ma.restore()
    assert torch.all(tl.weight == 3.0)


# -- ASP ----------------------------------------------------------------------

def _asp_pair(seed, build_j, build_t):
    paddle.seed(seed)
    jnet = build_j()
    sd = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    tnet = from_jax_state_dict(build_t(), sd)
    return jnet, tnet


def _mlp():
    return (lambda: jnn.Sequential(jnn.Linear(8, 8), jnn.ReLU(),
                                   jnn.Linear(8, 4)),
            lambda: pnn.Sequential(pnn.Linear(8, 8, device="cpu"), pnn.ReLU(),
                                   pnn.Linear(8, 4, device="cpu")))


def test_prune_masks_identical_to_jax():
    jnet, tnet = _asp_pair(3, *_mlp())
    jmasks = jasp.prune_model(jnet)
    tmasks = asp.prune_model(tnet)
    assert len(jmasks) == len(tmasks) == 2
    for jm, (name, tm) in zip(jmasks.values(), sorted(tmasks.items())):
        np.testing.assert_array_equal(tm.numpy().T, np.asarray(jm.numpy()))
    for i in (0, 2):
        np.testing.assert_array_equal(_np(tnet[i].weight).T,
                                      _np(jnet[i].weight))
        assert abs(asp.calculate_density(tnet[i].weight) - 0.5) < 1e-6
        # every group of 4 along Paddle's last axis has 2 nonzeros
        g = (_np(tnet[i].weight).T.reshape(-1, 4) != 0).sum(1)
        assert (g == 2).all()


def test_sparsity_survives_training():
    jnet, tnet = _asp_pair(4, lambda: jnn.Linear(8, 8, bias_attr=False),
                           lambda: pnn.Linear(8, 8, bias_attr=False,
                                              device="cpu"))
    jasp.prune_model(jnet)
    asp.prune_model(tnet)
    jopt = jasp.decorate(paddle.optimizer.Adam(0.01,
                                               parameters=jnet.parameters()))
    topt = asp.decorate(popt.Adam(tnet.parameters(), lr=0.01))
    rs = np.random.RandomState(1)
    x = rs.randn(4, 8).astype(np.float32)
    y = rs.randn(4, 8).astype(np.float32)
    for _ in range(5):
        _step(jnet, jopt, x, y, True)
        _step(tnet, topt, x, y, False)
    assert abs(asp.calculate_density(tnet.weight) - 0.5) < 1e-6
    np.testing.assert_allclose(_np(tnet.weight).T, _np(jnet.weight),
                               atol=ATOL)


def test_sparsity_survives_o2_masters():
    _, tnet = _asp_pair(4, lambda: jnn.Linear(8, 8, bias_attr=False),
                        lambda: pnn.Linear(8, 8, bias_attr=False,
                                           device="cpu"))
    from paddle_tpu_torch import amp

    asp.prune_model(tnet)
    inner = popt.Adam(tnet.parameters(), lr=0.01)
    tnet, inner = amp.decorate(tnet, optimizers=inner, level="O2")
    opt = asp.decorate(inner)
    x = torch.randn(4, 8, dtype=torch.bfloat16)
    for _ in range(3):
        (tnet(x).float() ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    master = inner.state[tnet.weight]["master_weight"]
    assert abs(asp.calculate_density(master) - 0.5) < 1e-6
    assert abs(asp.calculate_density(tnet.weight.float()) - 0.5) < 1e-6


def test_excluded_layers():
    _, tnet = _asp_pair(5, lambda: jnn.Linear(8, 8, bias_attr=False),
                        lambda: pnn.Linear(8, 8, bias_attr=False,
                                           device="cpu"))
    for excluded in (["weight"], [tnet.weight]):
        asp.set_excluded_layers(excluded)
        try:
            assert not asp.prune_model(tnet)
            assert asp.calculate_density(tnet.weight) == 1.0
        finally:
            asp.reset_excluded_layers()


def test_asp_skips_embedding():
    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = jnn.Embedding(16, 8)
            self.fc = jnn.Linear(8, 8)

        def forward(self, x):
            return self.fc(self.emb(x))

    class TNet(pnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pnn.Embedding(16, 8, device="cpu")
            self.fc = pnn.Linear(8, 8, device="cpu")

    jnet, tnet = _asp_pair(10, JNet, TNet)
    jasp.prune_model(jnet)
    masks = asp.prune_model(tnet)
    assert sorted(masks) == ["fc.weight"]
    assert asp.calculate_density(tnet.emb.weight) == 1.0
    assert abs(asp.calculate_density(tnet.fc.weight) - 0.5) < 1e-6
    np.testing.assert_array_equal(_np(tnet.fc.weight).T, _np(jnet.fc.weight))
