"""The port's recurrent layers (``paddle_tpu_torch/nn/layer/rnn.py``)
against the JAX package's, on the CPU.

Spec: ``tests/test_nn.py::TestRNN``, and every layer of
``paddle_tpu/nn/layer/rnn.py`` on seeded numpy inputs: the cells, ``RNN``
(forward and reversed, batch- and time-major), ``BiRNN``, and
``SimpleRNN``/``LSTM``/``GRU`` at 1 and 2 layers, forward and
bidirectional, with and without initial states.  The port's weights come
from the JAX layer's ``state_dict()`` through
``models.port_state_dict_from_jax``.  Outputs, final states and the
gradients of ``sum(out * c)`` (``c`` seeded) with respect to the input and
every weight are held at 1e-5 (absolute and relative, f32).

Two things the JAX package does are held as its behaviour: it ignores
``sequence_length`` (padded steps flow into the states), and its ``RNN``
runs only the built-in cells (the port refuses another with
``TypeError``).  Dropout between stacked layers is held to its law, not
to the JAX package's bits.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import device as tdevice
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import port_state_dict_from_jax
from paddle_tpu_torch.nn.layer import rnn as trnn

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded (an earlier file in the worker may
    leave a mesh set), the port's layers are built on the CPU."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with tdevice.device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _close(got, want, what="", tol=TOL):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want),
                                                             np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _r(seed, *shape):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _flat(x):
    """Tensors of a nested output, in order."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _twin(jlayer, tlayer):
    """``tlayer`` with ``jlayer``'s weights."""
    sd = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    tlayer.set_state_dict(port_state_dict_from_jax(tlayer, sd))
    return tlayer


def _run_both(jlayer, tlayer, args, grad=True, seed=11):
    """Run both layers on ``args`` (numpy arrays and nested tuples of
    them; the first is the input and is differentiated), compare every
    output, then the gradients of ``sum(out_i * c_i)`` over the outputs."""
    def conv(a, to):
        if isinstance(a, (list, tuple)):
            return type(a)(conv(v, to) for v in a)
        return to(a) if isinstance(a, np.ndarray) else a

    jx = paddle.to_tensor(args[0], stop_gradient=False)
    tx = torch.from_numpy(args[0].copy()).requires_grad_()
    jout = _flat(jlayer(jx, *conv(args[1:], paddle.to_tensor)))
    tout = _flat(tlayer(tx, *conv(args[1:], lambda a: torch.from_numpy(
        a.copy()))))
    assert len(jout) == len(tout)
    for i, (j, t) in enumerate(zip(jout, tout)):
        _close(t, j, f"output {i}")
    if not grad:
        return
    rs = np.random.RandomState(seed)
    cs = [np.asarray(rs.randn(*_np(t).shape), np.float32) for t in tout]
    jloss = sum((j * paddle.to_tensor(c)).sum() for j, c in zip(jout, cs))
    tloss = sum((t * torch.from_numpy(c)).sum() for t, c in zip(tout, cs))
    jloss.backward()
    tloss.backward()
    _close(tx.grad, jx.grad, "input grad")
    jparams = dict(jlayer.named_parameters())
    for name, p in tlayer.named_parameters():
        _close(p.grad, jparams[name].grad, f"{name} grad")


CELLS = [("simple_tanh", lambda m: m.SimpleRNNCell(5, 6)),
         ("simple_relu", lambda m: m.SimpleRNNCell(5, 6, activation="relu")),
         ("lstm", lambda m: m.LSTMCell(5, 6)),
         ("gru", lambda m: m.GRUCell(5, 6))]


def _cell_states(name, batch=3, hidden=6, seed=4):
    if name == "lstm":
        return (_r(seed, batch, hidden), _r(seed + 1, batch, hidden))
    return _r(seed, batch, hidden)


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("name,make", CELLS, ids=[c[0] for c in CELLS])
def test_cell_matches_jax(name, make, with_states):
    j = make(jnn)
    t = _twin(j, make(tnn))
    args = [_r(1, 3, 5)]
    if with_states:
        args.append(_cell_states(name))
    _run_both(j, t, args)


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("is_reverse", [False, True])
@pytest.mark.parametrize("name,make", CELLS, ids=[c[0] for c in CELLS])
def test_rnn_over_cell_matches_jax(name, make, is_reverse, time_major):
    j = jnn.RNN(make(jnn), is_reverse=is_reverse, time_major=time_major)
    t = _twin(j, tnn.RNN(make(tnn), is_reverse=is_reverse,
                         time_major=time_major))
    x = _r(2, 4, 3, 5) if time_major else _r(2, 3, 4, 5)
    grad = name in ("lstm", "gru") and not time_major
    _run_both(j, t, [x, _cell_states(name)] if is_reverse else [x],
              grad=grad)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_birnn_matches_jax(kind):
    cls = {"lstm": "LSTMCell", "gru": "GRUCell"}[kind]
    j = jnn.BiRNN(getattr(jnn, cls)(5, 6), getattr(jnn, cls)(5, 6))
    t = _twin(j, tnn.BiRNN(getattr(tnn, cls)(5, 6), getattr(tnn, cls)(5, 6)))
    _run_both(j, t, [_r(3, 2, 4, 5)])
    init = (_cell_states(kind, 2), _cell_states(kind, 2, seed=9))
    _run_both(j, t, [_r(3, 2, 4, 5), init], grad=False)


def _init_states(kind, layers, dirs, batch=2, hidden=6):
    n = layers * dirs
    if kind == "LSTM":
        return (_r(20, n, batch, hidden), _r(21, n, batch, hidden))
    return _r(20, n, batch, hidden)


MULTI = [(kind, layers, direction, init)
         for kind in ("SimpleRNN", "LSTM", "GRU")
         for layers in (1, 2)
         for direction in ("forward", "bidirect")
         for init in (False, True)]


@pytest.mark.parametrize("kind,layers,direction,init", MULTI,
                         ids=[f"{k}-{l}-{d}-{'init' if i else 'zeros'}"
                              for k, l, d, i in MULTI])
def test_multilayer_matches_jax(kind, layers, direction, init):
    j = getattr(jnn, kind)(5, 6, num_layers=layers, direction=direction)
    t = _twin(j, getattr(tnn, kind)(5, 6, num_layers=layers,
                                    direction=direction))
    args = [_r(5, 2, 4, 5)]
    if init:
        args.append(_init_states(kind, layers,
                                 2 if direction == "bidirect" else 1))
    # each JAX backward is a compile: gradients on the 2-layer cases
    _run_both(j, t, args, grad=layers == 2)


def test_time_major_multilayer_matches_jax():
    j = jnn.GRU(5, 6, num_layers=2, direction="bidirect", time_major=True)
    t = _twin(j, tnn.GRU(5, 6, num_layers=2, direction="bidirect",
                         time_major=True))
    _run_both(j, t, [_r(6, 4, 2, 5)])


@pytest.mark.parametrize("kind", ["LSTM", "GRU", "SimpleRNN"])
def test_square_weights_load_untransposed(kind):
    """At ``input_size == hidden_size`` a transposed ``weight_ih`` or
    ``weight_hh`` would pass the shape check: the values show it."""
    j = getattr(jnn, kind)(6, 6, num_layers=2)
    sd = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
    t = getattr(tnn, kind)(6, 6, num_layers=2)
    ported = port_state_dict_from_jax(t, sd)
    for name in ("fw_cells.0.weight_ih", "fw_cells.1.weight_hh"):
        w = sd[name]
        assert w.shape[0] != w.shape[1] or kind == "SimpleRNN"
        np.testing.assert_array_equal(ported[name].numpy(), w)
    # the square blocks of the 4- or 3-gate weights are not symmetric,
    # so a transpose would move values
    blk = sd["fw_cells.0.weight_hh"][:6]
    assert not np.allclose(blk, blk.T)
    t.set_state_dict(ported)
    _run_both(j, t, [_r(7, 2, 3, 6)], grad=False)


def test_sequence_length_is_ignored_as_in_jax():
    """Padded steps flow into the states in both packages: the results
    with ``sequence_length`` equal those without it."""
    j = jnn.LSTM(5, 6, num_layers=2)
    t = _twin(j, tnn.LSTM(5, 6, num_layers=2))
    x = _r(8, 3, 4, 5)
    lens = np.array([4, 2, 1], np.int64)
    jo, (jh, _) = j(paddle.to_tensor(x),
                    sequence_length=paddle.to_tensor(lens))
    to, (th, _) = t(torch.from_numpy(x), sequence_length=torch.from_numpy(
        lens))
    to2, (th2, _) = t(torch.from_numpy(x))
    _close(to, jo, "output")
    _close(th, jh, "final h")
    np.testing.assert_array_equal(_np(to), _np(to2))
    # the last row's final state took its padded steps (it differs from
    # its state after its one real step)
    assert not np.allclose(_np(th)[-1, 2], _np(to)[2, 0])


class _UserCell(tnn.RNNCellBase):
    def __init__(self):
        super().__init__()
        self.hidden_size = 4
        self.proj = tnn.Linear(5, 4)

    def forward(self, x, h):
        return self.proj(x) + h, self.proj(x) + h


def test_user_cell_is_refused():
    with pytest.raises(TypeError, match="built-in cells"):
        tnn.RNN(_UserCell())(torch.from_numpy(_r(9, 2, 3, 5)))
    with pytest.raises(TypeError, match="built-in cells"):
        tnn.BiRNN(_UserCell(), tnn.GRUCell(5, 4))(
            torch.from_numpy(_r(9, 2, 3, 5)))

    class JaxUserCell(jnn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = 4
            self.proj = jnn.Linear(5, 4)

        def forward(self, x, h):
            return self.proj(x) + h, self.proj(x) + h

    # the JAX package fails on it too, without a clear message
    with pytest.raises(AttributeError):
        jnn.RNN(JaxUserCell())(paddle.to_tensor(_r(9, 2, 3, 5)))


def test_user_cell_steps_by_hand():
    """A user's cell runs when the caller loops over the steps."""
    cell = _UserCell()
    x = torch.from_numpy(_r(10, 2, 3, 5))
    h = cell.get_initial_states(x)
    assert h.shape == (2, 4) and h.dtype == torch.float32
    for t in range(3):
        out, h = cell(x[:, t], h)
    assert out.shape == (2, 4)
    st = tnn.LSTMCell(5, 4).get_initial_states(x, init_value=1.0)
    assert len(st) == 2 and st[0].shape == (2, 4) and float(st[1][0, 0]) == 1


def test_dropout_between_layers_only(monkeypatch):
    """``dropout`` applies to every layer's output but the last, in
    training only, with the functional's law: share dropped near ``p``,
    kept values scaled by ``1 / (1 - p)``."""
    calls = []
    real = trnn.F.dropout

    def spy(x, p, training=True, **kw):
        out = real(x, p=p, training=training, **kw)
        calls.append((x.detach().clone(), out.detach().clone(), p,
                      training))
        return out

    monkeypatch.setattr(trnn.F, "dropout", spy)
    p = 0.3
    net = tnn.LSTM(16, 64, num_layers=3, dropout=p)
    x = torch.from_numpy(_r(11, 8, 20, 16))
    net.train()
    out_train, _ = net(x)
    assert len(calls) == 2 and all(c[2] == p and c[3] for c in calls)
    for before, after, _, _ in calls:
        kept = after != 0
        share = 1.0 - kept.float().mean().item()
        assert abs(share - p) < 0.02, share
        torch.testing.assert_close(after[kept], before[kept] / (1 - p))
    calls.clear()
    net.eval()
    out_a, _ = net(x)
    out_b, _ = net(x)
    assert all(not c[3] for c in calls)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    assert not torch.allclose(out_train, out_a)
    # one layer: no dropout at all
    calls.clear()
    tnn.LSTM(16, 8, num_layers=1, dropout=p).train()(x)
    assert calls == []


# ---- tests/test_nn.py::TestRNN, on both packages --------------------------

def test_lstm_shapes():
    for m, wrap in ((jnn, paddle.to_tensor), (tnn, torch.from_numpy)):
        lstm = m.LSTM(4, 8, num_layers=2)
        out, (h, c) = lstm(wrap(_r(12, 3, 6, 4)))
        assert list(out.shape) == [3, 6, 8]
        assert list(h.shape) == [2, 3, 8] and list(c.shape) == [2, 3, 8]


def test_bidirect_gru_shapes():
    for m, wrap in ((jnn, paddle.to_tensor), (tnn, torch.from_numpy)):
        out, h = m.GRU(4, 5, direction="bidirect")(wrap(_r(13, 2, 7, 4)))
        assert list(out.shape) == [2, 7, 10]
        assert list(h.shape) == [2, 2, 5]


def test_lstm_cell_matches_manual():
    cell = tnn.LSTMCell(3, 4)
    x = _r(14, 2, 3)
    h0 = np.zeros((2, 4), np.float32)
    c0 = np.zeros((2, 4), np.float32)
    out, (h, c) = cell(torch.from_numpy(x), (torch.from_numpy(h0),
                                             torch.from_numpy(c0)))
    z = x @ _np(cell.weight_ih).T + h0 @ _np(cell.weight_hh).T \
        + _np(cell.bias_ih) + _np(cell.bias_hh)
    i, f, g, o = np.split(z, 4, axis=-1)
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    c_ref = sig(f) * c0 + sig(i) * np.tanh(g)
    h_ref = sig(o) * np.tanh(c_ref)
    np.testing.assert_allclose(_np(h), h_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(c), c_ref, rtol=1e-4, atol=1e-5)


def test_rnn_gradients_flow():
    lstm = tnn.LSTM(3, 4)
    x = torch.from_numpy(_r(15, 2, 5, 3)).requires_grad_()
    out, _ = lstm(x)
    out.sum().backward()
    assert x.grad is not None
    assert lstm.fw_cells[0].weight_ih.grad is not None


def test_parameter_names_shapes_and_law():
    """The JAX names and Paddle shapes, and the ``Uniform(±1/√hidden)``
    law; ``bias_*_attr=False`` leaves the bias out in both packages."""
    j, t = jnn.GRU(5, 8, num_layers=2), tnn.GRU(5, 8, num_layers=2)
    jsd = {k: tuple(v.shape) for k, v in j.state_dict().items()}
    tsd = {k: tuple(v.shape) for k, v in t.state_dict().items()}
    assert jsd == tsd
    assert tsd["fw_cells.0.weight_ih"] == (24, 5)
    big = tnn.LSTMCell(64, 400)
    w = _np(big.weight_hh)
    bound = 1 / np.sqrt(400)
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.99 * bound
    assert abs(w.mean()) < 1e-3 and abs(w.std() - bound / np.sqrt(3)) < 1e-3
    nb = tnn.GRUCell(5, 4, bias_ih_attr=False, bias_hh_attr=False)
    jb = jnn.GRUCell(5, 4, bias_ih_attr=False, bias_hh_attr=False)
    assert nb.bias_ih is None and sorted(nb.state_dict()) == \
        sorted(jb.state_dict()) == ["weight_hh", "weight_ih"]
    _run_both(jb, _twin(jb, nb), [_r(16, 3, 5)])
