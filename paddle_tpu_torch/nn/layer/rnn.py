"""Recurrent layers: the cells, ``RNN``, ``BiRNN`` and the multi-layer
``SimpleRNN``, ``LSTM`` and ``GRU``.

Port of ``paddle_tpu/nn/layer/rnn.py``.  A cell owns four parameters,
``weight_ih [gates·hidden, input]``, ``weight_hh [gates·hidden, hidden]``,
``bias_ih`` and ``bias_hh`` (``[gates·hidden]``), in Paddle's layout, all
drawn from ``Uniform(±1/√hidden)``.  They are plain parameters of the
cell, not ``nn.Linear`` submodules: Paddle's layout is already torch's
``[out, in]``, so ``models.port_state_dict_from_jax`` takes them as they
are (it transposes only the 2-D tensors of an ``nn.Linear``).  Gate order
is i, f, g, o for the LSTM and r, z, c for the GRU, whose ``r`` multiplies
``h·W_hhᵀ + b_hh`` and whose output is ``(1 − z)·c + z·h``.

The time loop is a Python loop of torch ops over the steps, in the order
of the JAX package's ``lax.scan`` (reversed for ``is_reverse``), with
dropout between stacked layers only.  As in the JAX package:

- ``sequence_length`` is accepted and not read: padded steps flow into
  the states (ROADMAP C);
- ``RNN`` and ``BiRNN`` run the three built-in cells only; any other cell
  raises ``TypeError`` (the JAX package fails on it with an
  ``AttributeError``; ROADMAP C);
- ``get_initial_states`` gives float32 zeros (``init_value``) of
  ``[batch, hidden]`` and does not read ``shape``.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer
from .container import LayerList

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    """The base of a cell: ``forward(inputs, states) -> (out, states)``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``init_value`` states ``[batch, hidden_size]`` (``shape`` is
        not read, as in the JAX package), float32 unless ``dtype``."""
        batch = batch_ref.shape[batch_dim_idx]
        dtype = I._dtype(dtype) if isinstance(dtype, str) \
            else (dtype or torch.float32)

        def full():
            return torch.full([batch, self.hidden_size], init_value,
                              dtype=dtype, device=batch_ref.device)

        if getattr(self, "state_count", 1) == 1:
            return full()
        return tuple(full() for _ in range(self.state_count))


def _cell_params(layer, input_size, hidden_size, gates, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr, device, dtype):
    std = 1.0 / math.sqrt(hidden_size)
    law = I.Uniform(-std, std)
    kw = dict(dtype=dtype, device=device, default_initializer=law)
    layer.weight_ih = layer.create_parameter(
        [gates * hidden_size, input_size], attr=weight_ih_attr, **kw)
    layer.weight_hh = layer.create_parameter(
        [gates * hidden_size, hidden_size], attr=weight_hh_attr, **kw)
    layer.bias_ih = layer.create_parameter(
        [gates * hidden_size], attr=bias_ih_attr, is_bias=True, **kw)
    layer.bias_hh = layer.create_parameter(
        [gates * hidden_size], attr=bias_hh_attr, is_bias=True, **kw)


def _lstm_step(x, h, c, w_ih, w_hh, b_ih, b_hh):
    z = x @ w_ih.T + h @ w_hh.T
    if b_ih is not None:
        z = z + b_ih
    if b_hh is not None:
        z = z + b_hh
    i, f, g, o = z.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def _gru_step(x, h, w_ih, w_hh, b_ih, b_hh):
    gi = x @ w_ih.T + (b_ih if b_ih is not None else 0.0)
    gh = h @ w_hh.T + (b_hh if b_hh is not None else 0.0)
    ir, iz, ic = gi.chunk(3, dim=-1)
    hr, hz, hc = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    c = torch.tanh(ic + r * hc)
    return (1 - z) * c + z * h


def _simple_step(x, h, w_ih, w_hh, b_ih, b_hh, activation):
    z = x @ w_ih.T + h @ w_hh.T
    if b_ih is not None:
        z = z + b_ih
    if b_hh is not None:
        z = z + b_hh
    return torch.tanh(z) if activation == "tanh" else torch.relu(z)


class SimpleRNNCell(RNNCellBase):
    state_count = 1

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                     dtype)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = _simple_step(inputs, states, self.weight_ih, self.weight_hh,
                           self.bias_ih, self.bias_hh, self.activation)
        return out, out


class LSTMCell(RNNCellBase):
    state_count = 2

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                     dtype)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        h, c = _lstm_step(inputs, h, c, self.weight_ih, self.weight_hh,
                          self.bias_ih, self.bias_hh)
        return h, (h, c)


class GRUCell(RNNCellBase):
    state_count = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                     dtype)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = _gru_step(inputs, states, self.weight_ih, self.weight_hh,
                        self.bias_ih, self.bias_hh)
        return out, out


def _mode(cell) -> str:
    """The built-in cell's step, or ``TypeError`` for any other cell."""
    if isinstance(cell, LSTMCell):
        return "lstm"
    if isinstance(cell, GRUCell):
        return "gru"
    if isinstance(cell, SimpleRNNCell):
        return "simple"
    raise TypeError(
        f"RNN/BiRNN run the built-in cells only (SimpleRNNCell, LSTMCell, "
        f"GRUCell), as the JAX package's RNN does; got "
        f"{type(cell).__name__}: loop over its steps yourself")


def _run_rnn_layer(inputs, initial_states, cell, mode, is_reverse,
                   time_major):
    """One direction of one layer over every step: ``(out, final)``,
    ``final`` an ``(h, c)`` pair for the LSTM, ``h`` otherwise."""
    if initial_states is None:
        initial_states = cell.get_initial_states(
            inputs, batch_dim_idx=1 if time_major else 0)
    weights = (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)
    xs = inputs if time_major else inputs.transpose(0, 1)   # [T, B, I]
    steps = range(xs.shape[0])
    ys = [None] * xs.shape[0]
    if mode == "lstm":
        h, c = initial_states
        for t in (reversed(steps) if is_reverse else steps):
            h, c = _lstm_step(xs[t], h, c, *weights)
            ys[t] = h
        final = (h, c)
    else:
        h = initial_states
        act = getattr(cell, "activation", "tanh")
        for t in (reversed(steps) if is_reverse else steps):
            h = _gru_step(xs[t], h, *weights) if mode == "gru" \
                else _simple_step(xs[t], h, *weights, act)
            ys[t] = h
        final = h
    out = torch.stack(ys, dim=0)
    return (out if time_major else out.transpose(0, 1)), final


class RNN(Layer):
    """A cell looped over time (``inputs`` ``[B, T, I]``, or ``[T, B, I]``
    with ``time_major``); ``sequence_length`` is not read."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return _run_rnn_layer(inputs, initial_states, self.cell,
                              _mode(self.cell), self.is_reverse,
                              self.time_major)


class _MultiLayerRNN(Layer):
    _cell_cls = None
    _mode = "simple"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, **cell_kwargs):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        attrs = dict(weight_ih_attr=weight_ih_attr,
                     weight_hh_attr=weight_hh_attr,
                     bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr,
                     **cell_kwargs)
        self.fw_cells = LayerList()
        self.bw_cells = LayerList() if self.bidirect else None
        for i in range(num_layers):
            in_sz = input_size if i == 0 \
                else hidden_size * (2 if self.bidirect else 1)
            self.fw_cells.append(self._cell_cls(in_sz, hidden_size, **attrs))
            if self.bidirect:
                self.bw_cells.append(self._cell_cls(in_sz, hidden_size,
                                                    **attrs))

    @property
    def state_components(self):
        return 2 if self._mode == "lstm" else 1

    def forward(self, inputs, initial_states=None, sequence_length=None):
        two_state = self._mode == "lstm"
        n_dirs = 2 if self.bidirect else 1
        out = inputs
        final_h, final_c = [], []
        for i in range(self.num_layers):
            init = [None, None]
            if initial_states is not None:
                for d in range(n_dirs):
                    k = i * n_dirs + d
                    init[d] = (initial_states[0][k], initial_states[1][k]) \
                        if two_state else initial_states[k]
            fw_out, fw_state = _run_rnn_layer(
                out, init[0], self.fw_cells[i], self._mode, False,
                self.time_major)
            states = [fw_state]
            if self.bidirect:
                bw_out, bw_state = _run_rnn_layer(
                    out, init[1], self.bw_cells[i], self._mode, True,
                    self.time_major)
                out = torch.cat([fw_out, bw_out], dim=-1)
                states.append(bw_state)
            else:
                out = fw_out
            if self.dropout > 0.0 and i < self.num_layers - 1:
                out = F.dropout(out, p=self.dropout, training=self.training)
            for st in states:
                if two_state:
                    final_h.append(st[0])
                    final_c.append(st[1])
                else:
                    final_h.append(st)
        if two_state:
            return out, (torch.stack(final_h, 0), torch.stack(final_c, 0))
        return out, torch.stack(final_h, 0)


class SimpleRNN(_MultiLayerRNN):
    _cell_cls = SimpleRNNCell
    _mode = "simple"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kwargs)


class LSTM(_MultiLayerRNN):
    _cell_cls = LSTMCell
    _mode = "lstm"


class GRU(_MultiLayerRNN):
    _cell_cls = GRUCell
    _mode = "gru"


class BiRNN(Layer):
    """Two cells over the sequence, forward and reversed, their outputs
    concatenated on the last axis; states ``(fw_state, bw_state)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        init_fw = init_bw = None
        if initial_states is not None:
            init_fw, init_bw = initial_states
        fw_out, fw_state = _run_rnn_layer(
            inputs, init_fw, self.cell_fw, _mode(self.cell_fw), False,
            self.time_major)
        bw_out, bw_state = _run_rnn_layer(
            inputs, init_bw, self.cell_bw, _mode(self.cell_bw), True,
            self.time_major)
        return torch.cat([fw_out, bw_out], dim=-1), (fw_state, bw_state)
