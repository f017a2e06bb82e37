"""The port's ``BeamSearchDecoder`` and ``dynamic_decode``
(``paddle_tpu_torch/nn/layer/decode.py``) against the JAX package's, on
the CPU.

Spec: ``tests/test_decode.py`` (``TestBeamSearch``,
``TestReviewRegressions``).  Beam ids and parents are held bitwise, scores
at 1e-5, on two cells: ``_DeterministicCell``'s table of
``tests/test_decode.py`` (exact ties in every step: ``lax.top_k``'s order,
the lower flat index first, must be kept) and an ``LSTMCell`` with an
embedding and an output ``Linear`` (the port's weights through
``models.port_state_dict_from_jax``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import device as tdevice
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.models import port_state_dict_from_jax
from test_decode import _DeterministicCell as _JaxDeterministicCell

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with tdevice.device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


class DeterministicCell(tnn.Layer):
    """The port's ``_DeterministicCell``: token t prefers (t+1) % V (logit
    5 against -5 elsewhere); V-1 is the end token."""

    def __init__(self, vocab):
        super().__init__()
        self.vocab = vocab
        tbl = np.full((vocab, vocab), -5.0, np.float32)
        for t in range(vocab):
            tbl[t, (t + 1) % vocab] = 5.0
        self.register_buffer("_tbl", torch.from_numpy(tbl))

    def forward(self, inputs, states):
        return self._tbl.index_select(0, inputs), states


def _recording(base):
    """``base`` whose ``finalize`` keeps the raw step outputs (``[T, B,
    K]`` scores, ids, parents) before the backtrace."""
    class Recording(base):
        def finalize(self, outputs, final_states, sequence_lengths):
            self.raw = outputs
            return super().finalize(outputs, final_states, sequence_lengths)

    return Recording


def _decode_both(jcell, tcell, B, K, V, init, steps, jkw=None, tkw=None,
                 **dkw):
    jdec = _recording(jnn.BeamSearchDecoder)(jcell, 0, V - 1, K, **(jkw or
                                                                   {}))
    tdec = _recording(tnn.BeamSearchDecoder)(tcell, 0, V - 1, K, **(tkw or
                                                                   {}))
    jout = jnn.dynamic_decode(jdec, inits=paddle.to_tensor(init[0])
                              if not isinstance(init[0], tuple) else tuple(
                                  paddle.to_tensor(a) for a in init[0]),
                              max_step_num=steps, return_length=True, **dkw)
    tout = tnn.dynamic_decode(tdec, inits=torch.from_numpy(init[1])
                              if not isinstance(init[1], tuple) else tuple(
                                  torch.from_numpy(a) for a in init[1]),
                              max_step_num=steps, return_length=True, **dkw)
    return jdec, tdec, jout, tout


def _check_same(jdec, tdec, jout, tout):
    for f in ("predicted_ids", "parent_ids"):
        np.testing.assert_array_equal(_np(getattr(tdec.raw, f)),
                                      _np(getattr(jdec.raw, f)), err_msg=f)
    np.testing.assert_allclose(_np(tdec.raw.scores), _np(jdec.raw.scores),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(tout[0]), _np(jout[0]))   # backtraced
    np.testing.assert_array_equal(_np(tout[2]), _np(jout[2]))   # lengths
    np.testing.assert_array_equal(_np(tout[1].finished),
                                  _np(jout[1].finished))


@pytest.mark.parametrize("V,B,K,steps", [(6, 2, 3, 10), (4, 1, 2, 8),
                                         (5, 3, 5, 6), (7, 2, 4, 3)])
def test_tie_table_matches_jax_bitwise(V, B, K, steps):
    """Every step of the table ties exactly (equal rows, the -1e9 beams
    after ``initialize``): ids and parents must follow ``lax.top_k``."""
    zeros = np.zeros((B, 1), np.float32)
    jdec, tdec, jout, tout = _decode_both(
        _JaxDeterministicCell(V), DeterministicCell(V), B, K, V,
        (zeros, zeros), steps)
    _check_same(jdec, tdec, jout, tout)
    # the ties are real: equal scores inside one step's K (from K = 3:
    # the best token and K - 1 of the V - 1 equal others)
    sc = _np(tdec.raw.scores)
    assert K < 3 or any(len(np.unique(sc[t, b])) < K for t in range(sc.shape[0])
               for b in range(B))


def test_top_k_keeps_the_lower_index_first_among_ties():
    flat = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, -1e9, -1e9, -1e9]])
    scores, idx = tnn.BeamSearchDecoder._top_k(flat, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    assert scores.tolist() == [[3.0, 3.0, 3.0, 1.0, 0.0]]
    scores, idx = tnn.BeamSearchDecoder._top_k(flat[:, 5:], 2)
    assert idx.tolist() == [[0, 1]]


class _LstmDecoderCell:
    """An ``LSTMCell`` whose step takes an extra ``bias`` kwarg (added to
    its output), as ``dynamic_decode(**kwargs)`` hands it on."""

    def __init__(self, cell):
        self.cell = cell

    def __call__(self, x, states, bias=None):
        out, states = self.cell(x, states)
        return (out if bias is None else out + bias), states


@pytest.mark.parametrize("impute", [False, True])
def test_lstm_beam_search_matches_jax(impute):
    V, E, H, B, K = 13, 6, 8, 3, 4
    paddle.seed(5)
    jemb, jcell, jproj = jnn.Embedding(V, E), jnn.LSTMCell(E, H), \
        jnn.Linear(H, V)
    temb, tcell, tproj = tnn.Embedding(V, E), tnn.LSTMCell(E, H), \
        tnn.Linear(H, V)
    for j, t in ((jemb, temb), (jcell, tcell), (jproj, tproj)):
        sd = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
        t.set_state_dict(port_state_dict_from_jax(t, sd))
    rs = np.random.RandomState(2)
    h0, c0 = (np.asarray(rs.randn(B, H), np.float32) for _ in range(2))
    # logits scaled by 4: peaked enough that some beams end early
    jdec, tdec, jout, tout = _decode_both(
        jcell, tcell, B, K, V, ((h0, c0), (h0, c0)), 7,
        jkw=dict(embedding_fn=jemb, output_fn=lambda o: jproj(o) * 4.0),
        tkw=dict(embedding_fn=temb, output_fn=lambda o: tproj(o) * 4.0),
        impute_finished=impute)
    _check_same(jdec, tdec, jout, tout)


def test_kwargs_reach_the_cell_in_both_packages():
    V, E, H, B, K = 9, 4, 5, 2, 3
    paddle.seed(6)
    jemb, jcell, jproj = jnn.Embedding(V, E), jnn.LSTMCell(E, H), \
        jnn.Linear(H, V)
    temb, tcell, tproj = tnn.Embedding(V, E), tnn.LSTMCell(E, H), \
        tnn.Linear(H, V)
    for j, t in ((jemb, temb), (jcell, tcell), (jproj, tproj)):
        sd = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
        t.set_state_dict(port_state_dict_from_jax(t, sd))
    h0 = np.zeros((B, H), np.float32)
    bias = np.asarray(np.random.RandomState(3).randn(H) * 3, np.float32)
    jdec = jnn.BeamSearchDecoder(_LstmDecoderCell(jcell), 0, V - 1, K,
                                 embedding_fn=jemb, output_fn=jproj)
    tdec = tnn.BeamSearchDecoder(_LstmDecoderCell(tcell), 0, V - 1, K,
                                 embedding_fn=temb, output_fn=tproj)
    jo, _ = jnn.dynamic_decode(jdec, inits=(paddle.to_tensor(h0),
                                            paddle.to_tensor(h0)),
                               max_step_num=5, bias=paddle.to_tensor(bias))
    to, _ = tnn.dynamic_decode(tdec, inits=(torch.from_numpy(h0),
                                            torch.from_numpy(h0)),
                               max_step_num=5, bias=torch.from_numpy(bias))
    np.testing.assert_array_equal(_np(to), _np(jo))
    plain, _ = tnn.dynamic_decode(tdec, inits=(torch.from_numpy(h0),
                                               torch.from_numpy(h0)),
                                  max_step_num=5)
    assert not np.array_equal(_np(plain), _np(to))


def test_gather_tree_backtrace_is_consistent_with_parents():
    V, B, K = 6, 2, 3
    dec = _recording(tnn.BeamSearchDecoder)(DeterministicCell(V), 0, V - 1,
                                            K)
    out, _ = tnn.dynamic_decode(dec, inits=torch.zeros(B, 1),
                                max_step_num=9, output_time_major=True)
    ids, parents = _np(dec.raw.predicted_ids), _np(dec.raw.parent_ids)
    T = ids.shape[0]
    want = np.empty_like(ids)
    for b in range(B):
        for k in range(K):
            beam = k
            for t in range(T - 1, -1, -1):
                want[t, b, k] = ids[t, b, beam]
                beam = parents[t, b, beam]
    np.testing.assert_array_equal(_np(out), want)
    np.testing.assert_array_equal(
        _np(tF.gather_tree(dec.raw.predicted_ids, dec.raw.parent_ids)), want)


# ---- tests/test_decode.py, on the port ------------------------------------

def test_greedy_path_found():
    V, B, K = 6, 2, 3
    dec = tnn.BeamSearchDecoder(DeterministicCell(V), start_token=0,
                                end_token=V - 1, beam_size=K)
    outputs, _ = tnn.dynamic_decode(dec, inits=torch.zeros(B, 1),
                                    max_step_num=10)
    ids = _np(outputs)            # [B, T, K], backtraced
    np.testing.assert_array_equal(ids[0, :5, 0], [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(ids[1, :5, 0], [1, 2, 3, 4, 5])
    assert (ids[0, 5:, 0] == 5).all()


def test_finished_beams_freeze():
    dec = tnn.BeamSearchDecoder(DeterministicCell(4), start_token=0,
                                end_token=3, beam_size=2)
    _, _, lengths = tnn.dynamic_decode(dec, inits=torch.zeros(1, 1),
                                       max_step_num=8, return_length=True)
    assert int(_np(lengths)[0, 0]) == 3


def test_tile_beam_merge():
    x = torch.arange(4, dtype=torch.float32).reshape(2, 2)
    t = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(x, 3)
    assert tuple(t.shape) == (6, 2)
    np.testing.assert_array_equal(_np(t)[0], _np(t)[1])
    j = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        paddle.to_tensor(_np(x)), 3)
    np.testing.assert_array_equal(_np(t), _np(j))


def test_time_major_output():
    dec = tnn.BeamSearchDecoder(DeterministicCell(4), start_token=0,
                                end_token=3, beam_size=2)
    out_tm, _ = tnn.dynamic_decode(dec, inits=torch.zeros(1, 1),
                                   max_step_num=8, output_time_major=True)
    out_bm, _ = tnn.dynamic_decode(dec, inits=torch.zeros(1, 1),
                                   max_step_num=8)
    assert out_tm.shape[0] == out_bm.shape[1]


def test_max_step_zero():
    dec = tnn.BeamSearchDecoder(DeterministicCell(4), start_token=0,
                                end_token=3, beam_size=2)
    out, _ = tnn.dynamic_decode(dec, inits=torch.zeros(1, 1),
                                max_step_num=0)
    assert out is None


def test_finished_accumulates_for_plain_decoder():
    """A decoder with ``tracks_own_finished=False`` that reports a finish
    once stays finished (OR semantics)."""
    calls = []

    class Flaky(tnn.Decoder):
        def initialize(self, inits):
            z = torch.zeros(1, 1)
            return z, z, torch.tensor([[False]])

        def step(self, time, inputs, states, **kw):
            calls.append(time)
            return inputs, states, inputs, torch.tensor([[time == 0]])

    tnn.dynamic_decode(Flaky(), max_step_num=10)
    assert calls == [0]


def test_no_int64_warnings():
    import warnings

    dec = tnn.BeamSearchDecoder(DeterministicCell(4), start_token=0,
                                end_token=3, beam_size=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tnn.dynamic_decode(dec, inits=torch.zeros(1, 1), max_step_num=4)
    assert not [x for x in w if "int64" in str(x.message)]
