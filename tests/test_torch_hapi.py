"""The port's ``hapi`` (``Model``, callbacks, ``summary``, ``flops``)
against the JAX package's, on the CPU.

Spec: ``tests/test_hapi_e2e.py`` (``TestModelFit``, ``TestSummary``), the
hapi cases of ``tests/test_sentry.py::TestHapiFit``,
``tests/test_fault_tolerance.py::TestHapiIntegration`` and the fit cases
of ``tests/test_train_obs.py``.  A tiny classifier starts from the JAX
model's weights (``models.port_state_dict_from_jax``) and trains through
both packages' ``Model.fit`` over the same batches (``shuffle=False``):
the loss of every batch, the ``evaluate`` logs and the ``predict``
outputs are held at 1e-5 (absolute and relative, f32).  The port's
``DivergenceSentry`` is built with ``device="cpu"`` (its default is the
card).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.model import Model as JaxModel
import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.fault_tolerance import (
    ANOMALY_NONFINITE_LOSS, DivergenceSentry, SentryEscalation,
)
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import port_state_dict_from_jax
from paddle_tpu_torch.obs import StepTimeline, validate_timeline
from paddle_tpu_torch import profiler as tprofiler

torch.set_num_threads(2)

TOL = 1e-5


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


def _twin(jnet, tnet):
    sd = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    tnet.set_state_dict(port_state_dict_from_jax(tnet, sd))
    return tnet


class ToyClassifier:
    """Linearly separable 2-class problem (``test_hapi_e2e.py``'s)."""

    def __init__(self, n=64, seed=0):
        rs = np.random.RandomState(seed)
        self.x = rs.randn(n, 16).astype(np.float32)
        self.y = (self.x @ rs.randn(16) > 0).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class _Losses:
    """The logs of every train batch (mixed into either package's
    ``Callback``)."""

    def setup(self):
        self.logs, self.epochs = [], 0

    def on_train_batch_end(self, step, logs=None):
        self.logs.append(dict(logs))

    def on_epoch_begin(self, epoch, logs=None):
        self.epochs += 1


class JaxLosses(_Losses, jcb.Callback):
    def __init__(self):
        super().__init__()
        self.setup()


class TorchLosses(_Losses, tcb.Callback):
    def __init__(self):
        super().__init__()
        self.setup()


def _classifiers(seed=7, lr=0.01):
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 2))
    tnet = _twin(jnet, tnn.Sequential(tnn.Linear(16, 32), tnn.ReLU(),
                                      tnn.Linear(32, 2)))
    jm = JaxModel(jnet)
    jm.prepare(optimizer=jopt.Adam(lr, parameters=jnet.parameters()),
               loss=jnn.CrossEntropyLoss(), metrics=jmetric.Accuracy())
    tm = ptt.Model(tnet)
    tm.prepare(optimizer=topt.Adam(tnet.parameters(), lr=lr),
               loss=tnn.CrossEntropyLoss(), metrics=tmetric.Accuracy())
    return jm, tm


def _close_logs(tlogs, jlogs):
    assert len(tlogs) == len(jlogs)
    for t, j in zip(tlogs, jlogs):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


def test_fit_loss_history_evaluate_and_predict_match_jax():
    jm, tm = _classifiers()
    ds = ToyClassifier()
    jrec, trec = JaxLosses(), TorchLosses()
    jm.fit(ds, batch_size=16, epochs=3, verbose=0, shuffle=False,
           callbacks=[jrec])
    tm.fit(ds, batch_size=16, epochs=3, verbose=0, shuffle=False,
           callbacks=[trec])
    assert len(trec.logs) == 12
    _close_logs(trec.logs, jrec.logs)
    assert trec.logs[-1]["loss"] < trec.logs[0]["loss"]
    _close_logs([tm.evaluate(ds, batch_size=20, verbose=0)],
                [jm.evaluate(ds, batch_size=20, verbose=0)])
    tp = tm.predict(ds, batch_size=24)
    jp = jm.predict(ds, batch_size=24)
    assert len(tp) == 1 and len(tp[0]) == 3
    for t, j in zip(tp[0], jp[0]):
        np.testing.assert_allclose(t, np.asarray(j), rtol=TOL, atol=TOL)
    st = tm.predict(ds, batch_size=24, stack_outputs=True)
    assert st[0].shape == (64, 2)


def test_fit_over_a_seeded_loader_matches_jax():
    """A ``DataLoader`` of a seeded ``RandomSampler`` given to ``fit``:
    the same shuffled batches, the same losses; with
    ``accumulate_grad_batches=2`` and ``num_iters``."""
    jm, tm = _classifiers(seed=9)
    ds = ToyClassifier(48, seed=1)

    def loader(io_mod):
        return io_mod.DataLoader(ds, batch_sampler=io_mod.BatchSampler(
            sampler=io_mod.RandomSampler(ds, generator=5), batch_size=8))

    jrec, trec = JaxLosses(), TorchLosses()
    jm.fit(loader(jio), epochs=2, verbose=0, callbacks=[jrec],
           accumulate_grad_batches=2, num_iters=5)
    tm.fit(loader(tio), epochs=2, verbose=0, callbacks=[trec],
           accumulate_grad_batches=2, num_iters=5)
    assert len(trec.logs) == 10
    _close_logs(trec.logs, jrec.logs)


def test_fit_with_two_workers_matches_the_single_process_fit():
    """``fit(num_workers=2)`` loads through the ring and trains as the
    loop's own loading does (the JAX package's fit reads no
    ``num_workers``)."""
    import torch_io_data

    ds = torch_io_data.RangeDataset(24)
    losses = {}
    for how in ("inline", "loader", "fit"):
        ptt.seed(0)
        net = tnn.Linear(1, 3)
        m = ptt.Model(net)
        m.prepare(optimizer=topt.SGD(net.parameters(), lr=0.1),
                  loss=tnn.CrossEntropyLoss())
        rec = TorchLosses()
        if how == "fit":       # fit makes the loader, with two workers
            m.fit(ds, batch_size=6, epochs=1, verbose=0, shuffle=False,
                  num_workers=2, callbacks=[rec])
        else:
            loader = tio.DataLoader(ds, batch_size=6, timeout=20,
                                    num_workers=2 if how == "loader" else 0)
            m.fit(loader, epochs=1, verbose=0, callbacks=[rec])
            want = 4 if how == "loader" else 0
            assert loader.transport == {"ring": want, "queue": 0}
        losses[how] = [lg["loss"] for lg in rec.logs]
    assert losses["inline"] == losses["loader"] == losses["fit"]
    assert len(losses["inline"]) == 4


def test_train_and_eval_batch_move_inputs_to_the_network():
    jm, tm = _classifiers()
    ds = ToyClassifier()
    # numpy inputs and labels, as fit's unpacked batches may be
    jl = jm.train_batch(paddle.to_tensor(ds.x[:8]), paddle.to_tensor(ds.y[:8]))
    tl = tm.train_batch(ds.x[:8], ds.y[:8])
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    je = jm.eval_batch(paddle.to_tensor(ds.x[8:16]),
                       paddle.to_tensor(ds.y[8:16]))
    te = tm.eval_batch(torch.from_numpy(ds.x[8:16]),
                       torch.from_numpy(ds.y[8:16]))
    np.testing.assert_allclose(te, je, rtol=TOL, atol=TOL)
    assert tm.eval_batch(ds.x[:4]) == []
    out = tm.predict_batch(ds.x[:4])
    assert isinstance(out, list) and out[0].shape == (4, 2)


def test_predict_nesting():
    net = tnn.Linear(4, 2)
    model = ptt.Model(net)
    model.prepare()
    ds = tio.TensorDataset([torch.randn(10, 4)])
    preds = model.predict(ds, batch_size=4, stack_outputs=True)
    assert len(preds) == 1 and preds[0].shape == (10, 2)
    raw = model.predict(ds, batch_size=4, verbose=0)
    assert len(raw) == 1 and len(raw[0]) == 3 and raw[0][0].shape == (4, 2)


class _SeqNet:
    """Embedding, LSTM and its last state: the same names and layouts in
    both packages (no ``Linear``), so a state file of one loads into the
    other as it is."""

    @staticmethod
    def make(nn):
        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(10, 4)
                self.rnn = nn.LSTM(4, 6)

            def forward(self, ids):
                _, (h, _) = self.rnn(self.emb(ids))
                return h[0]

        return Net()


def test_save_load_across_packages_both_ways(tmp_path):
    ids = np.random.RandomState(0).randint(0, 10, (5, 7))
    labels = np.random.RandomState(1).randint(0, 6, (5,))
    paddle.seed(3)
    jnet = _SeqNet.make(jnn)
    jm = JaxModel(jnet)
    jm.prepare(optimizer=jopt.Adam(0.01, parameters=jnet.parameters()),
               loss=jnn.CrossEntropyLoss())
    jm.train_batch(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jpath = str(tmp_path / "jax")
    jm.save(jpath)
    # JAX -> port: Model.load reads the JAX package's files as they are
    tnet = _SeqNet.make(tnn)
    tm = ptt.Model(tnet)
    tm.prepare(optimizer=topt.Adam(tnet.parameters(), lr=0.01),
               loss=tnn.CrossEntropyLoss())
    tm.load(jpath)
    np.testing.assert_allclose(tm.predict_batch(ids)[0],
                               jm.predict_batch(paddle.to_tensor(ids))[0],
                               rtol=TOL, atol=TOL)
    # the optimizer's moments came too: the next batch's loss agrees
    jl = jm.train_batch(paddle.to_tensor(ids), paddle.to_tensor(labels))
    tl = tm.train_batch(ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    # port -> JAX: the port's .pdparams read back as numpy arrays load
    # into the JAX network (the JAX loader does not know the port's
    # payload class)
    tm.train_batch(ids, labels)
    tpath = str(tmp_path / "port")
    tm.save(tpath)
    assert os.path.exists(tpath + ".pdopt")
    jnet2 = _SeqNet.make(jnn)
    jnet2.set_state_dict({k: paddle.to_tensor(v) for k, v in
                          ptt.framework.load(tpath + ".pdparams",
                                             return_numpy=True).items()})
    np.testing.assert_allclose(
        tm.predict_batch(ids)[0],
        JaxModel(jnet2).predict_batch(paddle.to_tensor(ids))[0],
        rtol=TOL, atol=TOL)
    # and round trip within the port, bitwise, the optimizer included
    tnet3 = _SeqNet.make(tnn)
    tm3 = ptt.Model(tnet3)
    tm3.prepare(optimizer=topt.Adam(tnet3.parameters(), lr=0.01),
                loss=tnn.CrossEntropyLoss())
    tm3.load(tpath)
    for (n, a), b in zip(tnet.state_dict().items(),
                         tnet3.state_dict().values()):
        assert torch.equal(a, b), n
    assert tm3.train_batch(ids, labels) == tm.train_batch(ids, labels)


def _summary_nets(nn):
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                         nn.ReLU(), nn.MaxPool2D(2), nn.Flatten(),
                         nn.Linear(64, 10), nn.Sigmoid())


def test_summary_and_flops_equal_jax(capsys):
    paddle.seed(1)
    jnet = _summary_nets(jnn)
    tnet = _twin(jnet, _summary_nets(tnn))
    jinfo = paddle.summary(jnet, (2, 3, 8, 8))
    jtable = capsys.readouterr().out
    tinfo = ptt.summary(tnet, (2, 3, 8, 8))
    ttable = capsys.readouterr().out
    assert tinfo == jinfo
    assert ttable == jtable
    assert ptt.flops(tnet, [2, 3, 8, 8]) == paddle.flops(jnet, [2, 3, 8, 8])
    flat = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    assert ptt.summary(flat, (1, 4))["total_params"] == 4 * 8 + 8 + 8 * 2 + 2
    assert ptt.Model(flat).summary((1, 4))["trainable_params"] == 58
    # custom_ops and an LSTM counted by the user's rule
    lstm = tnn.LSTM(4, 4)
    total = ptt.flops(lstm, [1, 3, 4], custom_ops={
        tnn.LSTM: lambda l, x, y: 7})
    assert total == 7


def test_early_stopping_stops_at_the_same_epoch():
    jm, tm = _classifiers(lr=0.0)      # no improvement: stops early
    ds = ToyClassifier(64)
    jrec, trec = JaxLosses(), TorchLosses()
    jm.fit(ds, eval_data=ds, batch_size=32, epochs=10, verbose=0,
           shuffle=False, callbacks=[jcb.EarlyStopping(
               monitor="loss", patience=1, verbose=0), jrec])
    tm.fit(ds, eval_data=ds, batch_size=32, epochs=10, verbose=0,
           shuffle=False, callbacks=[tcb.EarlyStopping(
               monitor="loss", patience=1, verbose=0), trec])
    assert tm.stop_training and jm.stop_training
    assert trec.epochs == jrec.epochs == 2


def test_visualdl_lines_match_jax(tmp_path):
    jm, tm = _classifiers()
    ds = ToyClassifier(32)
    jm.fit(ds, batch_size=8, epochs=1, verbose=0, shuffle=False,
           callbacks=[jcb.VisualDL(str(tmp_path / "j"))])
    tm.fit(ds, batch_size=8, epochs=1, verbose=0, shuffle=False,
           callbacks=[tcb.VisualDL(str(tmp_path / "t"))])
    jl = open(tmp_path / "j" / "train.tsv").read().splitlines()
    tl = open(tmp_path / "t" / "train.tsv").read().splitlines()
    assert len(tl) == len(jl) == 8
    for t, j in zip(tl, jl):
        ts, js = t.split("\t"), j.split("\t")
        assert ts[:2] == js[:2]
        np.testing.assert_allclose(float(ts[2]), float(js[2]), rtol=TOL,
                                   atol=TOL)


def test_model_checkpoint_generations_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    data = [(rs.randn(16).astype(np.float32), np.int64(i % 2))
            for i in range(12)]
    jm, tm = _classifiers()
    for m, d in ((jm, "j"), (tm, "t")):
        m.fit(data, epochs=2, batch_size=4, save_dir=str(tmp_path / d),
              save_steps=2, keep_last=2, verbose=0, shuffle=False)
    root = tcb.ModelCheckpoint.steps_root
    assert ckpt.list_generations(root(str(tmp_path / "t"))) == \
        ckpt.list_generations(root(str(tmp_path / "j"))) == [4, 6]
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_lr_scheduler_callback_steps_each_batch():
    from paddle_tpu_torch.optimizer import lr as tlr

    net = tnn.Linear(16, 2)
    sched = tlr.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
    m = ptt.Model(net)
    m.prepare(optimizer=topt.SGD(net.parameters(), lr=sched),
              loss=tnn.CrossEntropyLoss())
    m.fit(ToyClassifier(32), batch_size=8, epochs=1, verbose=0,
          shuffle=False, callbacks=[tcb.LRScheduler()])
    assert sched.last_epoch == 4 and abs(sched() - 0.025) < 1e-9


def test_progbar_prints(capsys):
    _, tm = _classifiers()
    tm.fit(ToyClassifier(32), batch_size=16, epochs=1, log_freq=1, verbose=2,
           shuffle=False)
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "step 2/2" in out and "acc:" in out


# ---- TestHapiFit (tests/test_sentry.py), on the port -----------------------

def _tiny_model(scaler=None, optimizer="adamw"):
    ptt.seed(21)
    net = tnn.Linear(4, 2)
    model = ptt.Model(net)
    opt = topt.AdamW(net.parameters(), lr=0.01) if optimizer == "adamw" \
        else topt.SGD(net.parameters(), lr=0.01)
    amp = {"level": "O1", "scaler": scaler} if scaler else None
    model.prepare(optimizer=opt, loss=lambda out, y: ((out - y) ** 2).mean(),
                  amp_configs=amp)
    return model


def _data(n=10, poison=(), seed=3):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rs.randn(4).astype(np.float32)
        if i in poison:
            x = x * np.float32("nan")
        out.append((x, rs.randn(2).astype(np.float32)))
    return out


def _sentry(**kw):
    kw = {"window": 8, "min_history": 3, "spike_factor": 50.0,
          "snapshot_every": 2, "ring_capacity": 2, "max_rollbacks": 2,
          "device": "cpu", **kw}
    return DivergenceSentry(**kw)


def test_fit_sentry_rolls_back_and_continues():
    events = []

    class Recorder(tcb.Callback):
        def on_rollback(self, step, report=None):
            events.append((step, report.code))

    model = _tiny_model()
    sentry = _sentry()
    model.fit(_data(poison={5}), epochs=1, batch_size=1, verbose=0,
              shuffle=False, sentry=sentry, callbacks=[Recorder()])
    assert sentry.anomalies == 1 and sentry.rollbacks == 1
    assert sorted(sentry.blocklist) == [5]
    assert events and events[0][0] == 5
    assert events[0][1] & ANOMALY_NONFINITE_LOSS
    assert torch.isfinite(model.network.weight).all()


def test_fit_rollback_leaves_metric_accumulators_clean():
    class MeanOut(tmetric.Metric):
        def __init__(self):
            self.samples = []

        def name(self):
            return "mean_out"

        def compute(self, pred, label):
            return float(pred.detach().mean())

        def update(self, v):
            self.samples.append(v)

        def accumulate(self):
            return float(np.mean(self.samples)) if self.samples else 0.0

        def reset(self):
            self.samples = []

    metric = MeanOut()
    model = _tiny_model()
    model._metrics = [metric]
    sentry = _sentry()
    model.fit(_data(poison={5}), epochs=1, batch_size=1, verbose=0,
              shuffle=False, sentry=sentry)
    assert sentry.rollbacks == 1
    assert len(metric.samples) == 9
    assert np.isfinite(metric.samples).all()


def test_fit_rollback_clears_accumulated_grads():
    model = _tiny_model()
    sentry = _sentry()
    model.fit(_data(poison={4}), epochs=1, batch_size=1, verbose=0,
              shuffle=False, sentry=sentry, accumulate_grad_batches=2)
    assert sentry.rollbacks == 1 and sentry.escalations == 0
    assert torch.isfinite(model.network.weight).all()
    for p in model.network.parameters():
        assert p.grad is None or torch.isfinite(p.grad).all()


def test_fit_sentry_escalates():
    model = _tiny_model()
    sentry = _sentry(max_rollbacks=0)
    with pytest.raises(SentryEscalation) as ei:
        model.fit(_data(poison={4, 5, 6}), epochs=1, batch_size=1,
                  verbose=0, shuffle=False, sentry=sentry)
    assert ei.value.flight_dump["reason"] == "sentry_escalation"
    assert sentry.escalations == 1 and sentry.rollbacks == 0
    assert torch.isfinite(model.network.weight).all()


def test_fit_amp_scaler_state_in_step_generations(tmp_path):
    scaler = GradScaler(init_loss_scaling=256.0)
    model = _tiny_model(scaler=scaler)
    save_dir = str(tmp_path / "run")
    model.fit(_data(8), epochs=1, batch_size=2, verbose=0, shuffle=False,
              save_dir=save_dir, save_steps=2)
    steps_root = tcb.ModelCheckpoint.steps_root(save_dir)
    _, state = ckpt.load_generation(steps_root, device="cpu")
    assert "@scaler" in state
    scaler2 = GradScaler(init_loss_scaling=4.0)
    m2 = _tiny_model(scaler=scaler2)
    assert m2.resume_from(steps_root) > 0
    assert scaler2.get_loss_scaling() == scaler.get_loss_scaling()


# ---- TestHapiIntegration (tests/test_fault_tolerance.py), on the port ------

def test_fit_step_generations_and_resume(tmp_path):
    data = _data(12)
    save_dir = str(tmp_path / "run")
    steps_root = tcb.ModelCheckpoint.steps_root(save_dir)
    m1 = _tiny_model()
    m1.fit(data, epochs=2, batch_size=4, save_dir=save_dir, save_steps=2,
           keep_last=2, verbose=0, shuffle=False)
    assert ckpt.list_generations(steps_root) == [4, 6]
    m2 = _tiny_model()
    before = m2.network.weight.detach().clone()
    m2.fit(data, epochs=1, batch_size=4, save_dir=save_dir, save_steps=2,
           keep_last=2, verbose=0, shuffle=False, resume=True)
    assert m2._resumed_step == 6
    assert not torch.equal(before, m2.network.weight.detach())
    assert max(ckpt.list_generations(steps_root)) == 8


def test_fit_resume_restores_exact_generation_state(tmp_path):
    data = _data(8, seed=5)
    save_dir = str(tmp_path / "run")
    steps_root = tcb.ModelCheckpoint.steps_root(save_dir)
    m1 = _tiny_model()
    m1.fit(data, epochs=1, batch_size=4, save_dir=save_dir, save_steps=2,
           verbose=0, shuffle=False)
    step, saved = ckpt.load_generation(steps_root, device="cpu")
    m2 = _tiny_model()
    assert m2.resume_from(steps_root) == step
    np.testing.assert_array_equal(_np(m2.network.weight),
                                  _np(saved["user"]["model"]["weight"]))


# ---- the fit cases of tests/test_train_obs.py, on the port ----------------

def test_fit_timeline_chain_valid_with_rollback():
    model = _tiny_model()
    tl = StepTimeline()
    sentry = _sentry(grad_ratio=100.0)
    model.fit(_data(poison={5}), epochs=1, batch_size=1, verbose=0,
              shuffle=False, sentry=sentry, timeline=tl)
    assert sentry.rollbacks == 1
    assert validate_timeline(tl) == []
    assert tl.counters()["rolled_back"] == 1
    assert tl.counters()["steps_completed"] == 9
    for ph in ("data_fetch", "step_dispatch", "device_wait",
               "snapshot_capture", "rollback_restore"):
        assert tl.phase_seconds.get(ph, 0) > 0, ph
    fit_snaps = [s for s in tprofiler.train_stats().values()
                 if s.get("name") == "fit"]
    assert any(s.get("timeline", {}).get("rolled_back") == 1
               and s["sentry"]["rollbacks"] == 1 for s in fit_snaps)
    assert model.train_stats()["sentry"]["rollbacks"] == 1


def test_fit_env_armed_timeline(monkeypatch):
    from paddle_tpu_torch.obs import train as train_mod

    tl = StepTimeline()
    monkeypatch.setattr(train_mod.StepTimeline, "from_env",
                        classmethod(lambda cls: tl))
    model = _tiny_model(optimizer="sgd")
    model.fit(_data(3, seed=0), epochs=1, batch_size=1, verbose=0,
              shuffle=False)
    assert tl.counters()["steps_completed"] == 3
    assert validate_timeline(tl) == []
