"""``paddle.Model``: ``prepare``, ``fit``, ``evaluate``, ``predict``,
``save``/``load`` and ``summary`` over a network.

Port of ``paddle_tpu/hapi/model.py``.  The step is eager, as the JAX
package's is: ``train_batch`` runs the network (under ``amp.auto_cast``
for ``amp_configs`` level O1/O2), backward, the divergence sentry's
observe between backward and the update, the optimizer (through a
prepared ``amp.GradScaler``'s ``unscale_``/``step``/``update``), and
pulls the loss to the host once a batch.  Batches come from
:class:`..io.DataLoader` as CPU tensors; every input and label tensor is
moved to the network's device (that of its first parameter or buffer),
so a network on the card trains on the card.

``fit`` passes ``num_workers`` and ``drop_last`` to the loader it makes
(the JAX package's ``fit`` reads neither).  ``fit(timeline=)`` records
each batch attempt's ``data_fetch``/``step_dispatch``/``device_wait``
phases; ``fit(sentry=)`` rolls a diverged batch back to the newest memory
snapshot and skips it; ``save_dir`` with ``save_steps`` commits step
generations that ``fit(resume=True)`` restores.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..metric import Metric, _np
from ..obs.train import NULL_TIMELINE, resolve_timeline
from . import callbacks as cbks_mod
from .summary import _device_of

__all__ = ["Model"]


def _first(x):
    return x[0] if isinstance(x, (list, tuple)) else x


class Model:
    """A network with its optimizer, loss, metrics and AMP level."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self.stop_training = False
        self._amp_level = None
        self._scaler = None
        #: the report train_batch polled from the sentry (its one pull a
        #: batch); fit's rollback policy reads it instead of polling again
        self._last_sentry_report = None
        # fit's surface for profiler.train_stats(): the live timeline and
        # sentry during fit, the sentry's bare counters after it (the
        # sentry itself would pin its snapshot ring)
        self._fit_timeline = None
        self._fit_sentry = None
        self._fit_sentry_counters = None
        self._obs_registered = False
        self._resumed_step = 0

    # -- configuration -----------------------------------------------------

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """``amp_configs``: a level (``"O1"``/``"O2"``) or a dict with
        ``level`` (default O1) and ``scaler`` (an ``amp.GradScaler``); the
        low dtype is ``amp.auto_cast``'s default, bfloat16."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
            self._scaler = amp_configs.get("scaler", self._scaler)
        return self

    # -- single batches ----------------------------------------------------

    def _to_device(self, x):
        """Tensors, arrays and nested lists of them on the network's
        device (that of its first parameter or buffer; numbers and other
        objects as they are)."""
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return [self._to_device(v) for v in x]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            return x.to(_device_of(self.network))
        return x

    def _inputs_of(self, inputs):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self._to_device(list(ins))

    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = labels if isinstance(labels, (list, tuple)) else [labels]
        if callable(self._loss):
            return self._loss(*outs, *lbls)
        raise ValueError("Model.prepare(loss=...) required for training")

    def _params(self):
        return [p for g in self._optimizer.param_groups
                for p in g["params"]]

    def _update_metrics(self, outputs, labels):
        for m in self._metrics:
            pre = m.compute(_first(outputs), _first(labels))
            if isinstance(pre, tuple):
                m.update(*pre)
            else:
                m.update(pre)

    def train_batch(self, inputs, labels=None, update=True, sentry=None,
                    timeline=None):
        """One training batch; returns ``[loss]`` (a float)."""
        timeline = timeline if timeline is not None else NULL_TIMELINE
        self.network.train()
        ins = self._inputs_of(inputs)
        labels = self._to_device(labels)
        scaler = self._scaler if (self._scaler is not None
                                  and self._scaler.is_enable()) else None

        def _observe(loss, grads_ready, found_inf=None):
            # between backward and the update: the raw global grad norm,
            # and a scaler's overflow skip read as routine
            if sentry is None:
                return
            grad_norm = None
            if grads_ready and self._optimizer is not None:
                from ..distributed.fault_tolerance import global_grad_norm

                grad_norm = global_grad_norm(self._params())
            sentry.observe(loss, grad_norm=grad_norm, found_inf=found_inf,
                           scale=None if scaler is None
                           else scaler.scale_tensor)

        # step_dispatch: building and enqueueing the step, up to the first
        # host pull; device_wait below times the pulls
        with timeline.phase("step_dispatch"):
            amp_on = self._amp_level in ("O1", "O2")
            if amp_on:
                from .. import amp as amp_mod

                with amp_mod.auto_cast(level=self._amp_level):
                    outputs = self.network(*ins)
            else:
                outputs = self.network(*ins)
            loss = self._compute_loss(outputs, labels)
            if amp_on and scaler is not None:
                scaler.scale(loss).backward()
                if update:
                    scaler.unscale_(self._optimizer)
                    _observe(loss, grads_ready=True,
                             found_inf=scaler.found_inf)
                    scaler.step(self._optimizer)
                    scaler.update()
                    self._optimizer.clear_grad()
                else:
                    _observe(loss, grads_ready=False)
            else:
                loss.backward()
                _observe(loss, grads_ready=update)
                if update:
                    self._optimizer.step()
                    self._optimizer.clear_grad()
        self._last_sentry_report = None
        if sentry is not None:
            # polled here (still the batch's one pull: fit reads
            # _last_sentry_report) so that an anomalous batch never
            # reaches the metric accumulators
            with timeline.phase("device_wait"):
                self._last_sentry_report = sentry.poll()
            if self._last_sentry_report.anomalous:
                return [self._last_sentry_report.loss]
        with timeline.phase("device_wait"):
            metrics = [float(loss.detach())]
        self._update_metrics(outputs, labels)
        return metrics

    def eval_batch(self, inputs, labels=None):
        """One evaluation batch under ``no_grad``; returns ``[loss]``
        when a loss and labels are given, else ``[]``."""
        self.network.eval()
        ins = self._inputs_of(inputs)
        labels = self._to_device(labels)
        with torch.no_grad():
            outputs = self.network(*ins)
            loss_val = None
            if self._loss is not None and labels is not None:
                loss_val = float(self._compute_loss(outputs, labels))
        self._update_metrics(outputs, labels)
        return [loss_val] if loss_val is not None else []

    def predict_batch(self, inputs):
        """One inference batch: a list of numpy arrays, one per network
        output (a list even for one output; 16-bit outputs as float32)."""
        self.network.eval()
        ins = self._inputs_of(inputs)
        with torch.no_grad():
            out = self.network(*ins)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [_np(o) for o in outs]

    # -- loops -------------------------------------------------------------

    @staticmethod
    def _unpack(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return batch[0], batch[1]
            return batch[0], None
        return batch, None

    def _make_loader(self, data, batch_size, shuffle, num_workers=0,
                     drop_last=False):
        from ..io import DataLoader

        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, save_steps=None,
            keep_last=3, resume=False, sentry=None, timeline=None):
        """Train the prepared model.

        ``timeline`` (an ``obs.StepTimeline``, else the one
        ``PADDLE_TPU_TRAIN_TRACE=1`` arms) records one span per batch
        attempt, with ``data_fetch``/``step_dispatch``/``device_wait``/
        ``snapshot_capture`` phases; a rolled-back batch ends
        ``rolled_back``, linked to the attempt that follows.  ``sentry`` (a
        ``distributed.fault_tolerance.DivergenceSentry`` on the network's
        device) checks each batch (one small host pull); on an anomaly the
        newest memory snapshot (weights, optimizer, generators, scaler) is
        restored and training goes on with the next batch, the bad one
        skipped, not replayed; after ``max_rollbacks`` consecutive
        rollbacks ``SentryEscalation`` stops the fit with the flight
        recorder's dump, any ``save_dir`` checkpoints intact."""
        train_loader = self._make_loader(train_data, batch_size, shuffle,
                                         num_workers, drop_last)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        self._resumed_step = 0
        if save_dir and resume:
            self._resumed_step = self.resume_from(
                cbks_mod.ModelCheckpoint.steps_root(save_dir))
        cbs = [cbks_mod.ProgBarLogger(log_freq, verbose=verbose)]
        if save_dir:
            cbs.append(cbks_mod.ModelCheckpoint(save_freq, save_dir,
                                                save_steps=save_steps,
                                                keep_last=keep_last))
        if callbacks:
            cbs.extend(callbacks)
        cbk_list = cbks_mod.CallbackList(cbs)
        cbk_list.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbk_list.set_params({
            "epochs": epochs, "steps": steps, "verbose": verbose,
            "batch_size": batch_size, "metrics": self._metrics_name(),
        })
        tl = resolve_timeline(timeline)
        # an armed fit joins profiler.train_stats() (once per Model; the
        # snapshot reads what the last armed fit set)
        if tl.enabled or sentry is not None:
            self._fit_timeline = tl if tl.enabled else None
            self._fit_sentry = sentry
            if not self._obs_registered:
                from .. import profiler as _profiler

                _profiler._register_train_stats(self)
                self._obs_registered = True
        flight = None
        gstep = int(self._resumed_step or 0)
        if sentry is not None:
            from ..obs.flight import FlightRecorder

            flight = FlightRecorder(name="training")
            # a rollback target before the first batch
            self._sentry_snapshot(sentry, gstep, timeline=tl)
        self.stop_training = False
        cbk_list.on_train_begin()
        try:
            self._fit_epochs(epochs, train_loader, eval_loader, cbk_list,
                             sentry, tl, flight, gstep, batch_size,
                             eval_freq, accumulate_grad_batches, num_iters)
        finally:
            if sentry is not None and self._fit_sentry is sentry:
                self._fit_sentry = None
                self._fit_sentry_counters = dict(sentry.counters())
        cbk_list.on_train_end()
        return self

    def _fit_epochs(self, epochs, train_loader, eval_loader, cbk_list,
                    sentry, tl, flight, gstep, batch_size, eval_freq,
                    accumulate_grad_batches, num_iters):
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbk_list.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            step_count = 0
            batches = enumerate(train_loader)
            while True:
                tl.begin_step(gstep)
                with tl.phase("data_fetch"):
                    try:
                        step, batch = next(batches)
                    except StopIteration:
                        tl.abandon_step()      # nothing ran this attempt
                        break
                if sentry is not None and sentry.should_skip(gstep):
                    # the skipped boundary still passes the flight ring
                    # and the snapshot cadence
                    sentry.note_skip(gstep)
                    tl.on_skip(gstep)
                    flight.record(step=gstep, skipped=1)
                    gstep += 1
                    if gstep % sentry.snapshot_every == 0:
                        self._sentry_snapshot(sentry, gstep, timeline=tl)
                    tl.end_step("skipped")
                    step_count += 1
                    if num_iters is not None and step_count >= num_iters:
                        break
                    continue
                cbk_list.on_train_batch_begin(step)
                x, y = self._unpack(batch)
                update = (step + 1) % accumulate_grad_batches == 0
                outs = self.train_batch(x, y, update=update, sentry=sentry,
                                        timeline=tl)
                if sentry is not None:
                    report = self._last_sentry_report
                    flight.record(step=gstep, anomaly=report.code,
                                  loss=report.loss,
                                  grad_norm=report.grad_norm,
                                  scale=report.scale)
                    if report.anomalous:
                        self._sentry_rollback(sentry, gstep, report,
                                              cbk_list, flight, timeline=tl)
                        gstep += 1
                        step_count += 1
                        if num_iters is not None \
                                and step_count >= num_iters:
                            break
                        continue
                    sentry.note_clean(gstep)
                logs = {"loss": outs[0]}
                for m in self._metrics:
                    logs[_name_str(m.name())] = _fmt_metric(m.accumulate())
                cbk_list.on_train_batch_end(step, logs)
                gstep += 1
                if sentry is not None \
                        and gstep % sentry.snapshot_every == 0:
                    self._sentry_snapshot(sentry, gstep, timeline=tl)
                tl.end_step("completed")
                step_count += 1
                if num_iters is not None and step_count >= num_iters:
                    break
            cbk_list.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=0, _callbacks=cbk_list)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _callbacks=None):
        """Loss (the mean of the batches') and metrics over ``eval_data``."""
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbk_list = _callbacks or cbks_mod.CallbackList(
            [cbks_mod.ProgBarLogger(log_freq, verbose=verbose)])
        if _callbacks is None:
            cbk_list.set_model(self)
            cbk_list.set_params({"verbose": verbose})
        for m in self._metrics:
            m.reset()
        cbk_list.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbk_list.on_eval_batch_begin(step)
            x, y = self._unpack(batch)
            outs = self.eval_batch(x, y)
            if outs:
                losses.append(outs[0])
            cbk_list.on_eval_batch_end(step)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[_name_str(m.name())] = _fmt_metric(m.accumulate())
        cbk_list.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """A list with one entry per network output: the list of the
        batches' arrays, or one ``vstack`` of them with
        ``stack_outputs``."""
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            x, _ = self._unpack(batch)
            outputs.append(self.predict_batch(x))
        outputs = [list(outs) for outs in zip(*outputs)]   # [output][batch]
        if stack_outputs:
            outputs = [np.vstack(outs) for outs in outputs]
        return outputs

    # -- fault tolerance ---------------------------------------------------

    def _ft_user_state(self):
        state = {"model": self.network.state_dict()}
        if self._optimizer is not None:
            state["opt"] = self._optimizer.state_dict()
        return state

    def _ft_restore(self, user_state):
        self.network.set_state_dict(user_state["model"])
        if self._optimizer is not None and "opt" in user_state:
            self._optimizer.set_state_dict(user_state["opt"])

    def _ft_state_dict(self, step):
        """A generation's payload in ``ResilientLoop``'s schema (the
        scaler's state too, when one is prepared)."""
        from ..distributed.fault_tolerance import pack_state

        return pack_state(self._ft_user_state(), step, scaler=self._scaler)

    def resume_from(self, ckpt_root):
        """Restore weights, optimizer, generators (and a prepared
        scaler) from the newest valid step generation under
        ``ckpt_root``; returns its step (0: nothing to resume).  The data
        iterator is not fast-forwarded (``ResilientLoop`` replays
        step-exactly)."""
        from ..distributed.fault_tolerance import ResilientLoop

        loop = ResilientLoop(ckpt_root, state_fn=self._ft_user_state,
                             restore_fn=self._ft_restore, verbose=False,
                             scaler=self._scaler)
        return loop.resume()

    def train_stats(self) -> dict:
        """The snapshot an armed ``fit`` gives ``profiler.train_stats()``."""
        out = {"name": "fit"}
        if self._fit_timeline is not None:
            out["timeline"] = self._fit_timeline.counters()
        if self._fit_sentry is not None:
            out["sentry"] = self._fit_sentry.counters()
        elif self._fit_sentry_counters is not None:
            out["sentry"] = self._fit_sentry_counters
        return out

    def _sentry_snapshot(self, sentry, gstep, timeline=None):
        with (timeline or NULL_TIMELINE).phase("snapshot_capture"):
            state = self._ft_state_dict(gstep)
            state["@sentry"] = sentry.state_dict()
            sentry.ring.take(state)

    def _sentry_rollback(self, sentry, gstep, report, cbk_list, flight,
                         timeline=None):
        """Restore the newest snapshot and go on with the next batch;
        escalate after ``max_rollbacks`` consecutive rollbacks, the model
        left at the newest good snapshot."""
        from ..distributed.fault_tolerance import (
            SentryEscalation, restore_packed_state)

        tl = timeline or NULL_TIMELINE
        action = sentry.note_anomaly(gstep, report)
        if action == "escalate":
            snap = sentry.ring.newest()
            if snap is not None:
                with tl.phase("rollback_restore"):
                    restore_packed_state(snap, self._ft_restore,
                                         scaler=self._scaler, sentry=sentry)
            dump = flight.dump("sentry_escalation")
            tl.on_escalate(gstep)
            raise SentryEscalation(
                f"divergence sentry escalated at fit step {gstep} "
                f"(anomaly {report.flags() or report.code}; "
                f"{sentry.max_rollbacks} consecutive rollbacks exhausted)",
                step=gstep, report=report, flight_dump=dump)
        snap = sentry.ring.newest()
        with tl.phase("rollback_restore"):
            restore_packed_state(snap, self._ft_restore,
                                 scaler=self._scaler, sentry=sentry)
        if self._optimizer is not None:
            # the bad batch's gradients (a non-update micro-batch's too)
            # are not in the snapshot
            self._optimizer.clear_grad()
        sentry.rollbacks += 1
        tl.on_rollback(gstep, code=report.code)
        # on_rollback takes the place of on_train_batch_end for this batch
        cbk_list.on_rollback(gstep, report)

    # -- persistence -------------------------------------------------------

    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save as _save

        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as _load

        self.network.set_state_dict(_load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary

        return _summary(self.network, input_size, dtypes=dtype)

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, (list, tuple)) else [n])
        return names


def _name_str(n):
    return n if isinstance(n, str) else n[0]


def _fmt_metric(v):
    if isinstance(v, (list, tuple)):
        return float(v[0])
    return float(v)
