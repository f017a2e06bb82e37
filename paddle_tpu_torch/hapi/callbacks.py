"""``Model.fit``'s callbacks: ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler`` and ``VisualDL``.

Port of ``paddle_tpu/hapi/callbacks.py``, host code only.
``ModelCheckpoint(save_steps=)`` commits step generations through
:mod:`..distributed.checkpoint` (resumable by ``fit(resume=True)``);
``VisualDL`` writes the JAX package's TSV lines (``step``, name, value).
"""
from __future__ import annotations

import os
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass

    def on_rollback(self, step, report=None):
        """Divergence-sentry rollback: training state was just restored
        from a memory snapshot and global step ``step`` was blocklisted
        (``fit(sentry=...)``).  ``report`` is the
        triggering ``SentryReport``.  This REPLACES
        ``on_train_batch_end`` for the rolled-back batch: its effects
        were undone, so per-batch-end hooks (LR stepping, counters)
        must not run for it — an ``on_train_batch_begin`` paired with
        ``on_rollback`` is the anomalous-batch signature."""
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def _call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return _call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        # monotonic: samples/s must survive wall-clock steps
        self._t0 = time.perf_counter()
        if self.verbose and self.params.get("verbose", 1):
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, (int, float, np.floating))
                else f"{k}: {v}" for k, v in logs.items())
            ips = ""
            dt = time.perf_counter() - self._t0
            if dt > 0 and "batch_size" in self.params:
                ips = f" - {((step + 1) * self.params['batch_size']) / dt:.1f} samples/s"
            print(f"step {step + 1}/{self.steps or '?'} - {items}{ips}")

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            items = " - ".join(
                f"{k}: {v}" for k, v in logs.items() if k != "batch_size")
            print(f"Eval - {items}")

    def on_rollback(self, step, report=None):
        if self.verbose:
            what = ",".join(report.flags()) if report is not None else "?"
            print(f"step {step + 1}: divergence ({what}) - rolled back "
                  "to last snapshot, window skipped")


class ModelCheckpoint(Callback):
    """Epoch-granular ``model.save`` plus (with ``save_steps``)
    step-granular checkpoint *generations* under ``<save_dir>/steps`` —
    CRC-verified, keep-last-K, auto-resumable via
    ``Model.fit(..., resume=True)``."""

    def __init__(self, save_freq=1, save_dir=None, save_steps=None,
                 keep_last=3):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.save_steps = save_steps
        self.keep_last = keep_last
        self._gstep = 0               # global step across epochs

    @staticmethod
    def steps_root(save_dir):
        return os.path.join(save_dir, "steps")

    def on_train_begin(self, logs=None):
        # fit(resume=True) restored state before training started; pick
        # the generation numbering up where the previous run left off.
        # A FRESH fit into a dir that already holds generations must also
        # continue numbering past them: restarting at 0 would hand every
        # retention keep-slot to the stale higher-numbered generations
        # and delete each new checkpoint the moment it commits.
        start = int(getattr(self.model, "_resumed_step", 0) or 0)
        if self.save_dir and self.save_steps:
            from ..distributed import checkpoint as ckpt

            gens = ckpt.list_generations(self.steps_root(self.save_dir))
            if gens:
                start = max(start, gens[-1])
        self._gstep = start

    def on_train_batch_end(self, step, logs=None):
        if not (self.save_dir and self.save_steps):
            return
        self._gstep += 1
        if self._gstep % self.save_steps == 0:
            from ..distributed import checkpoint as ckpt

            ckpt.save_generation(self.model._ft_state_dict(self._gstep),
                                 self.steps_root(self.save_dir),
                                 self._gstep, keep_last=self.keep_last)

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "min" or (mode == "auto" and "loss" in monitor):
            self.better = lambda cur, best: cur < best - self.min_delta
            self.best = np.inf
        else:
            self.better = lambda cur, best: cur > best + self.min_delta
            self.best = -np.inf
        self.wait = 0
        self.stopped_epoch = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(cur)
        if self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: best {self.monitor}={self.best}")


class LRScheduler(Callback):
    """Steps an optimizer's LRScheduler per-batch or per-epoch."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class VisualDL(Callback):
    """Scalar logger writing TSV (VisualDL protocol replaced by plain files;
    the reference logs to the visualdl service)."""

    def __init__(self, log_dir="vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        logs = logs or {}
        self._step += 1
        with open(os.path.join(self.log_dir, "train.tsv"), "a") as f:
            for k, v in logs.items():
                if isinstance(v, (int, float, np.floating)):
                    f.write(f"{self._step}\t{k}\t{v}\n")
