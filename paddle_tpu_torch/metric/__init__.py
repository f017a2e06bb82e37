"""``paddle.metric``: ``Metric``, ``Accuracy`` (top-k), ``Precision``,
``Recall``, ``Auc`` and the functional ``accuracy``.

Port of ``paddle_tpu/metric/__init__.py``.  The accumulators stay on the
host, as the JAX package's do: ``update`` takes tensors (of any device; a
16-bit one is read as float32) or arrays and works in numpy.
``Accuracy.compute`` ranks a tensor's rows on its device and pulls only
the ``[..., maxk]`` hits (the JAX one pulls the scores and sorts them in
numpy).  ``accuracy`` is a torch function on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing on Tensors; default passthrough."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """``[..., maxk]`` bools: is the label the row's 1st, 2nd, ...
        largest?  A tensor is ranked on its device (a stable descending
        sort: the lower index first among equal values) and only the
        bools come to the host; arrays are ranked in numpy."""
        if isinstance(pred, torch.Tensor) and label is not None:
            label = torch.as_tensor(label, device=pred.device)
            if label.dim() == pred.dim() and label.shape[-1] == 1:
                label = label.squeeze(-1)
            topk_idx = torch.sort(pred, dim=-1, descending=True,
                                  stable=True).indices[..., : self.maxk]
            return (topk_idx == label[..., None]).cpu().numpy()
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        return topk_idx == label_np[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        flat = correct.reshape(-1, correct.shape[-1])
        n = flat.shape[0]
        res = []
        for i, k in enumerate(self.topk):
            hits = float(flat[:, :k].any(axis=-1).sum())
            self.total[i] += hits
            self.count[i] += n
            res.append(hits / max(n, 1))
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via threshold bucketing (reference: metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2:
            preds = preds[:, -1]
        else:
            preds = preds.reshape(-1)
        buckets = (preds * self.num_thresholds).astype(np.int64)
        buckets = np.clip(buckets, 0, self.num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            auc += n * (tot_pos + p / 2.0)
            tot_pos += p
            tot_neg += n
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose ``label`` is among the ``k`` largest of
    ``input`` (a float32 scalar tensor; the lower index first among equal
    values, as the JAX package's stable ``argsort``)."""
    topk = torch.sort(-input, dim=-1, stable=True).indices[..., :k]
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    hit = (topk == lbl[..., None]).any(dim=-1)
    return hit.to(torch.float32).mean()
