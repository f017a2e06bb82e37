"""The port's ``metric`` against the JAX package's, on the CPU.

Spec: ``tests/test_hapi_e2e.py::TestMetrics``, run on both packages, and
the same updates through both packages' metrics compared exactly (both
accumulate in numpy on the host).  ``accuracy`` (functional) is compared
on inputs with tied scores: both take the lower index first.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu_torch import metric as tmetric

PACKAGES = [("jax", jmetric, paddle.to_tensor),
            ("torch", tmetric, lambda a: torch.from_numpy(np.asarray(a)))]
IDS = [p[0] for p in PACKAGES]


@pytest.mark.parametrize("name,metric,wrap", PACKAGES, ids=IDS)
def test_accuracy_topk(name, metric, wrap):
    m = metric.Accuracy(topk=(1, 2))
    pred = wrap(np.array([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]], np.float32))
    label = wrap(np.array([[1], [2]]))
    m.update(m.compute(pred, label))
    top1, top2 = m.accumulate()
    assert top1 == 0.5 and top2 == 0.5 or (top1 == 0.5 and top2 == 1.0)
    assert m.name() == ["acc_top1", "acc_top2"]


@pytest.mark.parametrize("name,metric,wrap", PACKAGES, ids=IDS)
def test_precision_recall(name, metric, wrap):
    p, r = metric.Precision(), metric.Recall()
    preds = np.array([0.9, 0.8, 0.2, 0.7])
    labels = np.array([1, 0, 1, 1])
    p.update(preds, labels)
    r.update(preds, labels)
    assert abs(p.accumulate() - 2 / 3) < 1e-6
    assert abs(r.accumulate() - 2 / 3) < 1e-6


@pytest.mark.parametrize("name,metric,wrap", PACKAGES, ids=IDS)
def test_auc_perfect(name, metric, wrap):
    a = metric.Auc()
    a.update(np.array([[0.9, 0.1], [0.8, 0.2], [0.2, 0.8], [0.3, 0.7]]),
             np.array([0, 0, 1, 1]))
    assert a.accumulate() == 1.0


def test_every_metric_matches_jax_over_batches():
    rs = np.random.RandomState(0)
    pairs = {
        "acc": (tmetric.Accuracy(topk=(1, 3)), jmetric.Accuracy(topk=(1, 3))),
        "precision": (tmetric.Precision(), jmetric.Precision()),
        "recall": (tmetric.Recall(), jmetric.Recall()),
        "auc": (tmetric.Auc(num_thresholds=255),
                jmetric.Auc(num_thresholds=255)),
    }
    for _ in range(4):
        logits = np.asarray(rs.randn(16, 5), np.float32)
        labels = rs.randint(0, 5, (16, 1))
        probs = np.asarray(rs.rand(16), np.float32)
        bins = rs.randint(0, 2, 16)
        t, j = pairs["acc"]
        assert t.update(t.compute(torch.from_numpy(logits),
                                  torch.from_numpy(labels))) == \
            j.update(j.compute(paddle.to_tensor(logits),
                               paddle.to_tensor(labels)))
        for key in ("precision", "recall", "auc"):
            t, j = pairs[key]
            t.update(torch.from_numpy(probs), torch.from_numpy(bins))
            j.update(paddle.to_tensor(probs), paddle.to_tensor(bins))
    for key, (t, j) in pairs.items():
        assert t.accumulate() == j.accumulate(), key
        assert t.name() == j.name()
        t.reset()
        j.reset()
        assert t.accumulate() == j.accumulate()


def test_metric_reads_16_bit_and_card_style_tensors():
    m = tmetric.Accuracy()
    pred = torch.tensor([[0.1, 0.9], [0.7, 0.3]], dtype=torch.bfloat16)
    m.update(m.compute(pred, torch.tensor([1, 1])))
    assert m.accumulate() == 0.5


@pytest.mark.parametrize("k", [1, 2, 3])
def test_functional_accuracy_matches_jax_with_ties(k):
    pred = np.array([[0.5, 0.5, 0.1, 0.5], [0.2, 0.2, 0.2, 0.2],
                     [0.1, 0.4, 0.4, 0.0], [0.3, 0.0, 0.9, 0.9]], np.float32)
    label = np.array([[1], [3], [2], [3]])
    t = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
    j = jmetric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(label), k=k)
    assert t.dtype == torch.float32 and t.dim() == 0
    assert float(t) == float(np.asarray(j.numpy()))


def test_metric_base_surface():
    class Mean(tmetric.Metric):
        def __init__(self):
            self.reset()

        def reset(self):
            self.v = []

        def update(self, x):
            self.v.append(float(x))

        def accumulate(self):
            return float(np.mean(self.v))

        def name(self):
            return "mean"

    m = Mean()
    assert m.compute(1, 2) == (1, 2)
    m.update(2.0)
    m.update(4.0)
    assert m.accumulate() == 3.0
    with pytest.raises(NotImplementedError):
        tmetric.Metric().accumulate()
