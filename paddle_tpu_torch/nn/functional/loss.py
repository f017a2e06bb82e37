"""Loss functionals.

Port of ``paddle_tpu/nn/functional/loss.py``, the same formulas in torch
ops.  ``cross_entropy`` keeps Paddle's semantics (:34): the class axis is
``axis`` (default -1), hard labels may carry a trailing 1 on that axis
(``[N, 1]``), ``soft_label``, ``use_softmax=False`` (the input is
probabilities), ``weight`` and ``ignore_index``; its ``"mean"`` divides by
the number of labels not ignored (by their summed weight when there is a
weight), never by the element count.  ``ctc_loss`` takes log-softmax of
``[T, B, C]`` logits and runs torch's CTC (``mean``: each loss over its
label length, then the batch mean, as the JAX package's).  Under
``amp.auto_cast`` the black-listed losses compute in f32, as the JAX
package's do.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from ...amp.auto_cast import amp_op
from ...ops._helpers import wrap_public

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "log_loss", "square_error_cost",
    "sigmoid_focal_loss", "dice_loss", "ctc_loss", "soft_margin_loss",
    "multi_label_soft_margin_loss", "poisson_nll_loss", "gaussian_nll_loss",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


@amp_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    ax = axis % input.dim()
    logp = torch.log_softmax(input, dim=ax) if use_softmax \
        else torch.log(torch.clamp(input, min=1e-30))
    if soft_label:
        loss = -(label * logp).sum(dim=ax)
        if weight is not None:
            shape = [-1 if i == ax else 1 for i in range(input.dim())]
            loss = loss * (label * weight.reshape(shape)).sum(dim=ax)
        return _reduce(loss, reduction)
    lbl = label.long()
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(ax)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        w = weight[safe]
        loss = torch.where(valid, loss * w, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(torch.where(valid, w, zero).sum(),
                                            min=1e-12)
    else:
        loss = torch.where(valid, loss, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.sum().to(loss.dtype),
                                            min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-element loss (hard labels keep a 1 on ``axis``), and the
    softmax with ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if not soft_label:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


@amp_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    w = weight[safe] if weight is not None else torch.ones_like(loss)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(valid, loss * w, zero)
    if reduction == "mean":
        return loss.sum() / torch.clamp(torch.where(valid, w, zero).sum(),
                                        min=1e-12)
    return _reduce(loss, reduction)


@amp_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p = torch.clamp(input, 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, l = logit, label
    if pos_weight is None:
        base = torch.clamp(z, min=0) - z * l + torch.log1p(torch.exp(-z.abs()))
    else:
        base = -(pos_weight * l * TF.logsigmoid(z)
                 + (1 - l) * TF.logsigmoid(-z))
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction="mean", name=None):
    loss = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def _pdist(a, b, p, eps):
    return torch.pow(torch.pow(torch.abs(a - b) + eps, p).sum(-1), 1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _pdist(input, positive, p, epsilon)
    dn = _pdist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _pdist(positive, negative, p, epsilon))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


@amp_op("square_error_cost")
def square_error_cost(input, label):
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, l = logit, label
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * l + torch.log1p(torch.exp(-z.abs()))
    p_t = p * l + (1 - p) * (1 - l)
    a_t = alpha * l + (1 - alpha) * (1 - l)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    oh = TF.one_hot(label.squeeze(-1).long(), input.shape[-1]) \
        .to(input.dtype)
    axes = tuple(range(1, input.dim()))
    inter = (input * oh).sum(dim=axes)
    union = input.sum(dim=axes) + oh.sum(dim=axes)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    loss = -(label * TF.logsigmoid(input)
             + (1 - label) * TF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label + epsilon) - label \
            + 0.5 * torch.log(2 * math.pi * (label + epsilon))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(label - input) / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


@amp_op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of ``[T, B, C]`` logits (log-softmax taken here) against
    ``[B, S]`` labels."""
    lp = torch.log_softmax(log_probs, dim=-1)
    loss = TF.ctc_loss(lp, labels.long(), input_lengths.long(),
                       label_lengths.long(), blank=blank, reduction="none")
    if reduction == "mean":
        return (loss / torch.clamp(label_lengths.to(loss.dtype),
                                   min=1.0)).mean()
    return _reduce(loss, reduction)


wrap_public(globals())
