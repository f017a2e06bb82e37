"""The KL divergence registry and its dispatch (port of
``paddle_tpu/distribution/kl.py``): ``register_kl(P, Q)`` registers a
function computing ``KL(p || q)``; :func:`kl_divergence` picks the most
specific registered ``(P, Q)`` pair by total MRO distance, as the
reference resolves it."""
from __future__ import annotations

import warnings

import torch

from .beta import Beta
from .categorical import Categorical
from .dirichlet import Dirichlet
from .distribution import betaln
from .exponential_family import ExponentialFamily, _grad_of_normalizer
from .normal import Normal
from .uniform import Uniform

__all__ = ["kl_divergence", "register_kl"]

_REGISTER_TABLE = {}


def kl_divergence(p, q):
    return _dispatch(type(p), type(q))(p, q)


def register_kl(cls_p, cls_q):
    def decorator(f):
        _REGISTER_TABLE[cls_p, cls_q] = f
        return f

    return decorator


def _dispatch(cls_p, cls_q):
    matches = [(sp, sq) for sp, sq in _REGISTER_TABLE
               if issubclass(cls_p, sp) and issubclass(cls_q, sq)]
    if not matches:
        raise NotImplementedError(
            f"no KL registered for ({cls_p.__name__}, {cls_q.__name__})")
    matches.sort(key=lambda m: cls_p.__mro__.index(m[0])
                 + cls_q.__mro__.index(m[1]))
    left = min(matches, key=lambda m: cls_p.__mro__.index(m[0]))
    right = min(matches, key=lambda m: cls_q.__mro__.index(m[1]))
    if _REGISTER_TABLE[left] is not _REGISTER_TABLE[right]:
        warnings.warn(
            f"ambiguous KL for ({cls_p.__name__}, {cls_q.__name__})")
    return _REGISTER_TABLE[left]


@register_kl(Beta, Beta)
def _kl_beta_beta(p, q):
    a0, b0, a1, b1 = p.alpha, p.beta, q.alpha, q.beta
    s0 = a0 + b0
    return ((a0 - a1) * torch.digamma(a0) + (b0 - b1) * torch.digamma(b0)
            + (a1 - a0 + b1 - b0) * torch.digamma(s0)
            + betaln(a1, b1) - betaln(a0, b0))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet_dirichlet(p, q):
    c0, c1 = p.concentration, q.concentration
    s0 = c0.sum(dim=-1)
    t1 = torch.lgamma(s0) - torch.lgamma(c0).sum(dim=-1)
    t2 = torch.lgamma(c1).sum(dim=-1) - torch.lgamma(c1.sum(dim=-1))
    t3 = ((c0 - c1) * (torch.digamma(c0)
                       - torch.digamma(s0)[..., None])).sum(dim=-1)
    return t1 + t2 + t3


@register_kl(Categorical, Categorical)
def _kl_categorical_categorical(p, q):
    return p.kl_divergence(q)


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    return p.kl_divergence(q)


@register_kl(Uniform, Uniform)
def _kl_uniform_uniform(p, q):
    return p.kl_divergence(q)


@register_kl(ExponentialFamily, ExponentialFamily)
def _kl_expfamily_expfamily(p, q):
    """The Bregman divergence of two members of one family:
    ``F(θq) - F(θp) - <θq - θp, ∇F(θp)>`` (reference ``kl.py:171``)."""
    if type(p) is not type(q):
        raise NotImplementedError(
            "Bregman KL needs both distributions from the same family")
    given = list(p._natural_parameters)
    tq = list(q._natural_parameters)
    tp, grads = _grad_of_normalizer(p, given)
    with torch.enable_grad():
        kl = q._log_normalizer(*tq) - p._log_normalizer(*tp)
        for a, b, g in zip(tp, tq, grads):
            term = (a - b) * g
            if term.shape != kl.shape:
                term = term.sum(dim=-1)
            kl = kl + term
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in given + tq):
        return kl
    return kl.detach()
