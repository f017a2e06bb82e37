"""Self-attention over ``[B, S, H, D]`` tensors: the plain versions and the
flash kernel dispatch, forward and backward.

Port of ``_sdpa_reference`` and ``flash_attention`` from
``paddle_tpu/ops/pallas/__init__.py`` and of the ``_flash`` custom_vjp of
``paddle_tpu/ops/pallas/flash_attention_kernel.py``.  On CUDA tensors
:func:`flash_attention` runs the hand-written kernels: K1 forward
(``csrc/flash_attention_fwd.cu``), and K2 (dK, dV) and K3 (dQ) backward
(``csrc/flash_attention_bwd.cu``), tied together by one
``torch.autograd.Function`` as ``_flash`` ties the Pallas kernels.  On CPU
tensors, or with ``kernel="reference"``, the same Function runs the plain
versions: :func:`_flash_fwd_reference` and the whole-sequence rewrites of
``_p_ds`` (:func:`_flash_bwd_dkv_reference`,
:func:`_flash_bwd_dq_reference`).  The kernels and their plain versions
take f32, bf16 and f16, and round where the Pallas kernels round: p to
the input dtype before P V (K1) and before P^T dO (K2), ds before ds^T Q
(K2) and ds K (K3), each product summed in f32.

Without a gradient to take, :func:`flash_attention` calls K1 through the
registered op ``torch.ops.paddle_tpu_torch.flash_fwd`` (:func:`flash_fwd`):
the dispatcher picks its implementation by the tensors' device at run
time, ``kernels.flash_fwd`` on CUDA tensors and the plain
:func:`_flash_fwd_reference` on CPU ones, so a program traced on one
device (``torch.export``, ``jit.save``) holds the op and not the choice,
and runs K1 wherever it is loaded on the card.  Its fake implementation
gives ``torch.export`` the shapes: ``o`` like ``q`` (contiguous) and
``lse`` f32 ``[B*H, S]``.

The kernel path takes causal or full self-attention with no mask.  A call
with ``attn_mask`` takes the JAX package's own route for it, the XLA
oracle (``paddle_tpu/ops/pallas/__init__.py:35-57, 94-109``), in plain
torch ops on every device: :func:`_sdpa_reference` with the mask, its
gradients by autograd.
Attention dropout (``dropout_p > 0`` in training; the JAX package runs it
on its XLA oracle only, ``paddle_tpu/ops/pallas/__init__.py:35-110``) runs
the dropout instances of K1-K3 on the card: each call draws one
``[seed, offset]`` snapshot from the device's generator (:mod:`..rng`),
which the forward saves for its backward, and every kernel and plain
version reads the same Philox keep bits from it.  The plain versions apply
the mask to the materialised probabilities (``P * M / (1-p)``, then
``@ V``), as ``_sdpa_reference`` does; ``lse`` stays that of the
undropped probabilities, and ``delta = rowsum(dO * O)`` still equals
``sum_j P_ij dP_ij``.  A rank holding a slice of the batch or of the heads
draws at its coordinates in the whole tensors
(:func:`..rng.shard_coordinates`): the draw carries ``[batch_start,
head_start, heads_total]`` after ``[seed, offset]``, and the kernels and
plain versions offset their Philox counters by them.
"""
from __future__ import annotations

import torch

from typing import Optional, Tuple

from .. import rng as rng_mod
from ..amp.auto_cast import amp_op
from . import kernels
from ._helpers import public_op
from .cached_attention import NEG_INF

__all__ = ["flash_attention", "flash_fwd", "supports"]

_KERNEL_CHOICES = ("cuda", "reference")


def _dropout_factor(rng: torch.Tensor, B: int, H: int, Sq: int, Sk: int,
                    p: float) -> torch.Tensor:
    """``[B, H, Sq, Sk]`` f32: ``1/(1-p)`` where the draw ``rng`` keeps a
    probability, 0 where it drops it (the kernels' bits)."""
    return rng_mod.attention_dropout_factor(rng, B * H, Sq, Sk, p,
                                            heads=H).view(B, H, Sq, Sk)


def _sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    is_causal: bool, return_lse: bool = False,
                    dropout_p: float = 0.0,
                    rng: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None):
    """Plain attention over ``[B, S, H, D]`` in f32, output in q's dtype.
    The causal mask is ``tril(k=Sk-Sq)`` as in the JAX oracle; ``mask``
    (broadcast to ``[B, H, Sq, Sk]``) then fills ``-1e30`` where a bool
    mask is False, or is added in f32.  With ``return_lse`` also returns
    the ``[B*H, Sq]`` f32 logsumexp rows the flash kernel emits
    (undropped).  ``dropout_p > 0`` multiplies the probabilities by
    :func:`_dropout_factor` of the draw ``rng``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    logits = _logits(q, k, is_causal, mask)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        probs = probs * _dropout_factor(rng, B, H, Sq, Sk, dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(B * H, Sq)
    return out


def _logits(q, k, is_causal: bool, mask: Optional[torch.Tensor] = None):
    """``[B, H, Sq, Sk]`` f32 scores ``q k^T / sqrt(D)``, causal-filled,
    then masked (see :func:`_sdpa_reference`)."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / D ** 0.5)
    if is_causal:
        causal = torch.ones((Sq, Sk), dtype=torch.bool,
                            device=q.device).tril(diagonal=Sk - Sq)
        logits = torch.where(causal, logits, torch.full_like(logits,
                                                             NEG_INF))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, torch.full_like(logits,
                                                               NEG_INF))
        else:
            logits = logits + mask.float()
    return logits


def _flash_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, causal: bool,
                         dropout_p: float = 0.0,
                         rng: Optional[torch.Tensor] = None):
    """K1's plain version: ``(o, lse)`` as :func:`_sdpa_reference` with
    ``return_lse``.  For bf16 and f16 inputs it rounds where the Pallas
    kernel rounds: the probabilities ``p = exp(s - max)`` (times the
    dropout factors) to v's dtype before ``P V``, the product summed in
    f32 and divided by the f32 sum of the unrounded p.  In f32 that
    rounding is the identity and the function is ``_sdpa_reference``."""
    if v.dtype == torch.float32:
        return _sdpa_reference(q, k, v, causal, True, dropout_p, rng)
    B, Sq, H, _ = q.shape
    logits = _logits(q, k, causal)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        p = p * _dropout_factor(rng, B, H, Sq, k.shape[1], dropout_p)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (pv / l.transpose(1, 2)).to(q.dtype)
    return out, (m + torch.log(l)).reshape(B * H, Sq)


def _p_ds(q, k, v, do, lse, delta, causal: bool, z=None):
    """``_p_ds`` over the whole sequence in f32: ``p = exp(s - lse)`` and
    ``ds = p * (dO v^T * z - delta) * scale`` as ``[B, H, S, S]`` (``z``:
    the dropout factors, or None), with the f32 ``[B, H, S, D]`` copies of
    q and dO they were made from."""
    B, S, H, D = q.shape
    scale = 1.0 / D ** 0.5
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    if z is not None:
        dp = dp * z
    ds = p * (dp - delta.reshape(B, H, S, 1)) * scale
    return p, ds, qf, dof


def _bwd_factor(q, dropout_p: float, rng):
    B, S, H, _ = q.shape
    return (_dropout_factor(rng, B, H, S, S, dropout_p) if dropout_p > 0.0
            else None)


def _flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                             dropout_p: float = 0.0, rng=None):
    """K2's plain version: ``(dk, dv)`` ``[B, S, H, D]`` in the input
    dtype.  ``lse`` and ``delta`` are f32 ``[B*H, S]``.  As in the Pallas
    kernel, p is rounded to dO's dtype before ``dV = p^T dO`` and ds to
    q's before ``dK = ds^T q``; the sums are f32.  Under dropout (the
    forward's ``dropout_p`` and draw ``rng``) dV takes ``p * z``."""
    z = _bwd_factor(q, dropout_p, rng)
    p, ds, qf, dof = _p_ds(q, k, v, do, lse, delta, causal, z)
    if z is not None:
        p = p * z
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf)
    return (dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


def _flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = True,
                            dropout_p: float = 0.0, rng=None):
    """K3's plain version: ``dq`` ``[B, S, H, D]`` in the input dtype;
    ds is rounded to k's dtype before ``dQ = ds k``; dropout as K2's."""
    _, ds, _, _ = _p_ds(q, k, v, do, lse, delta, causal,
                        _bwd_factor(q, dropout_p, rng))
    dq = torch.matmul(ds.to(k.dtype).float(), k.float().transpose(1, 2))
    return dq.transpose(1, 2).to(q.dtype).contiguous()


def _use_kernel(t: torch.Tensor, kernel: str) -> bool:
    return t.is_cuda and kernel == "cuda"


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, dropout_p: float = 0.0,
              rng: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as a registered op, ``(o, lse)`` as :func:`kernels.flash_fwd`
    returns them.  This body is the CPU implementation: the plain
    :func:`_flash_fwd_reference`; CUDA tensors launch the kernel
    (:func:`_flash_fwd_cuda`), and any other device has none."""
    o, lse = _flash_fwd_reference(q, k, v, causal, dropout_p, rng)
    return o.contiguous(), lse.contiguous()


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal, dropout_p=0.0, rng=None):
    """The CUDA implementation: K1, and nothing else (a shape or dtype the
    kernel does not take raises)."""
    return kernels.flash_fwd(q, k, v, causal, dropout_p, rng)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, dropout_p=0.0, rng=None):
    B, S, H, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((B * H, S), dtype=torch.float32))


#: a cost analysis's probe (``obs.cost``), or None: told of each K1, K2
#: and K3 call, which it counts by formula
_cost_probe = None


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (``_flash``'s custom_vjp): the forward
    saves ``(q, k, v, o, lse)`` and the dropout draw; the backward forms
    ``delta = rowsum(dO * O)`` in f32 as ``[B*H, S]`` (a torch op, as the
    JAX package forms it outside its kernels) and runs K2 then K3.  The
    three gradients come back as separate contiguous tensors, so a caller
    that split q/k/v off one fused projection pays one concatenation in
    the split's backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kernel: str, dropout_p: float,
                rng: Optional[torch.Tensor]):
        probe = _cost_probe
        if probe is not None:
            probe.begin()
        if _use_kernel(q, kernel):
            o, lse = kernels.flash_fwd(q, k, v, causal, dropout_p, rng)
        else:
            o, lse = _flash_fwd_reference(q, k, v, causal, dropout_p, rng)
        if probe is not None:
            probe.end(("fwd",), q, causal)
        ctx.save_for_backward(q, k, v, o, lse, rng)
        ctx.causal, ctx.kernel, ctx.dropout_p = causal, kernel, dropout_p
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, rng = ctx.saved_tensors
        probe = _cost_probe
        if probe is not None:
            probe.begin()
        B, S, H, _ = q.shape
        if do.stride(-1) != 1:          # never so on the GPT path
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous().view(B * H, S)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.dropout_p, rng)
        if _use_kernel(q, ctx.kernel):
            dk, dv = kernels.flash_bwd_dkv(*args)
            dq = kernels.flash_bwd_dq(*args)
        else:
            dk, dv = _flash_bwd_dkv_reference(*args)
            dq = _flash_bwd_dq_reference(*args)
        if probe is not None:
            probe.end(("bwd_dkv", "bwd_dq"), q, ctx.causal)
        return dq, dk, dv, None, None, None, None


def supports(q_shape, k_shape) -> bool:
    """Shapes the flash kernels take: equal self-attention
    ``[B, S, H, D]`` q and k with a head dim they are instantiated for."""
    return (len(q_shape) == 4 and tuple(k_shape) == tuple(q_shape)
            and q_shape[-1] in kernels.HEAD_DIMS)


def _sep_route(query, key, attn_mask, p: float):
    """The sep group when ``fleet``'s topology has a sep degree above 1
    (the sequence is cut into chunks, one a rank): the ring takes a call
    with no mask, no dropout and ``Sq == Sk``, as in the JAX package
    (``paddle_tpu/ops/pallas/__init__.py:70-83``).  Any other call under a
    sep degree raises (a chunk alone is not the sequence); None without
    one."""
    from .ring_attention import sep_group

    g = sep_group()
    if g is None:
        return None
    if attn_mask is not None or p > 0.0 or query.shape != key.shape:
        raise NotImplementedError(
            "flash_attention under a sep degree > 1 runs the ring, which "
            "takes no attn_mask, no dropout and equal q/k shapes (got "
            f"mask={attn_mask is not None}, dropout_p={p}, q "
            f"{tuple(query.shape)}, k {tuple(key.shape)})")
    return g


@amp_op("flash_attention")
def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, is_causal: bool = False,
                    dropout_p: float = 0.0, kernel: str = "cuda",
                    training: bool = True,
                    generator: Optional[rng_mod.Generator] = None,
                    attn_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Attention over ``[B, S, H, D]`` (kv heads already expanded).

    ``kernel="cuda"`` runs K1 (and K2/K3 in the backward) for CUDA
    tensors; CPU tensors, and ``kernel="reference"``, take the plain
    versions.  A CUDA call with shapes the kernels do not take raises.
    ``dropout_p`` applies when ``training``: one draw from ``generator``
    (default: the query's device's) feeds the dropout instances of the
    kernels (or the plain versions).  When no input requires a gradient,
    or under ``torch.no_grad()``, nothing is saved for a backward, and
    ``kernel="cuda"`` calls the registered op :func:`flash_fwd` (K1 on
    the card, the plain version on the CPU, chosen by the dispatcher).
    ``attn_mask`` (bool: False drops a score; float: added to the scores;
    broadcast to ``[B, H, Sq, Sk]``) takes the JAX package's route for a
    mask, the plain :func:`_sdpa_reference` with autograd, on every
    device, and so may have ``Sk != Sq``; so does ``kernel="reference"``
    with ``Sk != Sq``.  Under :func:`..amp.auto_cast`
    the call is the white-listed op ``"flash_attention"``.  Under a
    ``fleet`` sep degree above 1 the tensors are this rank's sequence
    chunk and the call runs the ring over the sep group
    (:func:`.ring_attention.ring_flash_attention`)."""
    if kernel not in _KERNEL_CHOICES:
        raise ValueError(f"kernel must be one of {_KERNEL_CHOICES}, got "
                         f"{kernel!r}")
    p = float(dropout_p) if training else 0.0
    rng_mod.keep_threshold(p)          # checks 0 <= p <= 1
    rng = None
    if p > 0.0:
        rng = (generator or rng_mod.default_generator(query.device)).draw()
        rng = rng_mod.with_coordinates(rng, query.shape[2])
    sep = _sep_route(query, key, attn_mask, p)
    if sep is not None:
        from .ring_attention import ring_flash_attention

        return ring_flash_attention(query, key, value, is_causal, group=sep,
                                    kernel=kernel)
    if attn_mask is not None or (kernel == "reference"
                                 and key.shape[1] != query.shape[1]):
        return _sdpa_reference(query, key, value, is_causal, False, p, rng,
                               attn_mask)
    if _use_kernel(query, kernel) and not supports(tuple(query.shape),
                                                   tuple(key.shape)):
        raise ValueError(
            f"flash_attention: the CUDA kernels take equal [B, S, H, D] "
            f"q/k with head_dim in {kernels.HEAD_DIMS}, got "
            f"{tuple(query.shape)} / {tuple(key.shape)}")
    if torch.is_grad_enabled() and (query.requires_grad or key.requires_grad
                                    or value.requires_grad):
        return _FlashAttention.apply(query, key, value, is_causal, kernel, p,
                                     rng)
    if kernel == "cuda":
        return flash_fwd(query, key, value, is_causal, p, rng)[0]
    return _flash_fwd_reference(query, key, value, is_causal, p, rng)[0]


flash_attention = public_op("flash_attention", flash_attention)
