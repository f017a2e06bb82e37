"""The rest of ``nn.functional``: ``affine_grid``/``grid_sample``,
``bilinear``, ``diag_embed``, ``gather_tree``, ``hsigmoid_loss``,
``margin_cross_entropy``, ``sparse_attention``, ``tanh_``.

Port of ``paddle_tpu/nn/functional/extras.py``, the same formulas in
torch ops.  ``grid_sample`` gathers its four corners as the JAX package
does (zeros padding: an out-of-range corner weighs 0; border: corners
clamped), so its gradients are the JAX package's too; ``sparse_attention``
densifies the CSR pattern into a mask and runs a masked softmax, as the
JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch
from ...ops._helpers import wrap_public

__all__ = [
    "affine_grid", "bilinear", "diag_embed", "gather_tree", "grid_sample",
    "hsigmoid_loss", "margin_cross_entropy", "sparse_attention", "tanh_",
]


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(input, offset, dim1, dim2)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, k] = x1[b]^T W[k] x2[b] + bias``; ``W`` ``[out, in1, in2]``."""
    out = torch.einsum("bi,kij,bj->bk", x1, weight, x2)
    return out if bias is None else out + bias


def gather_tree(ids, parents, name=None):
    """Beam-search ancestry: ``[T, B, beam]`` ids and parents to the full
    sequence of each final beam, walked back from the last step."""
    beam = torch.arange(ids.shape[2], device=ids.device) \
        .expand(ids.shape[1:]).long()
    out = torch.empty_like(ids)
    for t in reversed(range(ids.shape[0])):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].long().gather(1, beam)
    return out


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[N, H, W, 2]`` sampling grid ``theta @ (x, y, 1)``."""
    n, c, h, w = (int(s) for s in out_shape)

    def coords(m):
        if align_corners:
            return torch.linspace(-1.0, 1.0, m, device=theta.device)
        return (torch.arange(m, device=theta.device) * 2 + 1) / m - 1.0

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1) \
        .to(theta.dtype)
    return torch.einsum("hwk,njk->nhwj", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at normalised ``grid`` ``[N, Hg, Wg, 2]`` (x, y)
    locations; ``bilinear`` or ``nearest`` (half to even), ``zeros`` or
    ``border`` padding."""
    n, c, h, w = x.shape

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1.0) * 0.5 * (size - 1)
        return ((coord + 1.0) * size - 1.0) * 0.5

    gx = unnormalize(grid[..., 0].float(), w)
    gy = unnormalize(grid[..., 1].float(), h)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def fetch(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "border":
            return v
        return v * inb[..., None]

    if mode == "nearest":
        out = fetch(torch.round(gx).long(), torch.round(gy).long())
    else:
        x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
        wx, wy = gx - x0, gy - y0
        out = (fetch(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
               + fetch(x0 + 1, y0) * (wx * (1 - wy))[..., None]
               + fetch(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
               + fetch(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2).to(x.dtype)


def _sigmoid_ce(logit, code):
    return torch.clamp(logit, min=0) - logit * code \
        + torch.log1p(torch.exp(-logit.abs()))


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: ``[N, 1]`` losses over the default complete
    binary tree (the heap walk of ``label + num_classes``), or a custom
    tree's ``path_table`` (node ids, negative = padding) and
    ``path_code`` (branch bits)."""
    if (path_table is None) != (path_code is None):
        raise ValueError("path_table and path_code must be given together")
    xf = input.float()
    if path_table is not None:
        valid = path_table >= 0
        nid = path_table.long().clamp(0, weight.shape[0] - 1)
        logits = torch.einsum("nd,nld->nl", xf, weight[nid].float())
        if bias is not None:
            logits = logits + bias.reshape(-1)[nid]
        lo = _sigmoid_ce(logits, path_code.float())
        return torch.where(valid, lo, torch.zeros_like(lo)) \
            .sum(dim=1, keepdim=True)
    code_len = int(np.ceil(np.log2(max(num_classes, 2))))
    node = label.reshape(-1).long() + num_classes
    losses = torch.zeros(node.shape[0], device=input.device)
    for _ in range(code_len):
        parent = node // 2
        code = (node % 2).float()
        nid = (parent - 1).clamp(0, weight.shape[0] - 1)
        logit = (xf * weight[nid].float()).sum(-1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[nid]
        lo = _sigmoid_ce(logit, code)
        losses = losses + torch.where(parent >= 1, lo, torch.zeros_like(lo))
        node = parent
    return losses[:, None]


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-family margin softmax: the target logit ``cos(m1 theta +
    m2) - m3``, all scaled by ``scale``."""
    lg = logits.float()
    onehot = torch.nn.functional.one_hot(label.reshape(-1).long(),
                                         lg.shape[-1]).float()
    cos = lg.clamp(-1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    adjusted = torch.where(onehot > 0, target, cos) * scale
    loss = -(onehot * torch.log_softmax(adjusted, dim=-1)).sum(
        -1, keepdim=True)
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.softmax(adjusted, dim=-1)
    return loss


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of ``[B, H, S, D]`` tensors over the (b, h) CSR pattern
    (``offset`` ``[B, H, S + 1]``, ``columns`` ``[B, H, nnz]``), as a
    dense masked softmax."""
    b, h, s, d = query.shape
    offs = sparse_csr_offset.reshape(b, h, -1).long()
    cols = sparse_csr_columns.reshape(b, h, -1).long()
    counts = (offs[..., 1:] - offs[..., :-1]).reshape(-1, s)
    rows = torch.stack([torch.repeat_interleave(
        torch.arange(s, device=query.device), c, output_size=cols.shape[-1])
        for c in counts]).reshape(b, h, -1)
    mask = torch.zeros((b, h, s, s), dtype=torch.bool, device=query.device)
    bi = torch.arange(b, device=query.device)[:, None, None]
    hi = torch.arange(h, device=query.device)[None, :, None]
    mask[bi, hi, rows, cols] = True
    scores = torch.einsum("bhsd,bhtd->bhst", query, key) / np.sqrt(d)
    scores = torch.where(mask, scores.float(),
                         torch.full_like(scores.float(), -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(value.dtype), value) \
        .to(query.dtype)


def tanh_(x, name=None):
    return x.tanh_()


wrap_public(globals())
