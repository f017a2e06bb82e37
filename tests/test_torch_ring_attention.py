"""Ring attention over ``sep`` in the port against the JAX package, on
the CPU.

Spec: ``tests/test_ring_attention.py``.

- ``ring_flash_attention`` (K1-K3's plain versions a tick, through the
  ring's ``autograd.Function``) and ``ring_attention_reference`` (the
  plain ring, ``_ring_inner``'s online softmax differentiated by
  autograd), both on the in-process ring of ``p`` chunks, causal and full,
  at sep 2 and 4: values and the gradients of q, k and v within ``2e-5``
  of the JAX ``ring_flash_attention`` on its ``dp x sep`` mesh and of the
  JAX flash oracle (the spec's tolerance).
- In one gloo world of 8 processes (:mod:`torch_world`): the ring over
  the sep group of ``fleet.init(dp=2, sep=4)``, one chunk a rank, and the
  attention route under it (the same values through ``flash_attention``;
  a mask or dropout refused), held to the JAX ring within ``2e-5``; then
  the tiny GPT at ``dp 2 x sep 2 x mp 2``: each rank's chunk at its global
  positions, the token-weighted loss over sep and the gradients averaged
  over data x sep by the hybrid optimizer, held to the JAX model at sep 1
  (loss ``rtol=2e-5``, gradients ``atol=5e-5``: the spec's).
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from torch_world import get, run_world, scenario, shards, unshard  # noqa: E402,E501

from paddle_tpu_torch.ops.attention import flash_attention  # noqa: E402
from paddle_tpu_torch.ops.ring_attention import (  # noqa: E402
    ring_attention_reference, ring_flash_attention,
)

W = 8
ATOL = 2e-5
CASES = [(causal, p) for causal in (True, False) for p in (2, 4)]


def _qkv(B=2, S=16, H=2, D=8, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _dout(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the JAX side -----------------------------------------------------------

def _jax_ring(causal: bool, p: int) -> dict:
    """The JAX ring on its ``dp x sep`` mesh (``p=None``: its flash
    oracle): values and the gradients of ``sum(out * dout)``."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.ops.pallas import flash_attention as jflash
    from paddle_tpu.ops.ring_attention import ring_flash_attention as jring

    arrs = _qkv()
    dout = _dout(arrs[0].shape)
    saved = jmesh.get_global_mesh()
    try:
        jmesh.set_global_mesh(None if p is None
                              else jmesh.hybrid_mesh(dp=8 // p, sep=p))
        q, k, v = (paddle.to_tensor(a, stop_gradient=False) for a in arrs)
        if p is None:
            o = jflash(q, k, v, is_causal=causal, dropout_p=0.0)
        else:
            o = jring(q, k, v, is_causal=causal)
        (o * paddle.to_tensor(dout)).sum().backward()
        out = {"out": np.asarray(o.numpy()),
               "grads": [np.asarray(t.grad) for t in (q, k, v)]}
    finally:
        jmesh.set_global_mesh(saved)
    return out


@pytest.fixture(scope="module")
def jax_rings():
    oracle = {c: _jax_ring(c, None) for c in (True, False)}
    return {(c, p): {"ring": _jax_ring(c, p), "oracle": oracle[c]}
            for c, p in CASES}


# -- the in-process ring ----------------------------------------------------

def _port(fn, causal: bool, p: int) -> dict:
    arrs = _qkv()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o = fn(q, k, v, causal, chunks=p)
    (o * torch.from_numpy(_dout(arrs[0].shape))).sum().backward()
    return {"out": o.detach().numpy(),
            "grads": [t.grad.numpy() for t in (q, k, v)]}


def _close(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["out"], want["out"], atol=ATOL)
    for g, w, n in zip(got["grads"], want["grads"], "qkv"):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=f"d{n}")


@pytest.mark.parametrize("causal,p", CASES)
def test_ring_values_and_grads_match_jax(jax_rings, causal, p):
    got = _port(ring_flash_attention, causal, p)
    _close(got, jax_rings[(causal, p)]["ring"])
    _close(got, jax_rings[(causal, p)]["oracle"])


@pytest.mark.parametrize("causal,p", CASES)
def test_plain_ring_values_and_grads_match_jax(jax_rings, causal, p):
    got = _port(ring_attention_reference, causal, p)
    _close(got, jax_rings[(causal, p)]["ring"])
    _close(got, jax_rings[(causal, p)]["oracle"])


def test_ring_of_one_chunk_is_flash_attention():
    """``chunks=1``: one tick, the diagonal, is K1's plain version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    np.testing.assert_array_equal(
        ring_flash_attention(q, k, v, True, chunks=1).numpy(),
        flash_attention(q, k, v, is_causal=True).numpy())


def test_ring_refuses_a_split_that_does_not_divide():
    q = torch.zeros(1, 10, 2, 8)
    with pytest.raises(ValueError, match="does not split"):
        ring_flash_attention(q, q, q, chunks=4)
    with pytest.raises(ValueError, match="sep group"):
        ring_flash_attention(q, q, q)          # no fleet sep degree


# -- the gloo world ---------------------------------------------------------

def _worker(rank: int, world: int, workdir: str) -> dict:
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (
        GPTForCausalLM, gpt_tiny, shard_state_dict_from_jax,
    )
    from paddle_tpu_torch.ops.ring_attention import sep_group
    from paddle_tpu_torch.optimizer import SGD

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}

    def init(**degrees):
        s = pdist.DistributedStrategy()
        s.hybrid_configs = degrees
        fleet.init(is_collective=True, strategy=s, device="cpu")
        return fleet.get_hybrid_communicate_group()

    def ring(causal):
        hcg = fleet.get_hybrid_communicate_group()
        arrs = _qkv()
        dout = _dout(arrs[0].shape)
        q, k, v = (fleet.shard_sequence(fleet.shard_batch(
            torch.from_numpy(a))).clone().requires_grad_() for a in arrs)
        do = fleet.shard_sequence(fleet.shard_batch(torch.from_numpy(dout)))
        o = ring_flash_attention(q, k, v, causal)
        routed = flash_attention(q.detach(), k.detach(), v.detach(),
                                 is_causal=causal)
        (o * do).sum().backward()
        return {"out": o.detach().numpy(), "routed": routed.numpy(),
                "grads": [t.grad.numpy() for t in (q, k, v)],
                "sep_rank": hcg.get_sep_parallel_rank(),
                "batch_rank": hcg.get_batch_rank()}

    def refusals():
        q = torch.zeros(1, 4, 2, 8)
        out = []
        for kw in ({"dropout_p": 0.1},
                   {"attn_mask": torch.ones(4, 4, dtype=torch.bool)}):
            try:
                flash_attention(q, q, q, is_causal=True, **kw)
                out.append(None)
            except NotImplementedError as e:
                out.append(str(e))
        return out

    def gpt():
        hcg = fleet.get_hybrid_communicate_group()
        model = GPTForCausalLM(gpt_tiny(), device="cpu")
        model.load_state_dict(shard_state_dict_from_jax(
            model, inputs["gpt"], hcg.get_model_parallel_rank(),
            hcg.get_model_parallel_world_size()))
        wrapped = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(SGD(model.parameters(), lr=0.0))
        x, y = (fleet.shard_sequence(fleet.shard_batch(
            torch.from_numpy(inputs[n]))) for n in ("x", "y"))
        loss = wrapped.compute_loss(x, y)
        loss.backward()
        opt._sync_grads()
        total = loss.detach().clone()
        pdist.all_reduce(total, pdist.ReduceOp.AVG,
                         hcg.get_dp_sep_parallel_group())
        return {"loss": float(loss), "mean": float(total),
                "sep_rank": hcg.get_sep_parallel_rank(),
                "group": sep_group().ranks, **shards(model, fleet)}

    init(dp_degree=2, sep_degree=4)
    for causal in (True, False):
        scenario(res, f"ring/{causal}", ring, causal)
    scenario(res, "refusals", refusals)
    init(dp_degree=2, sep_degree=2, mp_degree=2)
    scenario(res, "gpt", gpt)
    return res


def _jax_gpt(inputs: dict) -> dict:
    import paddle_tpu as paddle
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.models import gpt as jgpt

    saved = jmesh.get_global_mesh()
    jmesh.set_global_mesh(None)
    try:
        paddle.seed(0)
        model = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
        inputs["gpt"] = {k: np.asarray(v.numpy())
                         for k, v in model.state_dict().items()}
        loss = model.compute_loss(paddle.to_tensor(inputs["x"]),
                                  paddle.to_tensor(inputs["y"]))
        loss.backward()
        return {"loss": float(loss),
                "grads": {n: np.asarray(p.grad.numpy())
                          for n, p in model.named_parameters()}}
    finally:
        jmesh.set_global_mesh(saved)


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_rings):
    workdir = str(tmp_path_factory.mktemp("ring_world"))
    rs = np.random.RandomState(0)
    inputs = {"x": rs.randint(0, 128, (2, 16)),
              "y": rs.randint(0, 128, (2, 16))}
    jax_gpt = _jax_gpt(inputs)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    w = run_world("test_torch_ring_attention", "_worker", workdir, W)
    return {"results": w.results(), "gpt": jax_gpt}


def _stitch(parts, key, idx=None):
    """The whole ``[B, S, ...]`` from each rank's ``[b, s, ...]`` chunk,
    placed by its batch and sep ranks."""
    by = {}
    for p in parts:
        by[(p["batch_rank"], p["sep_rank"])] = p[key] if idx is None \
            else p[key][idx]
    nb = 1 + max(b for b, _ in by)
    ns = 1 + max(s for _, s in by)
    return np.concatenate([np.concatenate([by[(b, s)] for s in range(ns)],
                                          axis=1) for b in range(nb)])


@pytest.mark.parametrize("causal", [True, False])
def test_group_ring_over_sep4_matches_jax(world, jax_rings, causal):
    parts = [get(world["results"], f"ring/{causal}", r) for r in range(W)]
    want = jax_rings[(causal, 4)]["ring"]
    np.testing.assert_allclose(_stitch(parts, "out"), want["out"],
                               atol=ATOL)
    np.testing.assert_array_equal(_stitch(parts, "routed"),
                                  _stitch(parts, "out"))
    for i, n in enumerate("qkv"):
        np.testing.assert_allclose(_stitch(parts, "grads", i),
                                   want["grads"][i], atol=ATOL,
                                   err_msg=f"d{n}")


def test_sep_route_refuses_mask_and_dropout(world):
    for r in range(W):
        drop, mask = get(world["results"], "refusals", r)
        assert drop is not None and "dropout_p=0.1" in drop
        assert mask is not None and "mask=True" in mask


def test_gpt_dp2_sep2_mp2_matches_jax_sep1(world):
    """The tiny GPT at dp 2 x sep 2 x mp 2: every rank reports the sep
    group's token-weighted loss of its sample; their mean, and the
    gradients averaged over data x sep and put back together over the
    model ranks, are the JAX model's at sep 1."""
    ref = world["gpt"]
    parts = [get(world["results"], "gpt", r) for r in range(W)]
    for p in parts:
        assert len(p["group"]) == 2
        np.testing.assert_allclose(p["mean"], ref["loss"], rtol=2e-5)
    by_sample = {}
    for p in parts:
        by_sample.setdefault(p["batch_rank"], set()).add(round(p["loss"], 6))
    assert all(len(v) == 1 for v in by_sample.values())   # one per sample
    head = [p for p in parts if p["batch_rank"] == 0 and p["sep_rank"] == 0]
    grads = unshard(head)
    assert set(grads) == set(ref["grads"]) and len(grads) > 10
    for n, g in ref["grads"].items():
        np.testing.assert_allclose(grads[n], g, atol=5e-5, err_msg=n)
