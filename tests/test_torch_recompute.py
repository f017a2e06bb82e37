"""Activation recompute and the one-card ``fleet`` on the CPU.

``test_recompute_matches_no_recompute`` (``tests/test_models_gpt.py:50``)
runs in both packages, and the port's recompute run is held to the JAX
one on the same weights (loss 1e-5 relative, every gradient 1e-5
absolute).  With dropout on, recompute on and off give bitwise equal
losses and gradients in the port (a region draws its offsets outside the
checkpoint), and a recompute forward keeps fewer activations for the
backward.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.models.gpt import GPTPretrainingCriterion
from paddle_tpu_torch import rng
from paddle_tpu_torch.distributed import DistributedStrategy, fleet
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 128, (2, 16)), rs.randint(0, 128, (2, 16))


def _jax_run(recompute: bool):
    paddle.seed(0)
    m = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny(recompute=recompute))
    state = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    x, y = _batch()
    loss = GPTPretrainingCriterion()(m(paddle.to_tensor(x)),
                                     paddle.to_tensor(y))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in m.named_parameters()}
    return state, float(loss), grads


def _port_run(state, recompute: bool, **cfg):
    m = GPTForCausalLM(gpt_tiny(recompute=recompute, **cfg), device="cpu")
    from_jax_state_dict(m, state)
    x, y = (torch.from_numpy(a) for a in _batch())
    loss = m.compute_loss(x, y)
    loss.backward()
    return m, loss


def test_recompute_matches_no_recompute():
    state, l1, g1 = _jax_run(recompute=True)
    _, l2, g2 = _jax_run(recompute=False)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    first = next(iter(g1))
    np.testing.assert_allclose(g1[first], g2[first], atol=1e-5)
    m1, p1 = _port_run(state, recompute=True)
    m2, p2 = _port_run(state, recompute=False)
    np.testing.assert_allclose(p1.item(), p2.item(), rtol=1e-5)
    np.testing.assert_allclose(p1.item(), l1, rtol=1e-5)
    linear = {f"{n}.weight" for n, mod in m1.named_modules()
              if isinstance(mod, torch.nn.Linear)}
    for (name, a), (_, b) in zip(m1.named_parameters(),
                                 m2.named_parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)
        got = a.grad.numpy().T if name in linear else a.grad.numpy()
        np.testing.assert_allclose(got, g1[name], atol=1e-5, err_msg=name)


def _dropout_run(recompute: bool):
    rng.seed(3)
    cfg = gpt_tiny(recompute=recompute, hidden_dropout_prob=0.1,
                   attention_probs_dropout_prob=0.1)
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    opt = AdamW(m.parameters(), lr=1e-3)
    x, y = (torch.from_numpy(a) for a in _batch())
    losses = []
    for _ in range(3):
        loss = m.compute_loss(x, y)
        loss.backward()
        grads = [p.grad.clone() for p in m.parameters()]
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    return losses, grads, rng.default_generator("cpu").get_state()


def test_recompute_with_dropout_is_bitwise():
    (l_off, g_off, s_off), (l_on, g_on, s_on) = (_dropout_run(False),
                                                 _dropout_run(True))
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    assert all(torch.equal(a, b) for a, b in zip(g_off, g_on))
    assert torch.equal(s_off, s_on)
    assert len({a.item() for a in l_off}) == 3


def test_recompute_keeps_fewer_activations():
    def saved_bytes(recompute):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        m = GPTForCausalLM(gpt_tiny(recompute=recompute,
                                    num_hidden_layers=4), device="cpu")
        x = torch.zeros(4, 64, dtype=torch.long)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            m.compute_loss(x, x)
        return total[0]
    assert saved_bytes(True) < 0.5 * saved_bytes(False)


def test_recompute_takes_functions_and_needs_a_tensor():
    lin = torch.nn.Linear(4, 4)
    x = torch.randn(2, 4, requires_grad=True)
    out = fleet.recompute(lambda a: torch.tanh(lin(a)), x)
    out.sum().backward()
    want = torch.autograd.grad(torch.tanh(lin(x)).sum(), x)[0]
    assert torch.allclose(x.grad, want)
    with pytest.raises(ValueError, match="tensor"):
        fleet.recompute(lambda: 1)


def test_fleet_is_the_identity_on_one_card():
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "unknown": 3}
    fleet.init(is_collective=True, strategy=s)
    m = torch.nn.Linear(2, 2)
    opt = AdamW(m.parameters())
    assert fleet.distributed_model(m) is m
    assert fleet.distributed_optimizer(opt) is opt


@pytest.mark.parametrize("degree", ["mp_degree", "pp_degree",
                                    "sharding_degree", "sep_degree",
                                    "dp_degree"])
def test_fleet_refuses_hybrid_degrees(degree):
    """A degree above 1 needs a world of as many ranks (the gloo worlds of
    tests/test_torch_fleet_hybrid.py run them): in one process without
    one, ``fleet.init`` refuses the strategy.  ``sep_degree > 1`` is
    still not ported."""
    s = DistributedStrategy()
    s.hybrid_configs = {degree: 2}
    if degree != "sep_degree":
        with pytest.raises(ValueError, match="world"):
            fleet.init(strategy=s)
        return
    with pytest.raises(NotImplementedError, match="A.5"):
        fleet.init(strategy=s)
    with pytest.raises(NotImplementedError, match="A.5"):
        fleet.distributed_optimizer(object(), s)
