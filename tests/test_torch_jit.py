"""The port's ``jit.to_static`` against the JAX package's, on the CPU.

On the CPU a program runs its body (the card's CUDA graphs are held in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``), so what is compared
here is what a program computes and how the cache keys it:

- ``TestTrainStepToStatic``'s three cases (``tests/test_jit.py:96-170``)
  in both packages on the same initial weights: the compiled step's
  weights against the JAX step's (1e-5) and against the port's eager
  step (bitwise), Adam's state threaded, a scheduler's new rate read
  without a new program; the same call sequence gives the same number of
  programs in both caches;
- a tiny GPT trained 5 steps through ``to_static`` with the whole recipe
  at dropout 0 (recompute, ``LinearWarmup(CosineAnnealingDecay)``, a
  global-norm clip, AdamW), f32: losses equal the JAX loop's to 1e-5
  relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch import jit
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW
from paddle_tpu_torch.optimizer import lr as port_lr

torch.set_num_threads(2)
F = torch.nn.functional


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def t(a):
    return paddle.to_tensor(np.asarray(a, dtype=np.float32))


def _copy_linears(jax_layers, port_layers):
    """The JAX layers' weights ([in, out]) into the port's ([out, in])."""
    for j, p in zip(jax_layers, port_layers):
        with torch.no_grad():
            p.weight.copy_(torch.from_numpy(np.asarray(j.weight.numpy()).T))
            p.bias.copy_(torch.from_numpy(np.asarray(j.bias.numpy())))


def test_full_train_step_compiles_and_matches_eager():
    xs = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    ys = np.random.RandomState(1).randn(8, 1).astype(np.float32)

    paddle.seed(123)
    jnet = jnn.Sequential(jnn.Linear(4, 16), jnn.Tanh(), jnn.Linear(16, 1))
    w0 = [(np.asarray(m.weight.numpy()), np.asarray(m.bias.numpy()))
          for m in (jnet[0], jnet[2])]
    jo = jopt.SGD(0.1, parameters=jnet.parameters())

    @paddle.jit.to_static
    def jstep(x, y):
        loss = jF.mse_loss(jnet(x), y)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    ref_losses = [float(jstep(t(xs), t(ys))) for _ in range(5)]

    def build():
        net = torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.Tanh(),
                                  torch.nn.Linear(16, 1))
        with torch.no_grad():
            for m, (w, b) in zip((net[0], net[2]), w0):
                m.weight.copy_(torch.from_numpy(w.T))
                m.bias.copy_(torch.from_numpy(b))
        return net, SGD(net.parameters(), lr=0.1)

    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    net_e, opt_e = build()
    for _ in range(5):
        loss = F.mse_loss(net_e(x), y)
        loss.backward()
        opt_e.step()
        opt_e.clear_grad()

    net_s, opt_s = build()

    @jit.to_static
    def train_step(x, y):
        loss = F.mse_loss(net_s(x), y)
        loss.backward()
        opt_s.step()
        opt_s.clear_grad()
        return loss

    losses = [train_step(x, y).item() for _ in range(5)]
    assert torch.equal(net_s[0].weight, net_e[0].weight)
    np.testing.assert_allclose(net_s[0].weight.detach().numpy().T,
                               jnet[0].weight.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert len(train_step.program_cache) == len(jstep.program_cache) == 1
    assert (train_step.misses, train_step.hits) == (1, 4)


def test_adam_train_step_state_threading():
    xs = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    w_true = np.random.RandomState(1).randn(4, 4).astype(np.float32)
    ys = xs @ w_true

    paddle.seed(0)
    jnet = jnn.Linear(4, 4)
    jo = jopt.Adam(0.1, parameters=jnet.parameters())

    @paddle.jit.to_static
    def jstep(x, y):
        loss = jF.mse_loss(jnet(x), y)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    net = torch.nn.Linear(4, 4)
    _copy_linears([jnet], [net])
    o = Adam(net.parameters(), lr=0.1)

    @jit.to_static
    def step(x, y):
        loss = F.mse_loss(net(x), y)
        loss.backward()
        o.step()
        o.clear_grad()
        return loss

    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    ref = [float(jstep(t(xs), t(ys))) for _ in range(61)]
    got = [step(x, y).item() for _ in range(61)]
    assert got[-1] < got[0] * 0.1
    np.testing.assert_allclose(got[:20], ref[:20], rtol=1e-5)
    # moments were threaded, not recreated
    assert o.state[net.weight]["moment1"].abs().max() > 0
    assert len(step.program_cache) == len(jstep.program_cache) == 1


def test_lr_schedule_no_retrace():
    sched = port_lr.StepDecay(0.5, step_size=1, gamma=0.5)
    w = torch.nn.Parameter(torch.zeros(1))
    o = SGD([w], lr=sched)

    def _step(g):
        w.grad = g
        o.step()
        o.clear_grad()
        return w * 1.0

    sstep = jit.to_static(_step)
    g = torch.ones(1)
    sstep(g)
    np.testing.assert_allclose(w.detach().numpy(), [-0.5], rtol=1e-5)
    sched.step()  # lr 0.5 -> 0.25
    sstep(g)
    np.testing.assert_allclose(w.detach().numpy(), [-0.75], rtol=1e-5)
    assert len(sstep.program_cache) == 1 and sstep.misses == 1

    jsched = jopt.lr.StepDecay(0.5, step_size=1, gamma=0.5)
    jw = jnn.Parameter(np.zeros(1, dtype=np.float32))
    jo = jopt.SGD(jsched, parameters=[jw])

    def _jstep(g):
        jw.grad = g
        jo.step()
        jo.clear_grad()
        return jw * 1.0

    jstep = paddle.jit.to_static(_jstep)
    jg = t(np.ones(1))
    jstep(jg)
    jsched.step()
    jstep(jg)
    np.testing.assert_allclose(w.detach().numpy(), jw.numpy(), rtol=0)
    assert len(jstep.program_cache) == len(sstep.program_cache)


def test_cache_keys_follow_the_jax_program_cache():
    """One program per tensor spec, per non-tensor argument value and per
    module mode, in both packages, for the same call sequence."""
    def port(x, scale, net):
        return net(x) * scale

    def jax(x, scale, net):
        return net(x) * scale

    pnet, jnet = torch.nn.Linear(3, 2), jnn.Linear(3, 2)
    pf, jf = jit.to_static(port), paddle.jit.to_static(jax)
    calls = [((2, 3), 1.0, "train"), ((2, 3), 1.0, "train"),
             ((2, 3), 2.0, "train"), ((5, 3), 1.0, "train"),
             ((2, 3), 1.0, "eval"), ((2, 3), 1.0, "train")]
    for shape, scale, mode in calls:
        for net in (pnet, jnet):
            net.train() if mode == "train" else net.eval()
        x = np.ones(shape, np.float32)
        pf(torch.from_numpy(x), scale, pnet)
        jf(t(x), scale, jnet)
    assert len(pf.program_cache) == len(jf.program_cache) == 4
    assert (pf.misses, pf.hits, pf.captures) == (4, 2, 0)


def test_switches_and_module_forward():
    calls = []

    def body(x):
        calls.append(1)
        return x + 1

    f = jit.to_static(body)
    jit.enable_to_static(False)
    try:
        f(torch.zeros(2))
        assert f.misses == 0 and len(calls) == 1
    finally:
        jit.enable_to_static(True)
    f(torch.zeros(2))
    assert f.misses == 1
    assert f.rollback() is body and f(torch.zeros(2)).tolist() == [1, 1]
    assert f.misses == 1
    lin = torch.nn.Linear(2, 2)
    assert jit.to_static(lin) is lin
    assert isinstance(lin.forward, jit.StaticFunction)
    assert lin(torch.ones(1, 2)).shape == (1, 2)
    assert jit.not_to_static(body)._not_to_static
    spec = jit.InputSpec([None, 4], "float32", "x")
    assert spec.dtype == torch.float32 and "x" in repr(spec)


def test_tiny_gpt_recipe_loop_matches_jax():
    """5 steps of the GPT-2 recipe at dropout 0 through ``to_static``: a
    warm-up then cosine schedule, a global-norm clip, recompute, AdamW;
    f32."""
    rs = np.random.RandomState(0)
    xs, ys = rs.randint(0, 128, (2, 16)), rs.randint(0, 128, (2, 16))

    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny(recompute=True))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    jsched = jopt.lr.LinearWarmup(
        jopt.lr.CosineAnnealingDecay(1e-2, T_max=10), 2, 0.0, 1e-2)
    jo = jopt.AdamW(learning_rate=jsched, parameters=jm.parameters(),
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))

    @paddle.jit.to_static
    def jstep(x, y):
        loss = jm.compute_loss(x, y)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    ref = []
    for _ in range(5):
        ref.append(float(jstep(paddle.to_tensor(xs), paddle.to_tensor(ys))))
        jsched.step()

    pm = GPTForCausalLM(gpt_tiny(recompute=True), device="cpu")
    from_jax_state_dict(pm, state)
    sched = port_lr.LinearWarmup(
        port_lr.CosineAnnealingDecay(1e-2, T_max=10), 2, 0.0, 1e-2)
    clip = ClipGradByGlobalNorm(1.0)
    o = AdamW(pm.parameters(), lr=sched, grad_clip=clip)

    @jit.to_static
    def step(x, y):
        loss = pm.compute_loss(x, y)
        loss.backward()
        o.step()
        o.clear_grad()
        return loss

    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    got = []
    for _ in range(5):
        got.append(step(x, y).item())
        sched.step()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert got[-1] < got[0]
    assert len(step.program_cache) == len(jstep.program_cache) == 1
