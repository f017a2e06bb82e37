"""The port's AdamW and AMP O2 decorate against the JAX package's, on the
CPU.

Two parameters (one kept in f32, one cast to bf16 by ``amp.decorate`` O2,
so the optimizer keeps an f32 master for it) take three steps of seeded
numpy gradients through ``paddle_tpu.optimizer.AdamW`` and the port's
``AdamW``.  The JAX side gets its gradients from ``sum(w * G)``, whose
gradient is G in the parameter's dtype; the port is handed the same G in
that dtype.  Tolerance: 1e-7 absolute on the f32 parameter and on the
bf16 parameter's f32 master (both sides do the same f32 arithmetic;
measured 0), and bitwise on the bf16 parameter, which is the master
rounded once.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import amp
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded, whatever hybrid mesh an earlier test
    file in the same worker left set."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


STEPS = 3


def _jax_run(w0, grads, moment_dtype, wd):
    a = paddle.create_parameter([4, 3], "float32")
    b = paddle.create_parameter([5], "float32")
    a.set_value(w0[0])
    b.set_value(w0[1])

    class M(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.b = b

    opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=[a, b],
                                 weight_decay=wd, moment_dtype=moment_dtype)
    paddle.amp.decorate(M(), optimizers=opt, level="O2")  # b -> bf16
    assert str(b.dtype).endswith("bfloat16")
    for ga, gb in grads:
        loss = (a * paddle.to_tensor(ga)).sum() \
            + (b.astype("float32") * paddle.to_tensor(gb)).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    master = opt._accumulators[opt._param_key(b)]["master_weight"]
    return (a.numpy(), b.astype("float32").numpy(),
            np.asarray(master.numpy()))


def _port_run(w0, grads, moment_dtype, wd):
    a = torch.nn.Parameter(torch.from_numpy(w0[0].copy()))
    m = torch.nn.Module()
    m.b = torch.nn.Parameter(torch.from_numpy(w0[1].copy()))
    opt = AdamW([a, m.b], lr=1e-2, weight_decay=wd,
                moment_dtype=moment_dtype)
    amp.decorate(m, opt, level="O2")
    assert m.b.dtype == torch.bfloat16 and a.dtype == torch.float32
    for ga, gb in grads:
        a.grad = torch.from_numpy(ga)
        m.b.grad = torch.from_numpy(gb).to(torch.bfloat16)
        opt.step()
        opt.zero_grad(set_to_none=True)
    st = opt.state[m.b]
    if moment_dtype is not None:
        assert st["moment1"].dtype == torch.bfloat16
    return (a.detach().numpy(), m.b.detach().float().numpy(),
            st["master_weight"].numpy())


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_adamw_matches_jax(moment_dtype, wd):
    rs = np.random.RandomState(0)
    w0 = (rs.randn(4, 3).astype(np.float32), rs.randn(5).astype(np.float32))
    grads = [(rs.randn(4, 3).astype(np.float32),
              rs.randn(5).astype(np.float32)) for _ in range(STEPS)]
    ref = _jax_run(w0, grads, moment_dtype, wd)
    got = _port_run(w0, grads, moment_dtype, wd)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-7)


def test_master_keeps_updates_below_bf16_resolution():
    """An update far below bf16's resolution at 1.0 accumulates in the
    master and reaches the bf16 parameter once it adds up."""
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = AdamW([p], lr=1e-4, weight_decay=0.0)
    for _ in range(60):
        p.grad = torch.full((4,), -1.0, dtype=torch.bfloat16)
        opt.step()
    master = opt.state[p]["master_weight"]
    assert master[0].item() == pytest.approx(1.0 + 60 * 1e-4, rel=1e-5)
    assert p[0].item() > 1.0


def test_apply_decay_param_fun_takes_names():
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    for p in lin.parameters():
        p.grad = torch.ones_like(p)
    before = {n: p.detach().clone() for n, p in lin.named_parameters()}
    opt = AdamW(lin.named_parameters(), lr=0.1, weight_decay=0.5,
                apply_decay_param_fun=lambda n: n == "weight")
    opt.step()
    # Adam's first step moves each element by lr (g = 1); decay only on
    # the weight
    torch.testing.assert_close(lin.bias.detach(), before["bias"] - 0.1)
    torch.testing.assert_close(lin.weight.detach(),
                               before["weight"] * 0.95 - 0.1)
    with pytest.raises(ValueError, match="pairs"):
        AdamW(lin.parameters(), apply_decay_param_fun=lambda n: True)


def test_decorate_levels():
    m = torch.nn.Linear(2, 2)
    assert amp.decorate(m, level="O1") is m
    assert m.weight.dtype == torch.float32
    out = amp.decorate(m, "opt", level="O2", dtype="bfloat16")
    assert out == (m, "opt") and m.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        amp.decorate(m, level="O3")


# -- the optimizer base: schedules, clips, SGD and Adam ----------------------

def _recipe_jax(name, w0, grads, wd):
    from paddle_tpu import nn as jnn
    from paddle_tpu.optimizer import lr as jlr

    params = [jnn.Parameter(w.copy()) for w in w0]
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.05, T_max=8), 2,
                             0.0, 0.05)
    clip = jnn.ClipGradByGlobalNorm(1.0)
    kw = dict(learning_rate=sched, parameters=params, grad_clip=clip)
    if wd is not None:
        kw["weight_decay"] = wd
    opt = getattr(paddle.optimizer, name)(**kw)
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = paddle.to_tensor(g)
        opt.step()
        opt.clear_grad()
        sched.step()
    return [np.asarray(p.numpy()) for p in params], opt.state_dict()


def _recipe_port(name, w0, grads, wd):
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as plr

    params = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    sched = plr.LinearWarmup(plr.CosineAnnealingDecay(0.05, T_max=8), 2,
                             0.0, 0.05)
    kw = dict(lr=sched, grad_clip=ClipGradByGlobalNorm(1.0))
    if wd is not None:
        kw["weight_decay"] = wd
    opt = getattr(popt, name)(params, **kw)
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        opt.clear_grad()
        sched.step()
    return [p.detach().numpy() for p in params], opt, sched


@pytest.mark.parametrize("name,wd", [("SGD", None), ("SGD", 0.1),
                                     ("Adam", None), ("Adam", 0.1),
                                     ("AdamW", 0.01), ("AdamW", 0.0)])
def test_five_steps_under_a_schedule_and_a_clip_match_jax(name, wd):
    """f32, 5 steps under ``LinearWarmup(CosineAnnealingDecay)`` with a
    global-norm clip of 1.0 (the gradients' norm is ~4, so every step
    clips): 1e-6 absolute.  Adam's weight decay is L2 on the gradient,
    AdamW's decoupled."""
    rs = np.random.RandomState(1)
    w0 = [rs.randn(4, 3).astype(np.float32), rs.randn(6).astype(np.float32)]
    grads = [[rs.randn(*w.shape).astype(np.float32) for w in w0]
             for _ in range(5)]
    ref, jsd = _recipe_jax(name, w0, grads, wd)
    got, opt, sched = _recipe_port(name, w0, grads, wd)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
    assert opt.get_lr() == sched()
    sd = opt.state_dict()
    assert sd["@lr_scheduler"]["last_epoch"] == 5
    assert sd["@lr_scheduler"] == {k: v for k, v in jsd["@lr_scheduler"]
                                   .items() if k in sd["@lr_scheduler"]}


def test_state_dict_restores_the_scheduler_and_set_lr_refuses():
    from paddle_tpu_torch.optimizer import SGD, lr as plr

    w = torch.nn.Parameter(torch.zeros(2))
    sched = plr.StepDecay(0.5, step_size=1, gamma=0.5)
    opt = SGD([w], lr=sched)
    sched.step()
    sched.step()
    sd = opt.state_dict()
    fresh_sched = plr.StepDecay(0.5, step_size=1, gamma=0.5)
    fresh = SGD([w], lr=fresh_sched)
    fresh.set_state_dict(sd)
    assert fresh.get_lr() == opt.get_lr() == 0.125
    assert fresh_sched._lr_tensor("cpu").item() == 0.125
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    plain = SGD([w], lr=0.5)
    plain.set_lr(0.25)
    assert plain.get_lr() == 0.25


def test_scheduler_rate_is_read_from_the_device_tensor():
    """Under a scheduler the update reads the scheduler's f32 tensor, so a
    rate written there (as ``step()`` writes it) is the rate used."""
    from paddle_tpu_torch.optimizer import SGD, lr as plr

    w = torch.nn.Parameter(torch.zeros(1))
    sched = plr.StepDecay(0.5, step_size=1, gamma=0.5)
    opt = SGD([w], lr=sched)
    sched._lr_tensor("cpu").fill_(2.0)
    w.grad = torch.ones(1)
    opt.step()
    assert w.item() == -2.0


def test_need_clip_and_params_without_grad():
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD

    a, b, c = (torch.nn.Parameter(torch.zeros(2)) for _ in range(3))
    b.need_clip = False
    opt = SGD([a, b, c], lr=1.0, grad_clip=ClipGradByGlobalNorm(1.0))
    a.grad = torch.full((2,), 3.0)
    b.grad = torch.full((2,), 3.0)
    opt.step()
    assert torch.allclose(a.detach(), torch.full((2,), -2 ** -0.5))
    assert torch.equal(b.detach(), torch.full((2,), -3.0))
    assert torch.equal(c.detach(), torch.zeros(2))
