"""The port's optimizers and AMP O2 decorate against the JAX package's, on
the CPU: AdamW below, then the schedules and clips, the rest of the
family (Momentum, Adamax, Adagrad, RMSProp, Adadelta, Lars, Lamb), every
class's O2 masters and parameter groups.

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
from paddle_tpu_torch import optimizer as popt
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


# -- the rest of the family: Momentum, Adamax, Adagrad, RMSProp, Adadelta,
#    Lars, Lamb ------------------------------------------------------------

#: (class, JAX keyword arguments, the port's): each class at settings that
#: reach every branch of its update (Nesterov, centred RMSProp with
#: momentum, Lars's decay, Lamb's decay)
FAMILY = {
    "Momentum": (dict(momentum=0.9, use_nesterov=True, weight_decay=0.01),
                 dict(momentum=0.9, use_nesterov=True, weight_decay=0.01)),
    "Adamax": (dict(beta1=0.8, beta2=0.99, weight_decay=0.01),
               dict(beta1=0.8, beta2=0.99, weight_decay=0.01)),
    "Adagrad": (dict(epsilon=1e-6, initial_accumulator_value=0.1),
                dict(epsilon=1e-6, initial_accumulator_value=0.1)),
    "RMSProp": (dict(rho=0.9, momentum=0.5, centered=True),
                dict(rho=0.9, momentum=0.5, centered=True)),
    "Adadelta": (dict(rho=0.9, epsilon=1e-6), dict(rho=0.9, epsilon=1e-6)),
    "Lars": (dict(momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.001),
             dict(momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.001)),
    "Lamb": (dict(lamb_weight_decay=0.01), dict(lamb_weight_decay=0.01)),
}


def _kw(name: str, side: int) -> dict:
    return FAMILY.get(name, ({}, {}))[side]


def _family_jax(name, w0, grads, sched_lr: bool, dtype=None):
    from paddle_tpu.optimizer import lr as jlr

    params = [paddle.create_parameter(list(w.shape), "float32") for w in w0]
    for p, w in zip(params, w0):
        p.set_value(w)
    lr = (jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.05, T_max=8), 2, 0.0,
                           0.05) if sched_lr else 0.05)
    # no clip at O2: the JAX clip scales bf16 gradients in bf16, where the
    # port's returns f32 ones (a deliberate departure, nn/clip.py)
    clip = paddle.nn.ClipGradByGlobalNorm(1.0) if dtype is None else None
    opt = getattr(paddle.optimizer, name)(
        learning_rate=lr, parameters=params, grad_clip=clip,
        **_kw(name, 0))
    if dtype is not None:
        class M(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.ps = paddle.nn.ParameterList(params)
        paddle.amp.decorate(M(), optimizers=opt, level="O2", dtype=dtype)
    for gs in grads:
        loss = sum((p.astype("float32") * paddle.to_tensor(g)).sum()
                   for p, g in zip(params, gs))
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched_lr:
            lr.step()
    masters = []
    for p in params:
        accs = opt._accumulators[opt._param_key(p)]
        src = accs.get("master_weight", p)
        masters.append(np.asarray(src.astype("float32").numpy()))
    return ([np.asarray(p.astype("float32").numpy()) for p in params],
            masters)


def _family_port(name, w0, grads, sched_lr: bool, dtype=None):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as plr

    m = torch.nn.Module()
    m.ps = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0])
    lr = (plr.LinearWarmup(plr.CosineAnnealingDecay(0.05, T_max=8), 2, 0.0,
                           0.05) if sched_lr else 0.05)
    clip = ClipGradByGlobalNorm(1.0) if dtype is None else None
    opt = getattr(popt, name)(list(m.ps), lr=lr, grad_clip=clip,
                              **_kw(name, 1))
    if dtype is not None:
        amp.decorate(m, opt, level="O2", dtype=dtype)
    for gs in grads:
        for p, g in zip(m.ps, gs):
            p.grad = torch.from_numpy(g.copy()).to(p.dtype)
        opt.step()
        opt.clear_grad()
        if sched_lr:
            lr.step()
    masters = [opt.state[p].get("master_weight", p).detach().float().numpy()
               for p in m.ps]
    return [p.detach().float().numpy() for p in m.ps], masters


def _family_inputs(seed):
    rs = np.random.RandomState(seed)
    w0 = [rs.randn(4, 3).astype(np.float32), rs.randn(6).astype(np.float32)]
    grads = [[rs.randn(*w.shape).astype(np.float32) for w in w0]
             for _ in range(5)]
    return w0, grads



@pytest.mark.parametrize("sched_lr", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILY))
def test_family_five_steps_match_jax(name, sched_lr):
    """f32, 5 steps with a global-norm clip of 1.0 (every step clips), at
    a float rate and under ``LinearWarmup(CosineAnnealingDecay)``: 1e-6
    absolute (the same f32 arithmetic; Lars's and Lamb's norms are sums in
    another order)."""
    w0, grads = _family_inputs(11)
    ref, _ = _family_jax(name, w0, grads, sched_lr)
    got, _ = _family_port(name, w0, grads, sched_lr)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(FAMILY) + ["SGD", "Adam", "AdamW"])
def test_every_class_keeps_o2_masters_like_jax(name):
    """O2 (bf16 parameters, no clip): every class keeps an f32 master,
    updates it in f32 and rounds it into the parameter; 5 steps against the
    JAX
    class, the masters to 1e-6 relative and absolute (the same f32
    arithmetic, which XLA fuses otherwise: Adadelta's quotient under its
    square root parts by 5 f32 steps at 2.9) and the bf16 parameters
    bitwise (the master rounded once)."""
    w0, grads = _family_inputs(12)
    grads = [[np.asarray(paddle.to_tensor(g).astype("bfloat16")
                         .astype("float32").numpy()) for g in gs]
             for gs in grads]
    ref, ref_m = _family_jax(name, w0, grads, False, "bfloat16")
    got, got_m = _family_port(name, w0, grads, False, "bfloat16")
    for g, r, gm, rm in zip(got, ref, got_m, ref_m):
        np.testing.assert_allclose(gm, rm, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", sorted(FAMILY) + ["SGD", "Adam", "AdamW"])
def test_all_optimizers_o2_accumulate(name):
    """The O2-masters case of ``tests/test_amp.py`` for every class: 50
    steps far below bf16's resolution move the weights through the
    master."""
    # Lars's step is lr * lars_coeff (1e-3) * |p| / |g|: a rate of 0.1
    # makes it ~5e-5, below bf16's resolution as the others' are
    kw = {"Adadelta": dict(lr=1.0), "Lars": dict(lr=0.1, momentum=0.9),
          "Adagrad": dict(lr=1e-4), "RMSProp": dict(lr=1e-4)}.get(
        name, dict(lr=1e-4))
    torch.manual_seed(0)
    lin = amp.decorate(torch.nn.Linear(4, 4, bias=False), level="O2")
    opt = getattr(popt, name)(lin.parameters(), **kw)
    w0 = lin.weight.detach().float().clone()
    x = torch.ones(2, 4)
    for _ in range(50):
        with amp.auto_cast(dtype="bfloat16", level="O2"):
            loss = lin(x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert (lin.weight.detach().float() - w0).abs().mean().item() > 1e-4
    assert opt.state[lin.weight]["master_weight"].dtype == torch.float32


def test_lars_excludes_named_parameters_and_alias():
    """``exclude_from_weight_decay`` matches the names of ``(name,
    parameter)`` pairs, as the JAX class matches ``p.name``; the reference
    alias is the class."""
    torch.manual_seed(4)
    lin = torch.nn.Linear(3, 2)
    w0 = lin.weight.detach().clone()
    opt = popt.Lars(lin.named_parameters(), lr=0.1, momentum=0.9,
                    lars_weight_decay=0.5, exclude_from_weight_decay=["weight"])
    lin.weight.grad = torch.ones(2, 3)
    opt.step()
    local_lr = 0.1 * 0.001 * w0.norm() / torch.ones(2, 3).norm()
    torch.testing.assert_close(lin.weight.detach(), w0 - local_lr)
    assert popt.LarsMomentumOptimizer is popt.Lars


# -- parameter groups (tests/test_optimizer.py:273-345) ------------------------

def _two_linears(seed=0):
    torch.manual_seed(seed)
    m1, m2 = torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)
    m2.load_state_dict(m1.state_dict())
    return m1, m2


def test_group_lr_factor():
    m1, m2 = _two_linears()
    w1, w2 = m1.weight.detach().clone(), m2.weight.detach().clone()
    opt = popt.SGD([{"params": m1.parameters()},
                    {"params": m2.parameters(), "learning_rate": 0.5}],
                   lr=0.1)
    x = torch.ones(2, 4)
    (m1(x).sum() + m2(x).sum()).backward()
    opt.step()
    d1 = (w1 - m1.weight.detach()).abs().max()
    d2 = (w2 - m2.weight.detach()).abs().max()
    assert abs(d2 / d1 - 0.5) < 1e-5


def test_group_weight_decay_override_adamw():
    """The no-decay group lands exactly where a ``weight_decay=0``
    optimizer lands, the other where ``weight_decay=0.5`` lands."""
    m1, m2 = _two_linears()
    opt = popt.AdamW([{"params": m1.parameters(), "weight_decay": 0.0},
                      {"params": m2.parameters()}], lr=0.1,
                     weight_decay=0.5)
    x = torch.ones(2, 4)
    (m1(x).sum() + m2(x).sum()).backward()
    opt.step()
    r1, r2 = _two_linears()
    o1 = popt.AdamW(r1.parameters(), lr=0.1, weight_decay=0.0)
    o2 = popt.AdamW(r2.parameters(), lr=0.1, weight_decay=0.5)
    (r1(x).sum() + r2(x).sum()).backward()
    o1.step()
    o2.step()
    assert torch.equal(m1.weight, r1.weight)
    assert torch.equal(m2.weight, r2.weight)
    assert not torch.allclose(m1.weight, m2.weight)


def test_group_dict_without_params_key_raises():
    m = torch.nn.Linear(4, 4)
    with pytest.raises(ValueError, match="'params'"):
        popt.SGD([{"param": m.parameters()}], lr=0.1)


def test_duplicate_param_rejected():
    m = torch.nn.Linear(4, 4)
    with pytest.raises(ValueError):
        popt.SGD([{"params": m.parameters()}, {"params": m.parameters()}],
                 lr=0.1)


@pytest.mark.parametrize("o2", [False, True])
def test_state_dict_roundtrip_with_groups(o2):
    """Two steps in a row equal one step, a save and a restore into a
    fresh model and optimizer, and one more step; with O2 the restored
    masters and moments stay f32 (torch's own loader would cast them to
    the parameters' bf16)."""
    def run(steps, restore_from=None):
        torch.manual_seed(0)
        m = torch.nn.Linear(4, 4)
        if o2:
            amp.decorate(m, level="O2")
        opt = popt.AdamW([{"params": m.parameters(), "learning_rate": 0.3}],
                         lr=0.01)
        if restore_from is not None:
            m.load_state_dict(restore_from[0])
            opt.set_state_dict(restore_from[1])
        x = torch.ones(2, 4, dtype=m.weight.dtype)
        for _ in range(steps):
            m(x).float().sum().backward()
            opt.step()
            opt.clear_grad()
        return m, opt

    m_ref, o_ref = run(2)
    m_a, opt_a = run(1)
    m_b, o_b = run(1, restore_from=(m_a.state_dict(), opt_a.state_dict()))
    assert torch.equal(m_b.weight, m_ref.weight)
    for key, v in o_ref.state[m_ref.weight].items():
        got = o_b.state[m_b.weight][key]
        assert got.dtype == v.dtype and torch.equal(got, v), key


def test_groups_match_jax():
    """SGD with a group rate factor and AdamW with a group weight decay,
    3 steps, against the JAX classes with the same groups: 1e-6."""
    rs = np.random.RandomState(13)
    w0 = [rs.randn(3, 2).astype(np.float32) for _ in range(2)]
    grads = [[rs.randn(3, 2).astype(np.float32) for _ in w0]
             for _ in range(3)]
    for name, group_kw in (("SGD", {"learning_rate": 0.3}),
                           ("AdamW", {"weight_decay": 0.0,
                                      "beta1": 0.8})):
        jp = [paddle.create_parameter([3, 2], "float32") for _ in w0]
        for p, w in zip(jp, w0):
            p.set_value(w)
        jopt = getattr(paddle.optimizer, name)(
            learning_rate=0.05, parameters=[
                {"params": [jp[0]]}, {"params": [jp[1]], **group_kw}])
        tp = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
        topt = getattr(popt, name)([{"params": [tp[0]]},
                                    {"params": [tp[1]], **group_kw}],
                                   lr=0.05)
        for gs in grads:
            for p, q, g in zip(jp, tp, gs):
                p.grad = paddle.to_tensor(g)
                q.grad = torch.from_numpy(g)
            jopt.step()
            topt.step()
        for p, q in zip(jp, tp):
            np.testing.assert_allclose(q.detach().numpy(), p.numpy(),
                                       rtol=0, atol=1e-6)
