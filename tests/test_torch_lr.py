"""The port's learning-rate schedulers against the JAX package's, on the
CPU.

Every one of the 16 schedulers of ``paddle_tpu/optimizer/lr.py`` (and the
``LRScheduler`` base through them) gives its first 20 values in both
packages (rtol 1e-7; both are host float arithmetic, measured equal).
Each one's ``state_dict``, taken after 7 steps (``ReduceOnPlateau``: 9),
loads across packages, and the loaded scheduler gives the next values of
the one it came from.  The device
rate an optimizer reads (``_lr_tensor``) is the f32 of ``last_lr`` after
every step.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch.optimizer import lr as port_lr

STEPS = 20


def _warmup_cosine(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(0.1, T_max=10), 5, 0.0, 0.1)


#: name -> make(lr module); the lambdas are the same Python callables for
#: both packages
CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=512, warmup_steps=8),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 9], [1.0, 0.5, 0.1]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, decay_steps=8,
                                                   end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=6, end_lr=0.01, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.3, 6, 0.0, 0.3),
    "LinearWarmup_cosine": _warmup_cosine,
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [4, 11, 15], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=3, gamma=0.7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=12, eta_min=0.01),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(0.01, 0.1, 4,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(0.01, 0.1, 3, 5,
                                               mode="exp_range",
                                               exp_gamma=0.9),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=15),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(0.1, total_steps=15,
                                                anneal_strategy="linear"),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=4, T_mult=2, eta_min=0.01),
}

#: ReduceOnPlateau steps on a metric
METRICS = [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.92, 0.5, 0.6, 0.6, 0.6, 0.6,
           0.6, 0.6, 0.7, 0.4, 0.4, 0.4, 0.4, 0.4]


def _values(sched, n, metrics=None):
    out = []
    for i in range(n):
        out.append(sched())
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
    return out


def test_every_scheduler_class_is_ported():
    names = {n for n, v in vars(jax_lr).items()
             if isinstance(v, type) and issubclass(v, jax_lr.LRScheduler)}
    assert len(names) == 17
    assert names == set(port_lr.__all__)
    covered = {type(make(port_lr)).__name__ for make in CASES.values()}
    assert covered | {"ReduceOnPlateau", "LRScheduler"} == names


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_values_match(name):
    ref = _values(CASES[name](jax_lr), STEPS)
    got = _values(CASES[name](port_lr), STEPS)
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)
    assert len(set(ref)) > 1, "the case should move"


@pytest.mark.parametrize("factor,mode,threshold_mode",
                         [(0.5, "min", "rel"), (0.3, "max", "abs")])
def test_reduce_on_plateau_matches(factor, mode, threshold_mode):
    metrics = METRICS if mode == "min" else [-m for m in METRICS]

    def make(m):
        return m.ReduceOnPlateau(1.0, mode=mode, factor=factor, patience=2,
                                 threshold_mode=threshold_mode, cooldown=1)
    ref = _values(make(jax_lr), STEPS, metrics)
    got = _values(make(port_lr), STEPS, metrics)
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)
    assert min(ref) < 1.0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_loads_across_packages(name, direction):
    src_m, dst_m = ((jax_lr, port_lr) if direction == "jax_to_port"
                    else (port_lr, jax_lr))
    src = CASES[name](src_m)
    _values(src, 7)
    sd = src.state_dict()
    dst = CASES[name](dst_m)
    dst.set_state_dict(dict(sd))
    np.testing.assert_allclose(_values(dst, 13), _values(src, 13),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_reduce_on_plateau_state_dict_loads_across_packages(direction):
    src_m, dst_m = ((jax_lr, port_lr) if direction == "jax_to_port"
                    else (port_lr, jax_lr))

    def make(m):
        return m.ReduceOnPlateau(1.0, factor=0.5, patience=2, cooldown=1)
    src = make(src_m)
    _values(src, 9, METRICS)
    dst = make(dst_m)
    dst.set_state_dict(dict(src.state_dict()))
    np.testing.assert_allclose(_values(dst, 11, METRICS[9:]),
                               _values(src, 11, METRICS[9:]), rtol=1e-7,
                               atol=0)


def test_device_rate_follows_every_step():
    sched = _warmup_cosine(port_lr)
    t = sched._lr_tensor("cpu")
    assert t.dtype == torch.float32 and t.dim() == 0
    for _ in range(12):
        assert t.item() == np.float32(sched())
        sched.step()
    assert sched._lr_tensor("cpu") is t       # one tensor, written in place
    sd = sched.state_dict()
    assert "_lr_tensors" not in sd
    fresh = _warmup_cosine(port_lr)
    ft = fresh._lr_tensor("cpu")
    fresh.set_state_dict(sd)
    assert ft.item() == np.float32(sched())
    assert math.isclose(fresh(), sched())
