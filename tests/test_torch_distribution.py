"""The port's ``distribution`` against the JAX package's, on the CPU.

Spec: ``tests/test_distribution.py`` case by case, and the multinomial
and transform cases of ``tests/test_fft_signal.py``'s review classes.
Both packages take the same seeded numpy parameters and values:

- deterministic quantities (moments, ``log_prob``, ``probs``,
  ``entropy``, every registered KL, transforms and their log-det
  Jacobians, gradients of those) within 1e-5 relative;
- samples by their laws (the draws are the port's own Philox words, not
  ``jax.random``'s): shapes, supports, means and variances within 5
  standard errors of the closed forms, and the pathwise gradient of a
  gamma-based mean (Beta, Dirichlet: the implicit gradient) against the
  analytic ``d E[x] / d alpha``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import distribution as JD
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import distribution as D
from paddle_tpu_torch import rng
from paddle_tpu_torch.device import device_guard

torch.set_num_threads(2)
REL = 1e-5


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy().astype(np.float64)
    if isinstance(t, np.ndarray):
        return t.astype(np.float64)
    return np.asarray(t.numpy(), dtype=np.float64)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(
        1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0.0))))


def _law(samples, mean, var, k=5.0):
    """Each column's sample mean and variance within ``k`` standard
    errors of ``mean``/``var`` (the variance's error from the sample's
    fourth central moment)."""
    x = _np(samples)
    shape = x.shape[1:]
    x = x.reshape(x.shape[0], -1)
    n = x.shape[0]
    mean = np.broadcast_to(np.asarray(mean, np.float64), shape).reshape(-1)
    var = np.broadcast_to(np.asarray(var, np.float64), shape).reshape(-1)
    m, v = x.mean(0), x.var(0)
    m4 = ((x - m) ** 4).mean(0)
    assert np.all(np.abs(m - mean) <= k * np.sqrt(var / n) + 1e-12), (m,
                                                                       mean)
    assert np.all(np.abs(v - var) <= k * np.sqrt(np.maximum(
        m4 - v * v, 0) / n) + 1e-12), (v, var)


LOC, SCALE = np.array([0.0, 1.0, -0.5]), np.array([1.0, 2.0, 0.3])


class TestNormal:
    def test_moments_log_prob_probs_entropy(self):
        j, p = JD.Normal(LOC, SCALE), D.Normal(LOC, SCALE)
        for name in ("mean", "variance", "stddev"):
            _close(getattr(p, name), getattr(j, name))
        v = np.array([0.5, -1.0, 0.1])
        _close(p.log_prob(v), j.log_prob(v))
        _close(p.probs(v), j.probs(v))
        _close(p.prob(v), j.prob(v))
        _close(p.entropy(), j.entropy())

    def test_kl(self):
        j1, j2 = JD.Normal(LOC, SCALE), JD.Normal(1.0, 2.0)
        p1, p2 = D.Normal(LOC, SCALE), D.Normal(1.0, 2.0)
        _close(p1.kl_divergence(p2), j1.kl_divergence(j2))
        _close(D.kl_divergence(p1, p2), JD.kl_divergence(j1, j2))

    def test_sample_law_and_seed(self):
        rng.seed(7)
        s = D.Normal(LOC, SCALE).sample((20000,))
        assert tuple(s.shape) == (20000, 3) and not s.requires_grad
        _law(s, LOC, SCALE ** 2)
        rng.seed(7)
        assert torch.equal(D.Normal(LOC, SCALE).sample((20000,)), s)
        assert not torch.equal(D.Normal(LOC, SCALE).sample((20000,)), s)

    def test_rsample_grad(self):
        loc = torch.tensor([0.5], requires_grad=True)
        out = D.Normal(loc, torch.tensor([1.0])).rsample((64,)).sum()
        out.backward()
        jloc = paddle.to_tensor([0.5], stop_gradient=False)
        JD.Normal(jloc, paddle.to_tensor([1.0])).rsample((64,)).sum() \
            .backward()
        _close(loc.grad, jloc.grad)

    def test_draw_advances_the_generator_once(self):
        gen = rng.default_generator("cpu")
        before = int(gen.get_state()[1])
        D.Normal(0.0, 1.0).rsample((10,))
        assert int(gen.get_state()[1]) == before + 1


class TestUniform:
    def test_basic(self):
        j, p = JD.Uniform(1.0, 3.0), D.Uniform(1.0, 3.0)
        for name in ("mean", "variance"):
            _close(getattr(p, name), getattr(j, name))
        _close(p.entropy(), j.entropy())
        for v in (2.0, 5.0, 0.5):
            _close(p.log_prob(v), j.log_prob(paddle.to_tensor(v)))
            _close(p.probs(v), j.probs(paddle.to_tensor(v)))
        rng.seed(3)
        s = _np(p.sample((20000,)))
        assert s.min() >= 1.0 and s.max() < 3.0
        _law(torch.from_numpy(s)[:, None], 2.0, 4.0 / 12)

    def test_kl(self):
        _close(D.kl_divergence(D.Uniform(0.0, 1.0), D.Uniform(-1.0, 2.0)),
               JD.kl_divergence(JD.Uniform(0.0, 1.0), JD.Uniform(-1.0, 2.0)))


LOGITS = np.log(np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]]))


class TestCategorical:
    def test_log_prob_probs_entropy_kl(self):
        j, p = JD.Categorical(LOGITS), D.Categorical(LOGITS)
        idx = np.array([[2], [0]])
        _close(p.log_prob(idx), j.log_prob(idx))
        _close(p.probs(idx), j.probs(idx))
        _close(p.entropy(), j.entropy())
        other = np.log(np.full((2, 3), 1 / 3))
        _close(p.kl_divergence(D.Categorical(other)),
               j.kl_divergence(JD.Categorical(other)))
        j1, p1 = JD.Categorical(LOGITS[0]), D.Categorical(LOGITS[0])
        _close(p1.log_prob(np.array([2])), j1.log_prob(np.array([2])))

    def test_sample_law(self):
        rng.seed(11)
        s = D.Categorical(LOGITS).sample((20000,))
        assert tuple(s.shape) == (20000, 2) and s.dtype == torch.int64
        p = np.exp(LOGITS)
        k = np.arange(3)
        mean = (p * k).sum(-1)
        _law(s.to(torch.float64), mean, (p * k * k).sum(-1) - mean ** 2)


class TestMultinomial:
    def test_moments_log_prob_entropy(self):
        probs = np.array([0.2, 0.3, 0.5])
        j, p = JD.Multinomial(10, probs), D.Multinomial(10, probs)
        for name in ("mean", "variance"):
            _close(getattr(p, name), getattr(j, name))
        v = np.array([2.0, 3.0, 5.0])
        _close(p.log_prob(v), j.log_prob(v))
        _close(p.entropy(), j.entropy())
        _close(D.Multinomial(2, np.array([0.5, 0.5])).entropy(),
               JD.Multinomial(2, np.array([0.5, 0.5])).entropy())

    def test_sample_counts_law(self):
        rng.seed(13)
        probs = np.array([[0.5, 0.5, 0.0], [0.1, 0.3, 0.6]])
        s = D.Multinomial(20, probs).sample((4000,))
        assert tuple(s.shape) == (4000, 2, 3)
        np.testing.assert_array_equal(_np(s).sum(-1), 20.0)
        _law(s, 20 * probs, 20 * probs * (1 - probs))

    def test_refuses_zero_trials(self):
        with pytest.raises(ValueError):
            D.Multinomial(0, np.array([0.5, 0.5]))


A, B = np.array([2.0, 0.5, 4.0]), np.array([3.0, 1.5, 1.0])
CONC = np.array([[1.0, 2.0, 3.0], [0.4, 0.7, 2.5]])


class TestBetaDirichlet:
    def test_beta(self):
        j, p = JD.Beta(A, B), D.Beta(A, B)
        for name in ("mean", "variance"):
            _close(getattr(p, name), getattr(j, name))
        v = np.array([0.5, 0.2, 0.9])
        _close(p.log_prob(v), j.log_prob(v))
        _close(p.prob(v), j.prob(v))
        _close(p.entropy(), j.entropy())
        _close(D.ExponentialFamily.entropy(p), p.entropy())

    def test_dirichlet(self):
        j, p = JD.Dirichlet(CONC), D.Dirichlet(CONC)
        for name in ("mean", "variance"):
            _close(getattr(p, name), getattr(j, name))
        v = np.array([[0.2, 0.3, 0.5], [0.1, 0.1, 0.8]])
        _close(p.log_prob(v), j.log_prob(v))
        _close(p.entropy(), j.entropy())
        _close(D.ExponentialFamily.entropy(p),
               JD.ExponentialFamily.entropy(j))
        with pytest.raises(ValueError):
            D.Dirichlet(1.0)

    @pytest.mark.parametrize("pair", ["beta", "dirichlet"])
    def test_kl_closed_and_bregman(self, pair):
        from paddle_tpu.distribution import kl as jkl
        from paddle_tpu_torch.distribution import kl as pkl

        if pair == "beta":
            jp, jq = JD.Beta(A, B), JD.Beta(B, A + 1)
            pp, pq = D.Beta(A, B), D.Beta(B, A + 1)
        else:
            jp, jq = JD.Dirichlet(CONC), JD.Dirichlet(CONC[::-1] + 0.5)
            pp, pq = D.Dirichlet(CONC), D.Dirichlet(CONC[::-1] + 0.5)
        _close(D.kl_divergence(pp, pq), JD.kl_divergence(jp, jq))
        _close(pkl._kl_expfamily_expfamily(pp, pq),
               jkl._kl_expfamily_expfamily(jp, jq))
        _close(D.kl_divergence(pp, pp), np.zeros(pp.batch_shape))

    def test_beta_sample_law_and_pathwise_gradient(self):
        rng.seed(5)
        a = torch.tensor(A, dtype=torch.float32, requires_grad=True)
        b = torch.tensor(B, dtype=torch.float32, requires_grad=True)
        s = D.Beta(a, b).sample((40000,))
        assert tuple(s.shape) == (40000, 3)
        assert float(s.detach().min()) > 0 and float(s.detach().max()) < 1
        _law(s, A / (A + B), A * B / ((A + B) ** 2 * (A + B + 1)))
        s.mean(0).sum().backward()
        # d E[x] / d a = b / (a + b)^2, d / d b = -a / (a + b)^2
        np.testing.assert_allclose(_np(a.grad), B / (A + B) ** 2, rtol=0.05)
        np.testing.assert_allclose(_np(b.grad), -A / (A + B) ** 2,
                                   rtol=0.05)

    def test_dirichlet_sample_law_and_pathwise_gradient(self):
        rng.seed(6)
        c = torch.tensor(CONC, dtype=torch.float32, requires_grad=True)
        s = D.Dirichlet(c).sample((40000,))
        assert tuple(s.shape) == (40000, 2, 3)
        np.testing.assert_allclose(_np(s).sum(-1), 1.0, rtol=1e-5)
        c0 = CONC.sum(-1, keepdims=True)
        _law(s, CONC / c0, CONC * (c0 - CONC) / (c0 ** 2 * (c0 + 1)))
        s[..., 0].mean(0).sum().backward()
        # d E[x_0] / d c_j = (delta_0j c0 - c_0) / c0^2
        want = (np.eye(3)[0] * c0 - CONC[:, :1]) / c0 ** 2
        np.testing.assert_allclose(_np(c.grad), want, rtol=0.1,
                                   atol=2e-3)

    def test_small_shape_gamma_draws(self):
        """Shapes below 1 take the boost: ``G(a + 1) · U ** (1 / a)``."""
        rng.seed(8)
        a = np.array([0.2, 0.9])
        s = D.Beta(a, a).sample((40000,))
        _law(s, 0.5, a * a / ((2 * a) ** 2 * (2 * a + 1)))


class TestTransforms:
    CASES = [
        ("ExpTransform", (), np.array([-1.0, 0.5, 2.0])),
        ("SigmoidTransform", (), np.array([-2.0, 0.0, 3.0])),
        ("TanhTransform", (), np.array([-1.5, 0.0, 1.2])),
        ("AffineTransform", (np.array(1.0), np.array(2.5)),
         np.array([-1.0, 0.0, 2.0])),
        ("PowerTransform", (np.array(2.0),), np.array([0.5, 1.0, 2.0])),
        ("AbsTransform", (), np.array([-2.0, 3.0, 0.5])),
        ("SoftmaxTransform", (), np.array([0.1, 1.0, 2.0])),
        ("StickBreakingTransform", (), np.array([0.3, -0.4, 0.2])),
    ]

    @pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
    def test_matches_jax(self, case):
        name, args, x = case
        jt, pt = getattr(JD, name)(*args), getattr(D, name)(*args)
        jy = jt.forward(paddle.to_tensor(x))
        py = pt.forward(x)
        _close(py, jy)
        _close(pt.inverse(py), jt.inverse(jy))
        if name not in ("AbsTransform", "SoftmaxTransform"):
            _close(pt.forward_log_det_jacobian(x),
                   jt.forward_log_det_jacobian(paddle.to_tensor(x)))
            _close(pt.inverse_log_det_jacobian(py),
                   jt.inverse_log_det_jacobian(jy))
        assert pt._is_injective() == jt._is_injective()
        assert pt.forward_shape((5, 3)) == jt.forward_shape((5, 3))

    def test_ldj_gradient(self):
        x = np.array([0.3, -0.4, 0.2])
        jx = paddle.to_tensor(x, stop_gradient=False)
        px = torch.tensor(x, dtype=torch.float32, requires_grad=True)
        JD.StickBreakingTransform().forward_log_det_jacobian(jx).sum() \
            .backward()
        D.StickBreakingTransform().forward_log_det_jacobian(px).sum() \
            .backward()
        _close(px.grad, jx.grad)

    def test_chain_reshape_stack_independent(self):
        x = np.array([0.5, 1.0])
        mk = lambda M: M.ChainTransform([  # noqa: E731
            M.AffineTransform(np.array(0.0), np.array(2.0)),
            M.ExpTransform()])
        jc, pc = mk(JD), mk(D)
        _close(pc.forward(x), jc.forward(paddle.to_tensor(x)))
        _close(pc.inverse(pc.forward(x)), x)
        _close(pc.forward_log_det_jacobian(x),
               jc.forward_log_det_jacobian(paddle.to_tensor(x)))
        _close(pc.inverse_log_det_jacobian(pc.forward(x)),
               jc.inverse_log_det_jacobian(jc.forward(paddle.to_tensor(x))))
        z = np.arange(6.0).reshape(2, 3)
        jr, pr = JD.ReshapeTransform((2, 3), (3, 2)), \
            D.ReshapeTransform((2, 3), (3, 2))
        _close(pr.forward(z), jr.forward(paddle.to_tensor(z)))
        _close(pr.forward_log_det_jacobian(z),
               jr.forward_log_det_jacobian(paddle.to_tensor(z)))
        assert pr.forward_shape((7, 2, 3)) == (7, 3, 2)
        with pytest.raises(ValueError):
            D.ReshapeTransform((2, 3), (4, 2))
        v = np.array([[1.0, 2.0], [3.0, 4.0]])
        mk = lambda M: M.StackTransform([  # noqa: E731
            M.ExpTransform(),
            M.AffineTransform(np.array(0.0), np.array(3.0))], axis=0)
        js, ps = mk(JD), mk(D)
        _close(ps.forward(v), js.forward(paddle.to_tensor(v)))
        _close(ps.inverse(ps.forward(v)), v)
        _close(ps.forward_log_det_jacobian(v),
               js.forward_log_det_jacobian(paddle.to_tensor(v)))
        ji = JD.IndependentTransform(JD.ExpTransform(), 1)
        pi = D.IndependentTransform(D.ExpTransform(), 1)
        _close(pi.forward_log_det_jacobian(v),
               ji.forward_log_det_jacobian(paddle.to_tensor(v)))
        _close(pi.inverse_log_det_jacobian(pi.forward(v)),
               ji.inverse_log_det_jacobian(ji.forward(paddle.to_tensor(v))))

    def test_chain_injective_nested(self):
        inner = D.ChainTransform([D.AbsTransform()])
        outer = D.ChainTransform([inner, D.ExpTransform()])
        assert not inner._is_injective() and not outer._is_injective()
        assert isinstance(D.ExpTransform()(D.TanhTransform()),
                          D.ChainTransform)


class TestComposedDistributions:
    def test_independent(self):
        loc = np.zeros((4, 3))
        jb, pb = JD.Normal(loc, np.ones((4, 3))), D.Normal(loc,
                                                          np.ones((4, 3)))
        ji, pi = JD.Independent(jb, 1), D.Independent(pb, 1)
        assert pi.batch_shape == ji.batch_shape == (4,)
        assert pi.event_shape == ji.event_shape == (3,)
        v = np.random.RandomState(0).randn(4, 3)
        _close(pi.log_prob(v), ji.log_prob(v))
        _close(pi.entropy(), ji.entropy())
        with pytest.raises(ValueError):
            D.Independent(pb, 3)

    def test_transformed_lognormal(self):
        jl = JD.TransformedDistribution(JD.Normal(0.0, 1.0),
                                        [JD.ExpTransform()])
        pl = D.TransformedDistribution(D.Normal(0.0, 1.0),
                                       [D.ExpTransform()])
        for v in (2.0, 0.3):
            _close(pl.log_prob(v), jl.log_prob(paddle.to_tensor(v)))
        rng.seed(21)
        s = _np(pl.sample((20000,)))
        assert (s > 0).all()
        _law(torch.from_numpy(np.log(s))[:, None], 0.0, 1.0)

    def test_transformed_event_dims(self):
        base = np.zeros((2, 3))
        mk = lambda M: M.TransformedDistribution(  # noqa: E731
            M.Normal(base, np.ones((2, 3))), [M.StickBreakingTransform()])
        jt, pt = mk(JD), mk(D)
        assert pt.batch_shape == jt.batch_shape
        assert pt.event_shape == jt.event_shape
        y = np.array([[0.2, 0.3, 0.1, 0.4], [0.25, 0.25, 0.25, 0.25]])
        _close(pt.log_prob(y), jt.log_prob(paddle.to_tensor(y)))

    def test_kl_dispatch_subclass_and_missing(self):
        class MyNormal(D.Normal):
            pass

        _close(D.kl_divergence(MyNormal(0.0, 1.0), D.Normal(0.0, 1.0)),
               np.zeros(()))
        with pytest.raises(NotImplementedError):
            D.kl_divergence(D.Normal(0.0, 1.0),
                            D.Multinomial(3, np.array([0.5, 0.5])))

    def test_register_kl_prefers_the_closest_pair(self):
        from paddle_tpu_torch.distribution import kl as pkl

        class MyBeta(D.Beta):
            pass

        @D.register_kl(MyBeta, D.Beta)
        def _mine(p, q):
            return torch.tensor(42.0)

        try:
            assert float(D.kl_divergence(MyBeta(2.0, 3.0),
                                         D.Beta(2.0, 3.0))) == 42.0
            assert float(D.kl_divergence(D.Beta(2.0, 3.0),
                                         MyBeta(2.0, 3.0))) < 1e-6
        finally:
            del pkl._REGISTER_TABLE[MyBeta, D.Beta]

    def test_entropy_gradient_through_bregman(self):
        c = np.array([2.0, 3.0, 4.0])
        jc = paddle.to_tensor(c, stop_gradient=False)
        pc = torch.tensor(c, dtype=torch.float32, requires_grad=True)
        JD.ExponentialFamily.entropy(JD.Dirichlet(jc)).backward()
        D.ExponentialFamily.entropy(D.Dirichlet(pc)).backward()
        _close(pc.grad, jc.grad)
        assert not D.ExponentialFamily.entropy(
            D.Dirichlet(c)).requires_grad
