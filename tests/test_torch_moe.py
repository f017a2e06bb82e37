"""The port's MoE layer and gates, expert parallelism and ``SyncBatchNorm``
on gloo worlds, and the slice as a whole, against the JAX package's, on
the CPU.

Spec: ``tests/test_moe.py`` (gates, dense equivalence, gradient flow,
capacity overflow, structural check) and, beyond it, what the JAX layer
on the whole batch gives when the port's ranks each hold a shard of the
batch and of the experts:

- **one process**: the same numpy weights and inputs through both
  packages' layers; outputs and every gradient within 1e-5 (the same f32
  math, summed in another order), the same choices dropped;
- **expert parallelism** on gloo worlds of 2 and 4 (:mod:`torch_world`):
  each rank's ``MoELayer`` holds its experts and its shard of the batch,
  ``moe_group`` the world; the GShard gate (random routing off, which
  draws differently in the two packages) at a capacity that drops
  tokens.  Each rank's loss is ``sum(out * w_rank) + l_aux / ranks``, so
  the ranks' losses add up to the JAX loss on the whole batch: the
  concatenated outputs and input gradients, ``l_aux`` on every rank, each
  expert's gradient on its owner and the gate's summed over the ranks
  agree with the JAX layer's within 1e-5;
- **SyncBatchNorm** on the world of 2: each rank's half of ``[8, 4, 5,
  5]``; outputs, running ``_mean`` and ``_variance`` (the same on both
  ranks) and gradients against the JAX layer on the whole batch, within
  1e-5 (ROADMAP C's 0.198 before the fix); on no world it is
  ``BatchNorm``, bitwise;
- **the slice**: a 2-layer pre-LN transformer (hidden 32, 4 heads, an
  ``MoELayer`` of 4 experts with a ``PyLayer`` GeLU in the second layer's
  FFN, GShard top-2 with random routing off) under ``LookAhead(AdamW)``
  trains 3 steps on both packages from one numpy state dict carried by
  ``models.port_state_dict_from_jax``: losses within 1e-5 relative and
  weights within 1e-5.
"""
import math
import os
import pickle
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from torch_world import get, run_world, scenario  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-5
D, HID = 8, 16


# -- the port's side (also what the world's workers run) ----------------------

def _gelu_backward(x, g):
    cdf = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
    return g * (cdf + x * pdf)


def _port_gelu():
    from paddle_tpu_torch.autograd import PyLayer

    class GeLU(PyLayer):
        """GeLU with a hand-written backward."""

        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.nn.functional.gelu(x)

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensor()
            return _gelu_backward(x, g)

    return GeLU


def _port_expert(d=D, h=HID):
    from paddle_tpu_torch import nn

    gelu = _port_gelu()

    class Expert(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(d, h, device="cpu")
            self.fc2 = nn.Linear(h, d, device="cpu")

        def forward(self, x):
            return self.fc2(gelu.apply(self.fc1(x)))

    return Expert()


def _port_moe(sd, num_expert, gate, cap, group=None, rank=0, ranks=1):
    """The port's layer holding rank ``rank``'s share of the JAX state."""
    from paddle_tpu_torch import device
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        GShardGate, MoELayer,
    )
    from paddle_tpu_torch.models import from_jax_state_dict

    el = num_expert // ranks
    with device.device_guard("cpu"):
        if gate == "gshard":
            gate = GShardGate(D, num_expert, random_routing=False)
        m = MoELayer(D, [_port_expert() for _ in range(el)], gate=gate,
                     moe_group=group, capacity_factor=cap)
    local = {}
    for k, v in sd.items():
        if k.startswith("experts."):
            _, i, rest = k.split(".", 2)
            i = int(i) - rank * el
            if not 0 <= i < el:
                continue
            k = f"experts.{i}.{rest}"
        local[k] = v
    return from_jax_state_dict(m, local)


def _grads_jax_layout(m) -> dict:
    linear = {n for n, mod in m.named_modules()
              if isinstance(mod, torch.nn.Linear)}
    out = {}
    for n, p in m.named_parameters():
        g = p.grad.numpy()
        out[n] = g.T if n.rpartition(".")[0] in linear and g.ndim == 2 else g
    return out


def _ep_scenario(inputs, rank, ranks):
    from paddle_tpu_torch.distributed import collective

    group = collective.new_group(list(range(ranks)))
    m = _port_moe(inputs["sd"], inputs["E"], "gshard", inputs["cap"],
                  group=group, rank=rank, ranks=ranks)
    n = inputs["x"].shape[0] // ranks
    x = torch.from_numpy(inputs["x"][rank * n:(rank + 1) * n]) \
        .requires_grad_()
    w = torch.from_numpy(inputs["w"][rank * n:(rank + 1) * n])
    out = m(x)
    ((out * w).sum() + m.l_aux / ranks).backward()
    return {"out": out.detach().numpy(), "l_aux": float(m.l_aux),
            "x_grad": x.grad.numpy(), "grads": _grads_jax_layout(m),
            "dropped": int(m.dropped_tokens), "el": m.num_local_expert}


def _sync_bn_scenario(inputs, rank, ranks):
    from paddle_tpu_torch import device, nn

    with device.device_guard("cpu"):
        bn = nn.SyncBatchNorm(4)
    n = inputs["bn_x"].shape[0] // ranks
    x = torch.from_numpy(inputs["bn_x"][rank * n:(rank + 1) * n]) \
        .requires_grad_()
    out = bn(x)
    (out * torch.from_numpy(inputs["bn_w"][rank * n:(rank + 1) * n])) \
        .sum().backward()
    return {"out": out.detach().numpy(), "mean": bn._mean.numpy(),
            "var": bn._variance.numpy(), "x_grad": x.grad.numpy(),
            "w_grad": bn.weight.grad.numpy(), "b_grad": bn.bias.grad.numpy()}


def _worker(rank: int, world: int, workdir: str) -> dict:
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}
    scenario(res, "ep", _ep_scenario, inputs, rank, world)
    if world == 2:
        scenario(res, "sync_bn", _sync_bn_scenario, inputs, rank, world)
    return res


# -- the JAX side -------------------------------------------------------------

@pytest.fixture(autouse=True)
def _single_device():
    from paddle_tpu.distributed import mesh as mesh_mod

    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _jax_expert_cls(d=D, h=HID):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn

    class Expert(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(d, h)
            self.fc2 = jnn.Linear(h, d)

        def forward(self, x):
            return self.fc2(paddle.nn.functional.gelu(self.fc1(x)))

    return Expert


def _jax_moe(num_expert, gate, cap, seed=0):
    import paddle_tpu as paddle
    from paddle_tpu.incubate.distributed.models.moe import (
        GShardGate, MoELayer,
    )

    paddle.seed(seed)
    expert = _jax_expert_cls()
    if gate == "gshard":
        gate = GShardGate(D, num_expert, random_routing=False)
    return MoELayer(d_model=D, experts=[expert() for _ in range(num_expert)],
                    gate=gate, capacity_factor=cap)


def _sd(layer) -> dict:
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _run_jax(m, x, w, aux_weight=1.0):
    import paddle_tpu as paddle

    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    out = m(jx)
    loss = (out * paddle.to_tensor(w)).sum()
    if m.l_aux is not None:
        loss = loss + aux_weight * m.l_aux
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in m.named_parameters()
             if p.grad is not None}
    aux = None if m.l_aux is None else float(m.l_aux)
    return np.asarray(out.numpy()), aux, np.asarray(jx.grad.numpy()), grads


def _run_port(m, x, w):
    tx = torch.from_numpy(x).requires_grad_()
    out = m(tx)
    loss = (out * torch.from_numpy(w)).sum()
    if m.l_aux is not None:
        loss = loss + m.l_aux
    loss.backward()
    aux = None if m.l_aux is None else float(m.l_aux)
    return out.detach().numpy(), aux, tx.grad.numpy(), _grads_jax_layout(m)


def _inputs(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, D).astype(np.float32), rs.randn(n, D).astype(np.float32)


def _pair(num_expert, gate, cap):
    jm = _jax_moe(num_expert, gate, cap)
    tm = _port_moe(_sd(jm), num_expert,
                   gate if isinstance(gate, str) else dict(gate), cap)
    return jm, tm


def _compare(jax_res, port_res):
    jo, ja, jg, jgrads = jax_res
    to, ta, tg, tgrads = port_res
    np.testing.assert_allclose(to, jo, atol=ATOL)
    if ja is not None:
        assert abs(ta - ja) < ATOL
    np.testing.assert_allclose(tg, jg, atol=ATOL)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], atol=ATOL,
                                   err_msg=n)


class TestGates:
    @pytest.mark.parametrize("kind", ["naive", "gshard", "switch"])
    def test_gate_matches_jax(self, kind):
        import paddle_tpu as paddle
        from paddle_tpu.incubate.distributed.models import moe as jmoe

        from paddle_tpu_torch import device
        from paddle_tpu_torch.incubate.distributed.models import moe

        cls = {"naive": "NaiveGate", "gshard": "GShardGate",
               "switch": "SwitchGate"}[kind]
        kw = {"random_routing": False} if kind == "gshard" else {}
        paddle.seed(0)
        jg = getattr(jmoe, cls)(8, 4, **kw)
        with device.device_guard("cpu"):
            tg = getattr(moe, cls)(8, 4, **kw)
        from paddle_tpu_torch.models import from_jax_state_dict

        from_jax_state_dict(tg, _sd(jg))
        x = np.random.RandomState(0).randn(32, 8).astype(np.float32)
        jx = paddle.to_tensor(x)
        jval, jidx = jg(jx)
        tval, tidx = tg(torch.from_numpy(x))
        np.testing.assert_allclose(tval.detach().numpy(),
                                   np.asarray(jval.numpy()),
                                   atol=1e-6)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx.numpy()))
        if kind == "naive":
            assert tg.get_loss() is None and jg.get_loss() is None
            return
        jaux, taux = jg.get_loss(), tg.get_loss()
        assert abs(float(taux) - float(jaux)) < 1e-6
        assert float(taux) >= 0.99
        jaux.backward()
        taux.backward()
        np.testing.assert_allclose(tg.gate.weight.grad.numpy().T,
                                   np.asarray(jg.gate.weight.grad.numpy()),
                                   atol=1e-6)

    def test_gshard_random_routing_law(self):
        """The second expert is kept with probability min(1, 2 w2)."""
        from paddle_tpu_torch import device, rng
        from paddle_tpu_torch.incubate.distributed.models.moe import \
            GShardGate

        rng.seed(0)
        with device.device_guard("cpu"):
            g = GShardGate(8, 4)
        x = torch.randn(4000, 8, generator=torch.Generator().manual_seed(1))
        g.eval()
        _, _ = g(x)
        w2 = g(x)[0][:, 1]
        g.train()
        kept = (g(x)[0][:, 1] > 0).float()
        want = torch.clamp(2 * w2, max=1.0)
        assert abs(kept.mean().item() - want.mean().item()) < 0.03
        assert g.capacity_factor(True) == 1.2
        assert g.capacity_factor(False) == 2.4


class TestMoELayer:
    def test_dense_equivalence_single_expert(self):
        jm, tm = _pair(1, {"type": "naive", "top_k": 1}, 4.0)
        x = np.random.RandomState(0).randn(24, D).astype(np.float32)
        out = tm(torch.from_numpy(x)).detach().numpy()
        dense = tm.experts[0](torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(out, dense, atol=ATOL)
        import paddle_tpu as paddle

        np.testing.assert_allclose(
            out, np.asarray(jm(paddle.to_tensor(x)).numpy()), atol=ATOL)

    @pytest.mark.parametrize("gate,cap", [
        ({"type": "naive", "top_k": 2}, 4.0), ("gshard", 2.0),
        ({"type": "switch"}, 1.2)])
    def test_outputs_and_every_gradient_match_jax(self, gate, cap):
        jm, tm = _pair(4, gate, cap)
        x, w = _inputs(32, 1)
        _compare(_run_jax(jm, x, w), _run_port(tm, x, w))
        if cap == 4.0:              # nothing dropped: every expert used
            for e in tm.experts:
                assert float(e.fc1.weight.grad.abs().sum()) > 0
        assert tm.gate.gate.weight.grad is not None

    def test_overflow_drops_the_same_tokens_as_jax(self):
        """C = ceil(2 * 32 / 4 * 0.5) = 8 slots an expert for 64 choices:
        the same choices drop in both packages, so the outputs, including
        the rows that lost both choices (zeros), agree."""
        jm, tm = _pair(4, {"type": "naive", "top_k": 2}, 0.5)
        x, w = _inputs(32, 2)
        jres, tres = _run_jax(jm, x, w), _run_port(tm, x, w)
        _compare(jres, tres)
        assert int(tm.dropped_tokens) > 0
        zero_rows = np.abs(tres[0]).sum(-1) < 1e-7
        np.testing.assert_array_equal(zero_rows,
                                      np.abs(jres[0]).sum(-1) < 1e-7)

    def test_capacity_one_keeps_one_token_an_expert(self):
        jm, tm = _pair(2, {"type": "naive", "top_k": 1}, 2 / 16)
        x, _ = _inputs(16, 0)
        out = tm(torch.from_numpy(x)).detach().numpy()
        assert (np.abs(out).sum(-1) > 1e-7).sum() <= 2
        assert int(tm.dropped_tokens) >= 14

    def test_stacks_survive_amp_decorate_and_state_loads(self):
        """Each expert's parameter is a row of one stack; a cast gives the
        parameters new storage, and the next forward stacks them again."""
        from paddle_tpu_torch import amp

        jm, tm = _pair(4, {"type": "naive", "top_k": 2}, 4.0)
        x, _ = _inputs(8, 3)
        tm(torch.from_numpy(x))
        stack = tm._stacks["fc1.weight"]
        assert tm.experts[2].fc1.weight.data_ptr() == \
            stack[2].data_ptr()
        amp.decorate(tm, level="O2")
        assert not tm._stacked()
        out = tm(torch.from_numpy(x).bfloat16())
        assert out.dtype == torch.bfloat16 and tm._stacked()
        assert tm._stacks["fc1.weight"].dtype == torch.bfloat16

    def test_no_grad_forward_matches(self):
        jm, tm = _pair(4, {"type": "naive", "top_k": 2}, 1.0)
        x, _ = _inputs(16, 4)
        with_grad = tm(torch.from_numpy(x)).detach()
        with torch.no_grad():
            without = tm(torch.from_numpy(x))
        assert torch.equal(with_grad, without)

    def test_structurally_different_experts_rejected(self):
        from paddle_tpu_torch import device, nn
        from paddle_tpu_torch.incubate.distributed.models.moe import \
            MoELayer

        with device.device_guard("cpu"):
            a = nn.Sequential(nn.Linear(8, 8), nn.ReLU(), nn.Linear(8, 8))
            b = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 8))
            with pytest.raises(ValueError):
                MoELayer(d_model=8, experts=[a, b],
                         gate={"type": "naive", "top_k": 1})

    def test_sync_batch_norm_without_a_world_is_batch_norm(self):
        from paddle_tpu_torch import device, nn

        x = torch.from_numpy(np.random.RandomState(0).randn(
            8, 4, 5, 5).astype(np.float32))
        with device.device_guard("cpu"):
            a, b = nn.SyncBatchNorm(4), nn.BatchNorm2D(4)
        assert torch.equal(a(x), b(x))
        assert torch.equal(a._mean, b._mean)
        assert torch.equal(a._variance, b._variance)


# -- gloo worlds --------------------------------------------------------------

EP_TOKENS, EP_EXPERTS, EP_CAP = 16, 4, 0.5


def _world_inputs():
    jm = _jax_moe(EP_EXPERTS, "gshard", EP_CAP, seed=3)
    x, w = _inputs(EP_TOKENS, 5)
    rs = np.random.RandomState(0)
    bn_x = rs.randn(8, 4, 5, 5).astype(np.float32)
    bn_w = rs.randn(8, 4, 5, 5).astype(np.float32)
    return jm, {"sd": _sd(jm), "E": EP_EXPERTS, "cap": EP_CAP, "x": x,
                "w": w, "bn_x": bn_x, "bn_w": bn_w}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    jm, inputs = _world_inputs()
    handles = {}
    for n in (2, 4):
        workdir = str(tmp_path_factory.mktemp(f"moe_world{n}"))
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        handles[n] = run_world("test_torch_moe", "_worker", workdir, n)
    ref = _run_jax(jm, inputs["x"], inputs["w"])
    return {"inputs": inputs, "jax": ref,
            "res": {n: h.results() for n, h in handles.items()}}


@pytest.mark.parametrize("ranks", [2, 4])
def test_expert_parallel_matches_jax_on_the_whole_batch(worlds, ranks):
    jo, jaux, jxg, jgrads = worlds["jax"]
    per = [get(worlds["res"][ranks], "ep", r) for r in range(ranks)]
    np.testing.assert_allclose(np.concatenate([p["out"] for p in per]), jo,
                               atol=ATOL)
    np.testing.assert_allclose(np.concatenate([p["x_grad"] for p in per]),
                               jxg, atol=ATOL)
    for p in per:
        assert abs(p["l_aux"] - jaux) < ATOL
    assert sum(p["dropped"] for p in per) > 0          # tokens were dropped
    el = per[0]["el"]
    for r, p in enumerate(per):
        for name, g in p["grads"].items():
            if name.startswith("experts."):
                _, i, rest = name.split(".", 2)
                want = jgrads[f"experts.{int(i) + r * el}.{rest}"]
                np.testing.assert_allclose(g, want, atol=ATOL, err_msg=name)
    gate = sum(p["grads"]["gate.gate.weight"] for p in per)
    np.testing.assert_allclose(gate, jgrads["gate.gate.weight"], atol=ATOL)


def test_sync_batch_norm_matches_jax_on_the_whole_batch(worlds):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn

    inp = worlds["inputs"]
    paddle.seed(0)
    jbn = jnn.SyncBatchNorm(4)
    jx = paddle.to_tensor(inp["bn_x"])
    jx.stop_gradient = False
    jout = jbn(jx)
    (jout * paddle.to_tensor(inp["bn_w"])).sum().backward()
    per = [get(worlds["res"][2], "sync_bn", r) for r in range(2)]
    np.testing.assert_allclose(np.concatenate([p["out"] for p in per]),
                               np.asarray(jout.numpy()), atol=ATOL)
    np.testing.assert_allclose(np.concatenate([p["x_grad"] for p in per]),
                               np.asarray(jx.grad.numpy()), atol=ATOL)
    for p in per:
        np.testing.assert_allclose(p["mean"], np.asarray(jbn._mean.numpy()),
                                   atol=ATOL)
        np.testing.assert_allclose(p["var"],
                                   np.asarray(jbn._variance.numpy()),
                                   atol=ATOL)
    for key, jp in (("w_grad", jbn.weight), ("b_grad", jbn.bias)):
        np.testing.assert_allclose(per[0][key] + per[1][key],
                                   np.asarray(jp.grad.numpy()), atol=ATOL)


# -- the slice as a whole -----------------------------------------------------

V, S, H, HEADS, BATCH = 64, 8, 32, 4, 2


def _transformer(P, moe_mod, gelu, pylayer_experts: bool):
    """A 2-layer pre-LN causal LM from package ``P``'s public layers: the
    second layer's FFN an ``MoELayer`` of 4 experts."""
    nn, F = P.nn, P.nn.functional

    class Expert(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(H, 2 * H)
            self.fc2 = nn.Linear(2 * H, H)

        def forward(self, x):
            h = self.fc1(x)
            return self.fc2(gelu.apply(h) if pylayer_experts else F.gelu(h))

    class Block(nn.Layer):
        def __init__(self, moe: bool):
            super().__init__()
            self.ln1 = nn.LayerNorm(H)
            # no bias: a key bias has a zero gradient (softmax ignores a
            # row's shift), which Adam would turn into rounding noise
            self.qkv = nn.Linear(H, 3 * H, bias_attr=False)
            self.proj = nn.Linear(H, H)
            self.ln2 = nn.LayerNorm(H)
            if moe:
                self.ffn = moe_mod.MoELayer(
                    H, [Expert() for _ in range(4)],
                    gate=moe_mod.GShardGate(H, 4, random_routing=False))
            else:
                self.ffn = Expert()

        def forward(self, x):
            b, s = x.shape[0], x.shape[1]
            qkv = self.qkv(self.ln1(x)).reshape([b, s, 3, HEADS, H // HEADS])
            a = F.scaled_dot_product_attention(
                qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], is_causal=True)
            x = x + self.proj(a.reshape([b, s, H]))
            h = self.ln2(x)
            return x + self.ffn(h.reshape([b * s, H])).reshape([b, s, H])

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, H)
            self.pos = nn.Embedding(S, H)
            self.blocks = nn.LayerList([Block(False), Block(True)])
            self.ln_f = nn.LayerNorm(H)

        def forward(self, ids, labels):
            x = self.emb(ids) + self.pos.weight[:ids.shape[1]]
            for blk in self.blocks:
                x = blk(x)
            logits = P.matmul(self.ln_f(x), self.emb.weight,
                              transpose_y=True)
            loss = F.cross_entropy(logits.reshape([-1, V]),
                                   labels.reshape([-1]))
            return loss + 0.01 * self.blocks[1].ffn.l_aux

    return LM()


def test_moe_transformer_trains_as_jax():
    import paddle_tpu as paddle
    from paddle_tpu.autograd import PyLayer as JPyLayer
    from paddle_tpu.incubate.distributed.models import moe as jmoe

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import incubate, optimizer as popt
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.models import port_state_dict_from_jax

    class JGeLU(JPyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return paddle.nn.functional.gelu(x)

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensor()
            cdf = 0.5 * (1.0 + paddle.erf(x / math.sqrt(2.0)))
            pdf = paddle.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
            return g * (cdf + x * pdf)

    paddle.seed(0)
    jm = _transformer(paddle, jmoe, JGeLU, True)
    with pt.device_guard("cpu"):
        tm = _transformer(pt, moe, _port_gelu(), True)
    sd = port_state_dict_from_jax(tm, _sd(jm))
    tm.load_state_dict(sd)
    jopt = paddle.incubate.LookAhead(paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=jm.parameters()), alpha=0.5, k=2)
    topt = incubate.LookAhead(popt.AdamW(tm.parameters(), lr=1e-2),
                              alpha=0.5, k=2)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, V, (BATCH, S)).astype(np.int64)
    labels = rs.randint(0, V, (BATCH, S)).astype(np.int64)
    # the JAX forward and backward compiled once (eager, each op would
    # compile); its optimizer steps eagerly
    @paddle.jit.to_static
    def jgrads(x, y):
        loss = jm(x, y)
        loss.backward()
        return loss

    def jstep(x, y):
        loss = jgrads(x, y)
        jopt.step()
        jopt.clear_grad()
        return loss

    @pt.jit.to_static
    def tstep(x, y):
        loss = tm(x, y)
        loss.backward()
        topt.step()
        topt.clear_grad()
        return loss

    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels))))
        tl.append(float(tstep(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    final = port_state_dict_from_jax(tm, _sd(jm))
    for name, t in tm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), final[name].numpy(),
                                   atol=ATOL, err_msg=name)
