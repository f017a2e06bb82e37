"""The port's train step against the JAX package's, on the CPU: the slice
as a whole.

The JAX side composes the step that ``bench.py`` times (:173-199), eagerly
and without the fleet wrappers (identity on one device): ``gpt_tiny``,
``AdamW(learning_rate=1e-4)``, ``amp.decorate`` O2 (not at O1 or O0),
``auto_cast`` at the level, ``compute_loss``, backward, step, clear.  The port runs
``build_train_step("tiny", device="cpu")`` with the JAX model's weights
carried in by ``from_jax_state_dict``, on the same batch.  Three steps.

Tolerances.  One slice of parameters is held apart: the key part of
``qkv_proj.bias``.  Its gradient is zero in exact arithmetic (softmax
ignores a constant added to a row of scores), so both frameworks hand
AdamW rounding noise (~1e-10), which AdamW turns into a step of up to
about lr of either sign (``lr * m_hat / (sqrt(v_hat) + eps)``); the two
runs may part by 2 lr per step there, and that is the bound it is held
to.

- f32 (O0): losses 1e-5 relative, every other parameter 1e-6 absolute
  (measured: losses 1e-7, parameters 7.1e-7).
- bf16 (O2): the frameworks round to bf16 at other points inside the
  layers (JAX's tanh-gelu and attention oracle round each intermediate,
  torch's kernels round once), so the gradients differ by bf16 noise
  and AdamW's normalised step turns a flipped small gradient into up to
  ~2 lr.  Losses 2e-3 relative (measured 1.4e-4); the f32 masters 2 lr
  per step per element, and 0.1 lr on the mean of each tensor (measured:
  at most 1.9 lr and 0.06 lr).
- bf16 (O1: f32 parameters, the per-op policy casting each linear's and
  embedding's weights to bf16): the O2 bounds, on the f32 parameters
  themselves (there are no masters).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch import build_train_step
from paddle_tpu_torch.models import from_jax_state_dict

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded.  An earlier test file in the same
    worker may leave fleet's hybrid mesh set (model axis > 1), which
    sends ``compute_loss`` down the vocab-parallel path."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)

STEPS, BATCH, SEQ, LR = 3, 2, 16, 1e-4


def _key_bias(name, n):
    """Mask of the key slice of a head-major ``[H, 3*D]`` qkv bias."""
    mask = np.zeros(n, bool)
    if name.endswith("qkv_proj.bias"):
        mask.reshape(4, 3, -1)[:, 1] = True      # gpt_tiny: 4 heads
    return mask


def _jax_steps(level, x, y):
    paddle.seed(0)
    model = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    state = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    if level == "O2":
        model, opt = paddle.amp.decorate(model, optimizers=opt, level="O2")
    losses = []
    for _ in range(STEPS):
        with paddle.amp.auto_cast(dtype="bfloat16", level=level):
            loss = model.compute_loss(paddle.to_tensor(x),
                                      paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    masters = {}
    for name, p in model.named_parameters():
        accs = opt._accumulators.get(opt._param_key(p), {})
        src = accs["master_weight"] if "master_weight" in accs else p
        masters[name] = np.asarray(src.astype("float32").numpy())
    return state, losses, masters


@pytest.mark.parametrize("level", ["O0", "O2", "O1"])
def test_three_steps_match_the_jax_step(level):
    ts = build_train_step("tiny", batch=BATCH, seq=SEQ, device="cpu",
                          amp_level=level)
    x, y = ts.x.numpy(), ts.y.numpy()
    state, ref_losses, ref_params = _jax_steps(level, x, y)
    from_jax_state_dict(ts.model, state)    # rounds to bf16 as O2 casts
    losses = [ts.train_step(ts.x, ts.y).item() for _ in range(STEPS)]
    linear = {f"{n}.weight" for n, m in ts.model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    np.testing.assert_allclose(losses, ref_losses,
                               rtol=1e-5 if level == "O0" else 2e-3)
    assert losses[-1] < losses[0]
    for name, p in ts.model.named_parameters():
        master = ts.optimizer.state[p].get("master_weight", p)
        got = master.detach().float().numpy()
        diff = np.abs((got.T if name in linear else got) - ref_params[name])
        noise = _key_bias(name, diff.size).reshape(diff.shape)
        assert diff[noise].max(initial=0) <= 2 * STEPS * LR, name
        rest = diff[~noise]
        if level == "O0":
            assert rest.max() <= 1e-6, (name, rest.max())
        else:
            assert rest.max() <= 2 * STEPS * LR, (name, rest.max())
            assert rest.mean() <= 0.1 * LR, (name, rest.mean())


def test_batch_is_drawn_as_the_bench_draws_it():
    ts = build_train_step("tiny", batch=3, seq=8, device="cpu", seed=5)
    rs = np.random.RandomState(5)
    np.testing.assert_array_equal(ts.x.numpy(), rs.randint(0, 128, (3, 8)))
    np.testing.assert_array_equal(ts.y.numpy(), rs.randint(0, 128, (3, 8)))
    assert next(ts.model.parameters()).dtype == torch.bfloat16


def test_unported_levels_and_missing_card_raise():
    """O1, refused before it was ported, builds f32 parameters with no
    masters and trains (its parity is held above); an unknown level and a
    missing card raise."""
    ts = build_train_step("tiny", batch=2, seq=8, device="cpu",
                          amp_level="O1", to_static=False)
    assert {p.dtype for p in ts.model.parameters()} == {torch.float32}
    losses = [ts.train_step(ts.x, ts.y).item() for _ in range(3)]
    assert losses[-1] < losses[0]
    assert not any("master_weight" in st
                   for st in ts.optimizer.state.values())
    with pytest.raises(ValueError, match="O3"):
        build_train_step("tiny", device="cpu", amp_level="O3")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_train_step("tiny")
