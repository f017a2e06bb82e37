"""K4's split-K plan and argument checks, on the CPU.

The card's kernel (``csrc/paged_attention.cu`` ``paged_decode_kernel``)
cuts each slot's window into splits of ``split_keys`` positions and merges
the live splits in split order; its launch comes from
:func:`kernels.decode_plan`, pure Python on the shapes alone, which is
checked here for what the launch relies on.  The kernel's results are
held against the plain version on the card (tests/test_torch_cuda.py);
the plain version is held against the Pallas ``_decode_kernel`` in
tests/test_torch_attention.py.
"""
import pytest
import torch

from paddle_tpu_torch.ops import kernels


@pytest.mark.parametrize("B,H,Hkv,MB,bs", [(8, 32, 32, 256, 16),
                                           (8, 64, 8, 256, 16),
                                           (1, 32, 32, 256, 16),
                                           (32, 32, 32, 128, 16),
                                           (3, 4, 4, 5, 32),
                                           (2, 8, 1, 1, 8)])
def test_decode_plan_covers_the_table_from_shapes_alone(B, H, Hkv, MB, bs):
    """The splits cover the whole table (a length past it attends all of
    it), the grid is capped near DECODE_GRID_BLOCKS without dropping a
    split, and the scratch holds one partial per (slot, head, split)."""
    plan = kernels.decode_plan(B, H, Hkv, 128, MB, bs)
    P = plan.split_keys
    assert P == (kernels.DECODE_SPLIT_KEYS if H == Hkv
                 else kernels.DECODE_SPLIT_KEYS // 2)
    assert plan.splits * P >= MB * bs > (plan.splits - 1) * P \
        or plan.splits == 1
    assert 1 <= plan.grid_splits <= plan.splits
    blocks = B * Hkv * plan.grid_splits
    assert blocks <= max(kernels.DECODE_GRID_BLOCKS + B * Hkv,
                         B * Hkv)
    assert plan.grid_splits == plan.splits or \
        blocks >= kernels.DECODE_GRID_BLOCKS
    assert plan.partial_shape == (B, H, plan.splits, 128)
    assert plan.ml_shape == (B, H, plan.splits, 2)
    assert plan.tickets == B * Hkv


@pytest.mark.parametrize("B,H,Hkv,MB,want", [
    (8, 32, 32, 256, (512, 8, 8)),       # the main path's shape
    (8, 64, 8, 256, (256, 16, 16)),      # GQA: splits of 256
    (32, 32, 32, 128, (512, 4, 2)),      # 32 slots: two splits a block
    (2, 32, 32, 2048, (512, 64, 32)),    # a 32768-position table
])
def test_decode_plan_at_the_timed_shapes(B, H, Hkv, MB, want):
    """(split_keys, splits, grid_splits) at the shapes chip_smoke.py
    times, block size 16: where the grid is capped, a block walks
    ``splits / grid_splits`` splits."""
    plan = kernels.decode_plan(B, H, Hkv, 128, MB, 16)
    assert (plan.split_keys, plan.splits, plan.grid_splits) == want


def _rows(dtype, width, layers=2):
    """A strided one-layer view ``[4, 16, 2, 64]`` of a pool whose rows
    are ``width`` elements apart."""
    return torch.zeros(4, layers, 16, 2, width, dtype=dtype)[:, 1, ..., :64]


@pytest.mark.parametrize("dtype,width,ok", [
    (torch.float32, 64, True), (torch.float32, 66, False),
    (torch.bfloat16, 72, True), (torch.bfloat16, 68, False)])
def test_decode_rows16_check_in_both_dtypes(dtype, width, ok):
    """K4 copies rows in 16-byte pieces in f32 as in bf16: a row stride
    that is not a multiple of 16 bytes is refused, a strided one-layer
    view of an aligned pool is taken."""
    pool = _rows(dtype, width)
    if ok:
        kernels._check_rows16("paged_decode", pool,
                              dtypes=(torch.float32, torch.bfloat16))
    else:
        with pytest.raises(ValueError, match="16-byte"):
            kernels._check_rows16("paged_decode", pool,
                                  dtypes=(torch.float32, torch.bfloat16))


def test_paged_decode_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises: CPU tensors go to the
    plain version in ``cached_attention.paged_decode_attention``, never
    through ``kernels.paged_decode``, which counts no launch for them."""
    q = torch.zeros(1, 1, 2, 64)
    pool = _rows(torch.float32, 64)
    tbl = torch.ones(1, 2, dtype=torch.int32)
    lens = torch.zeros(1, dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.paged_decode(q, pool, pool, tbl, lens)
    assert kernels.KERNELS["paged_decode"].launches == 0
