"""The rows of ``tests/test_op_suite_extra.py`` on the port against the
JAX ops, as ``tests/test_torch_ops.py`` runs ``tests/test_op_suite.py``'s
(its ``check_row``: the row's stated ``rtol``/``atol`` forward, the port's
autograd against the JAX tape at ``GRAD_RTOL``/``GRAD_ATOL``): the first
half by name here, the second in ``tests/test_torch_ops_extra2.py`` (the
JAX ops' first calls compile, and each file stays within a worker's
share)."""
import pytest

from test_op_suite_extra import SPECS2
from test_torch_ops import _single_device, check_row  # noqa: F401

NAMES = sorted(s.name for s in SPECS2)
HALF = len(NAMES) // 2


@pytest.mark.parametrize("name", NAMES[:HALF])
def test_row_matches_jax(name):
    check_row(name)
