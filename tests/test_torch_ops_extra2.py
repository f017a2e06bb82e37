"""The second half (by name) of ``tests/test_op_suite_extra.py``'s rows on
the port against the JAX ops (``tests/test_torch_ops_extra.py`` runs the
first)."""
import pytest

from test_torch_ops import _single_device, check_row  # noqa: F401
from test_torch_ops_extra import HALF, NAMES


@pytest.mark.parametrize("name", NAMES[HALF:])
def test_row_matches_jax(name):
    check_row(name)
