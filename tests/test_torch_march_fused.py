"""Port parity: the CUDA fused march's plain version (the kernel wrapper's
CPU path) against the JAX Pallas fused march in interpret mode, on the
JAX kernel's budget and grouping cases (test_torch_march.py defines them;
test_torch_march_flags.py holds the flag and layout cases)."""
import pytest

from test_torch_march import _jax_march, check_case, port_march


@pytest.mark.parametrize("name", ["budget_below_chunk", "ragged_budgets",
                                  "group3", "saturated_block"])
def test_fused_march_matches_pallas(name):
    want, params = _jax_march(name, "fused")
    check_case(name, port_march(name, "fused", params), want)
