"""Port parity: the CUDA fused march's plain version against the JAX
Pallas fused march in interpret mode, on the flag and layout cases:
pad blocks, density-only, an odd level count, per-ray early exit."""
import pytest

from test_torch_march import _jax_march, check_case, port_march


@pytest.mark.parametrize("name", ["pad_blocks", "density_only", "odd_levels",
                                  "per_ray_early_exit"])
def test_fused_march_flags_match_pallas(name):
    want, params = _jax_march(name, "fused")
    check_case(name, port_march(name, "fused", params), want)
