"""The rebuilt density and march kernels on the card: each held to its
plain version bit for bit on small inputs, and their launchers asking for
the shared memory the wrappers reckon.  Marked ``gpu``: they skip without
a CUDA device and run on a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_march as FMA
from repro_torch.kernels import fused_mlp as FM
from test_torch_march_tiles import (CASES, PAPER_COLOR, PAPER_DENSITY,
                                    _march_inputs)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only "
                    "there)")
    return torch.device("cuda")


def test_launchers_ask_for_the_reckoned_shared_memory(cuda):
    assert FM.density_launch_smem(PAPER_DENSITY) == FM.density_smem_bytes(
        PAPER_DENSITY)
    for S, chunk, L in ((16, 32, 16), (0, 32, 16), (16, 64, 5), (9, 7, 8)):
        assert FMA.launch_smem(PAPER_DENSITY, PAPER_COLOR, S, chunk, L) == \
            FMA.smem_bytes(PAPER_DENSITY, PAPER_COLOR, S, chunk, L)


def test_density_mlp_matches_plain(cuda):
    rng = np.random.default_rng(3)
    dims = PAPER_DENSITY
    enc = rng.normal(0, 2, (1000, dims[0])).astype(np.float32)
    w = rng.normal(0, 0.3, FM.chain_size(dims)).astype(np.float32)
    enc, w = torch.from_numpy(enc).to(cuda), torch.from_numpy(w).to(cuda)
    got = FM.density_mlp(enc, w, dims)
    assert torch.equal(got, FM.density_mlp_plain(enc, w, dims))


@pytest.mark.parametrize("name", list(CASES))
def test_fused_march_matches_plain(name, cuda):
    args, kw = _march_inputs(name, table_scale=30.0)
    args = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    got = FMA.fused_march(*args, **kw)
    assert torch.equal(got, FMA.fused_march_plain(*args, **kw))
