"""TensoRF VM-192 on the ASDR frame.

``CONFIG`` holds TensoRF's published lego settings (``configs/lego.txt``
of the official code: a 300^3 final grid, 16 + 48 components on each of
the three plane / line pairs, 27 appearance features, the 150 -> 128 ->
128 -> 3 ``MLP_Fea`` renderer) with ``ingp-asdr``'s ASDR settings at
800x800; ``SMOKE`` a CPU-sized reduction.
"""
import dataclasses

from repro_torch.core.pipeline import ASDRConfig
from repro_torch.core.tensorf import TensoRFConfig


@dataclasses.dataclass(frozen=True)
class TensoRFBundle:
    name: str
    model: TensoRFConfig
    asdr: ASDRConfig
    image_hw: tuple


CONFIG = TensoRFBundle(
    name="tensorf-vm",
    model=TensoRFConfig(),
    asdr=ASDRConfig(ns_full=192, probe_stride=5, delta=1.0 / 2048.0,
                    group=2, block_size=4096, chunk=32,
                    march_backend="fused"),
    image_hw=(800, 800),
)

SMOKE = TensoRFBundle(
    name="tensorf-vm-smoke",
    model=TensoRFConfig(resolution=(16, 16, 16),
                        density_components=(4, 4, 4),
                        app_components=(8, 8, 8), app_dim=5, hidden=16),
    asdr=ASDRConfig(ns_full=64, probe_stride=4, group=2, block_size=64,
                    chunk=16, candidates=(8, 16, 32), march_backend="fused"),
    image_hw=(32, 32),
)
