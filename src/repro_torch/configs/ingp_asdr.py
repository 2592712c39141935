"""The paper's own model: Instant-NGP + ASDR two-phase rendering.

``CONFIG`` is the paper-scale setup (2^19 tables, 16 levels, 192 samples,
paper MLP split 8%/92%); ``SMOKE`` the CPU-sized reduction.  Same numbers
as ``repro/configs/ingp_asdr.py``.
"""
import dataclasses

from repro_torch.core.model import NGPConfig
from repro_torch.core.pipeline import ASDRConfig


@dataclasses.dataclass(frozen=True)
class NGPBundle:
    name: str
    model: NGPConfig
    asdr: ASDRConfig
    image_hw: tuple
    train_batch_rays: int


CONFIG = NGPBundle(
    name="ingp-asdr",
    model=NGPConfig.make(paper_mlp=True),
    asdr=ASDRConfig(ns_full=192, probe_stride=5, delta=1.0 / 2048.0,
                    group=2, block_size=4096, chunk=32),
    image_hw=(800, 800),
    train_batch_rays=1 << 18,
)

SMOKE = NGPBundle(
    name="ingp-asdr-smoke",
    model=NGPConfig.small(),
    asdr=ASDRConfig(ns_full=64, probe_stride=4, group=2,
                    block_size=64, chunk=16, candidates=(8, 16, 32)),
    image_hw=(48, 48),
    train_batch_rays=512,
)
