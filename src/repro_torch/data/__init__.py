"""Deterministic-by-step data pipelines (``repro.data``)."""
from .pipeline import RayPipeline, TokenPipeline

__all__ = ["RayPipeline", "TokenPipeline"]
