"""Data pipeline (port of ``src/repro/data``)."""

from repro_torch.data.pipeline import MemmapSource, Prefetcher, SyntheticSource

__all__ = ["MemmapSource", "Prefetcher", "SyntheticSource"]
