"""Data pipelines: the deterministic synthetic LM token stream."""

from repro_torch.data.tokens import TokenPipeline, pipeline_for

__all__ = ["TokenPipeline", "pipeline_for"]
