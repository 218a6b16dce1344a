from .pipeline import DataPipeline, PipelineConfig

__all__ = ["DataPipeline", "PipelineConfig"]
