from .pipeline import PipelineManifest, TokenPipeline, synthetic_corpus

__all__ = ["PipelineManifest", "TokenPipeline", "synthetic_corpus"]
