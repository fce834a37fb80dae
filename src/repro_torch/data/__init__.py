from .pipeline import CorecDataPipeline, SyntheticLMSource, make_batches

__all__ = ["CorecDataPipeline", "SyntheticLMSource", "make_batches"]
