"""The training data of the port: the JAX package's synthetic corpus and
pipeline (``repro.data``), numpy code copied so the port imports none of
it."""
from .pipeline import (DataPipeline, SyntheticCorpus, global_shuffle_indices,
                       make_pipeline)

__all__ = ["SyntheticCorpus", "DataPipeline", "make_pipeline",
           "global_shuffle_indices"]
