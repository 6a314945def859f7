"""Data of the port: the deterministic synthetic pipelines of the train
entry point."""
from .pipeline import RaggedBatcher, SyntheticLM  # noqa: F401
