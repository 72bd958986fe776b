"""Batched synthesis over length buckets (`batch.BatchSynthesizer`) and
chunked long-form and live synthesis (`streaming.StreamingSynthesizer`)."""
from .batch import BatchSynthesizer
from .streaming import StreamingSynthesizer

__all__ = ["BatchSynthesizer", "StreamingSynthesizer"]
