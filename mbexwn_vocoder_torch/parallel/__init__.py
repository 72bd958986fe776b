"""Batched synthesis over length buckets (`batch.BatchSynthesizer`)."""
