"""Batched synthesis over length buckets (`batch.BatchSynthesizer`),
chunked long-form and live synthesis (`streaming.StreamingSynthesizer`),
both optionally over a mesh of local devices (`mesh.make_mesh`), tensor
parallelism over a mesh's "model" axis (`tensor`), and the process group
of data-parallel training (`multihost`)."""
from .batch import BatchSynthesizer
from .mesh import Mesh, make_mesh
from .streaming import StreamingSynthesizer

__all__ = ["BatchSynthesizer", "Mesh", "StreamingSynthesizer", "make_mesh"]
