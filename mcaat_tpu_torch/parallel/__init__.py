"""The sharded graph path: a mesh of shards over cards and processes.

``exchange`` holds the mesh and every collective; ``sharded``,
``sharded_graph``, ``sharded_pipeline`` and ``multihost`` are the ports
of the ``mcaat_tpu/parallel`` modules of the same names. The exports are
those of ``mcaat_tpu/parallel/__init__.py``.
"""

from .sharded import (
    make_pipeline_mesh,
    sharded_count_kmers,
    sharded_lookup,
    sharded_pipeline_step,
)

__all__ = [
    "make_pipeline_mesh",
    "sharded_count_kmers",
    "sharded_lookup",
    "sharded_pipeline_step",
]
