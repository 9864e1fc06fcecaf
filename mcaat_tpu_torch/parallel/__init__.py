"""The sharded graph path: a mesh of shards over cards and processes.

``exchange`` holds the mesh and every collective; ``sharded``,
``sharded_graph``, ``sharded_pipeline`` and ``multihost`` are the ports
of the ``mcaat_tpu/parallel`` modules of the same names.
"""
