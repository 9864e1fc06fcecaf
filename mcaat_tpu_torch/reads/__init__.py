"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/reads/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .mapper import get_reads, map_reads_to_nodes

__all__ = ["get_reads", "map_reads_to_nodes"]
