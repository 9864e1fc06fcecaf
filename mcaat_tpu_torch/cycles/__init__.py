"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/cycles/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .finder import CycleFinder, find_cycles
from .start_nodes import select_start_nodes, self_reachable_batch

__all__ = ["CycleFinder", "find_cycles", "select_start_nodes", "self_reachable_batch"]
