"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/graph/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .dbg import DBG, build_dbg, build_dbg_from_reads

__all__ = ["DBG", "build_dbg", "build_dbg_from_reads"]
