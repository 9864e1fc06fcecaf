"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/prune/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .prune import prune_graph, invalidate_low_multiplicity, clip_tips

__all__ = ["prune_graph", "invalidate_low_multiplicity", "clip_tips"]
