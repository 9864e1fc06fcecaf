"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/systems/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .extract import get_systems

__all__ = ["get_systems"]
