"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/report/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .analyzer import CRISPRAnalyzer
from .fuzz import ratio, partial_ratio

__all__ = ["CRISPRAnalyzer", "ratio", "partial_ratio"]
