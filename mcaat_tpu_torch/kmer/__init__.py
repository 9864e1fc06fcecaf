"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/kmer/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .count import extract_kmers, count_unique, count_kmers_for_reads

__all__ = ["extract_kmers", "count_unique", "count_kmers_for_reads"]
