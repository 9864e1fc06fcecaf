"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Re-exports what ``mcaat_tpu/io/__init__.py`` does. Importing it builds no
kernel and needs no card."""

from .fastq import (
    read_sequences,
    encode_sequences,
    reverse_complement,
    ReadBatch,
)

__all__ = ["read_sequences", "encode_sequences", "reverse_complement", "ReadBatch"]
