"""Graph/cycle export utilities + dev helpers.

Covers the reference's auxiliary IO components:
* ``io_ops`` (reference ``src/io_ops.cpp``): JSON cycle (de)serialization
  and GFA export of the valid graph.
* ``PathWriter`` (``src/path_writer.cpp``): appends a path's labels and
  node ids to ``cycles.txt`` / ``labels.txt`` in a genome folder.
* ``NodeCounter`` (``include/node_counter.h``, DEVELOP-only): per-position
  node occurrence counting across cycles.
"""

from __future__ import annotations

import json
import os

from mcaat_tpu_torch.graph.dbg import HostDBG


def write_graph_dump(file_path: str, graph) -> None:
    """Binary graph dump for the reference-parity harness.

    Read by the mock SDBG (``tests/reference_parity/mock/sdbg/sdbg.h``),
    which lets the reference's own pipeline sources run over a graph built
    by this framework. Layout (little-endian): magic ``MCAATDBG``, int64 k,
    int64 N, int64[N] kmers, int32[N] mult, int32[4N] out, int32[4N] in,
    uint8[N] valid.
    """
    import numpy as np

    host = graph.to_host() if hasattr(graph, "to_host") else graph
    n = host.size
    with open(file_path, "wb") as fh:
        fh.write(b"MCAATDBG")
        fh.write(np.int64(host.k).tobytes())
        fh.write(np.int64(n).tobytes())
        fh.write(np.ascontiguousarray(host.kmers, dtype=np.int64).tobytes())
        fh.write(np.ascontiguousarray(host.mult, dtype=np.int32).tobytes())
        fh.write(
            np.ascontiguousarray(host.out.reshape(-1), dtype=np.int32).tobytes()
        )
        fh.write(
            np.ascontiguousarray(host.in_.reshape(-1), dtype=np.int32).tobytes()
        )
        fh.write(np.ascontiguousarray(host.valid, dtype=np.uint8).tobytes())


# -- io_ops (src/io_ops.cpp:4-67) -------------------------------------------


def write_cycles(file_path: str, cycles: dict[int, list[list[int]]]) -> None:
    j = {str(k): v for k, v in cycles.items()}
    with open(file_path, "w") as fh:
        json.dump(j, fh, indent=4)


def read_cycles(file_path: str) -> dict[int, list[list[int]]]:
    try:
        with open(file_path) as fh:
            j = json.load(fh)
    except OSError:
        print(f"Error opening file: {file_path}")
        return {}
    return {int(k): [[int(x) for x in arr] for arr in v] for k, v in j.items()}


def write_nodes_gfa(
    file_path: str, graph: HostDBG, with_sequences: bool = False
) -> None:
    """GFA export of the valid subgraph (segments + links).

    The reference writes ``*`` for all segment sequences
    (io_ops.cpp:52); pass ``with_sequences=True`` for actual k-mer labels.
    """
    with open(file_path, "w") as fh:
        for node in range(graph.size):
            if not graph.valid[node]:
                continue
            seq = graph.label(node) if with_sequences else "*"
            fh.write(f"S\t{node}\t{seq}\n")
        for node in range(graph.size):
            if not graph.valid[node]:
                continue
            for nb in graph.outgoing_list(node):
                fh.write(f"L\t{node}\t+\t{nb}\t+\t0M\n")


# -- PathWriter (src/path_writer.cpp) ---------------------------------------


class PathWriter:
    """Appends a path's labels to cycles.txt and ids to labels.txt.

    (The reference swaps the intuitive file roles — labels go to
    cycles.txt and ids to labels.txt, path_writer.cpp:44-49 — preserved.)
    """

    def __init__(self, graph: HostDBG, path: list[int], genome_id: str):
        self.graph = graph
        os.makedirs(genome_id, exist_ok=True)
        labels = " ".join(graph.label(n) for n in path) + " \n"
        ids = " ".join(str(n) for n in path) + " \n"
        with open(os.path.join(genome_id, "cycles.txt"), "a") as fh:
            fh.write(labels)
        with open(os.path.join(genome_id, "labels.txt"), "a") as fh:
            fh.write(ids)


# -- NodeCounter (include/node_counter.h) ------------------------------------
# single implementation lives in cycles/node_counter.py; re-exported here
# because the reference declares the struct alongside its io helpers
from mcaat_tpu_torch.cycles.node_counter import NodeCounter  # noqa: E402,F401
