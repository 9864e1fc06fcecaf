"""Protospacer isolation (the reference's DEBUG-main side quest).

Faithful reimplementation of ``IsolateProtospacers`` (reference
``src/isolate_protospacers.cpp``): from a repeat→spacer-node map, find
nodes outside the spacer cycles that point in/out, enumerate bounded
paths from in-nodes to out-nodes, filter subpaths, select node-disjoint
paths greedily, trim endpoints, dedupe globally, and group by repeat.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mcaat_tpu_torch.graph.dbg import HostDBG

GroupedPaths = dict[int, dict[int, list[list[int]]]]


@dataclass
class IsolateProtospacers:
    graph: HostDBG
    cycle_nodes: dict[int, set[int]] = field(default_factory=dict)
    cycle_to_group: dict[int, int] = field(default_factory=dict)

    @classmethod
    def from_repeat_to_spacer_nodes(
        cls, graph: HostDBG, repeat_to_spacer_nodes: dict[int, list[list[int]]]
    ) -> "IsolateProtospacers":
        """≙ the map-based constructor (isolate_protospacers.cpp:10-24)."""
        self = cls(graph=graph)
        for group_id, vec_vec in repeat_to_spacer_nodes.items():
            for vec in vec_vec:
                if vec:
                    cycle_id = vec[0]
                    self.cycle_nodes[cycle_id] = set(vec)
                    self.cycle_to_group[cycle_id] = group_id
        return self

    # -- outer in/out node discovery (ref :59-104) ---------------------------
    def get_protospacer_nodes(
        self,
    ) -> tuple[dict[int, set[int]], dict[int, set[int]]]:
        incoming_outers_map: dict[int, set[int]] = {}
        outgoing_outers_map: dict[int, set[int]] = {}
        for key, nodes_set in self.cycle_nodes.items():
            incoming_outers: set[int] = set()
            outgoing_outers: set[int] = set()
            for node in nodes_set:
                for nb in self.graph.incoming_list(node):
                    if nb not in nodes_set and nb not in self.cycle_nodes:
                        incoming_outers.add(nb)
                for nb in self.graph.outgoing_list(node):
                    if nb not in nodes_set and nb not in self.cycle_nodes:
                        outgoing_outers.add(nb)
            if incoming_outers and outgoing_outers:
                incoming_outers_map[key] = incoming_outers
                outgoing_outers_map[key] = outgoing_outers
        return incoming_outers_map, outgoing_outers_map

    # -- bounded path enumeration (ref :125-185) -----------------------------
    def _depth_limited_search(
        self,
        current: int,
        depth: int,
        path: list[int],
        visited: set[int],
        out_nodes: set[int],
        cycle_node_set: set[int],
        max_depth: int,
        min_depth: int,
        successful: list[list[int]],
    ) -> None:
        if depth > max_depth:
            return
        visited.add(current)
        path.append(current)
        if current in out_nodes and depth >= min_depth:
            successful.append(list(path))
        else:
            for nb in self.graph.outgoing_list(current):
                if (
                    nb not in visited
                    and (nb in cycle_node_set or nb in out_nodes)
                    and nb not in self.cycle_nodes
                ):
                    self._depth_limited_search(
                        nb, depth + 1, path, visited, out_nodes,
                        cycle_node_set, max_depth, min_depth, successful,
                    )
        path.pop()
        visited.discard(current)

    @staticmethod
    def _filter_subpaths(paths: list[list[int]]) -> list[list[int]]:
        """Drop paths that are contiguous subsequences of longer kept paths."""
        paths = sorted(paths, key=len, reverse=True)
        filtered: list[list[int]] = []
        for p in paths:
            is_sub = False
            for longer in filtered:
                if len(longer) > len(p) and _contains_subsequence(longer, p):
                    is_sub = True
                    break
            if not is_sub:
                filtered.append(p)
        return filtered

    def depth_limited_paths_from_in_to_out(
        self,
        in_group: dict[int, set[int]],
        out_group: dict[int, set[int]],
        max_depth: int,
        min_depth: int,
    ) -> GroupedPaths:
        """≙ DepthLimitedPathsFromInToOut (ref :150-287)."""
        possible_in = {k: v for k, v in in_group.items() if k in out_group}
        possible_out = {k: v for k, v in out_group.items() if k in in_group}

        grouped_paths: GroupedPaths = {}
        for cycle_start, in_nodes in possible_in.items():
            out_nodes = possible_out.get(cycle_start)
            if out_nodes is None:
                continue
            cycle_node_set = self.cycle_nodes.get(cycle_start)
            if cycle_node_set is None:
                continue
            cycle_paths: list[list[int]] = []
            for start in sorted(in_nodes):
                # bound path depth by the cycle's size (ref :183)
                self._depth_limited_search(
                    start, 0, [], set(), out_nodes, cycle_node_set,
                    len(cycle_node_set), min_depth, cycle_paths,
                )
            filtered = self._filter_subpaths(cycle_paths)
            # greedy node-disjoint selection, longest first (ref :206-224)
            disjoint: list[list[int]] = []
            used: set[int] = set()
            for p in filtered:
                if all(node not in used for node in p):
                    disjoint.append(p)
                    used.update(p)
            # trim endpoints (ref :227-233)
            trimmed = [p[1:-1] for p in disjoint if len(p) > 2]
            group_id = self.cycle_to_group.get(cycle_start, 0)
            grouped_paths.setdefault(group_id, {})[cycle_start] = trimmed

        # global subpath filtering + dedupe (ref :239-273)
        all_paths: list[list[int]] = []
        path_to_cycles: dict[tuple[int, ...], set[int]] = {}
        for group in grouped_paths.values():
            for cycle_id, paths in group.items():
                for p in paths:
                    all_paths.append(p)
                    path_to_cycles.setdefault(tuple(p), set()).add(cycle_id)
        global_filtered = self._filter_subpaths(all_paths)
        unique_global = sorted(set(map(tuple, global_filtered)))

        new_grouped: GroupedPaths = {}
        for tp in unique_global:
            cycles = path_to_cycles.get(tp)
            if not cycles:
                continue
            min_cycle = min(cycles)
            group_id = self.cycle_to_group.get(min_cycle, 0)
            new_grouped.setdefault(group_id, {}).setdefault(min_cycle, []).append(
                list(tp)
            )
        return new_grouped

    # -- (de)serialization (ref :289-390) ------------------------------------
    @staticmethod
    def write_paths_to_file(paths: GroupedPaths, filename: str) -> None:
        with open(filename, "w") as fh:
            counter = 0
            for group_id in sorted(paths):
                fh.write(f"Group {group_id}:\n")
                for cycle_id in sorted(paths[group_id]):
                    path_list = paths[group_id][cycle_id]
                    if not path_list:
                        continue
                    fh.write(f"  Cycle {cycle_id}:\n")
                    for path in path_list:
                        counter += 1
                        fh.write(f"{counter}    [{' '.join(map(str, path))}]\n")

    @staticmethod
    def read_paths_from_file(filename: str) -> GroupedPaths:
        paths: GroupedPaths = {}
        current_group = 0
        current_cycle = 0
        try:
            fh = open(filename)
        except OSError:
            print(f"Error opening file: {filename}")
            return paths
        with fh:
            for line in fh:
                line = line.rstrip()
                if not line:
                    continue
                if line.startswith("Group "):
                    ids = line.split(" ", 1)[1]
                    if ids.endswith(":"):
                        try:
                            current_group = int(ids[:-1])
                        except ValueError:
                            print(f"Invalid group ID: {ids[:-1]}")
                elif line.startswith("  Cycle "):
                    ids = line.split("Cycle ", 1)[1]
                    if ids.endswith(":"):
                        try:
                            current_cycle = int(ids[:-1])
                        except ValueError:
                            print(f"Invalid cycle ID: {ids[:-1]}")
                elif "[" in line and "]" in line:
                    inner = line[line.index("[") + 1 : line.index("]")]
                    path = [int(x) for x in inner.split()]
                    if path:
                        paths.setdefault(current_group, {}).setdefault(
                            current_cycle, []
                        ).append(path)
        return paths


def _contains_subsequence(longer: list[int], shorter: list[int]) -> bool:
    n, m = len(longer), len(shorter)
    if m == 0 or m > n:
        return False
    for i in range(n - m + 1):
        if longer[i : i + m] == shorter:
            return True
    return False


def create_repeat_to_spacer_nodes(
    graph: HostDBG, systems: dict[str, list[str]]
) -> dict[int, list[list[int]]]:
    """≙ createRepeatToSpacerNodes (reference src/main.cpp:327-355):
    repeat/spacer strings back to node ids via k-mer lookups."""
    k = graph.k
    result: dict[int, list[list[int]]] = {}
    for repeat, spacers in systems.items():
        if len(repeat) < k:
            continue
        key_id = _find_node(graph, repeat[:k])
        if key_id < 0:
            continue
        spacer_node_vectors = []
        for spacer in spacers:
            nodes = []
            for i in range(len(spacer) - k + 1):
                nid = _find_node(graph, spacer[i : i + k])
                if nid >= 0:
                    nodes.append(nid)
            if nodes:
                spacer_node_vectors.append(nodes)
        if spacer_node_vectors:
            result[key_id] = spacer_node_vectors
    return result


def _find_node(graph: HostDBG, kmer: str) -> int:
    from mcaat_tpu_torch.io.fastq import encode_kmer

    packed = encode_kmer(kmer)
    idx = int(np.searchsorted(graph.kmers, packed))
    if idx < len(graph.kmers) and graph.kmers[idx] == packed:
        return idx
    return -1
