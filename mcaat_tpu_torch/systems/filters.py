"""Alternative repeat/spacer extraction (the reference's DEBUG-main path).

Faithful reimplementation of ``Filters`` (reference ``src/filters.cpp``):
per start node, nodes present in all cycles are repeat nodes; spacers are
the substrings between repeat occurrences in the concatenation of all
cycle strings, each cycle string trimmed by its last 21 characters.

Reference quirks preserved (they shape the output):
* each cycle loses its last node before counting (filters.cpp:62-64);
* reject when ≥ 27 repeat nodes or < 3 spacer cycles (filters.cpp:87,101);
* ``FindRepeatNodePaths`` returns the first ``len(repeat_nodes)`` nodes of
  the *largest* cycle (the rotation machinery operates on an empty vector
  — filters.cpp:34-48);
* cycle strings are trimmed by 21 characters before concatenation
  (filters.cpp:134);
* spacers outside 23-50 bp are dropped; systems need ≥ 2 spacers.
"""

from __future__ import annotations

from mcaat_tpu_torch.graph.dbg import HostDBG


class Filters:
    def __init__(self, graph: HostDBG, cycles: dict[int, list[list[int]]]):
        self.graph = graph
        # deep-ish copy: the algorithm mutates the cycle lists
        self.cycles = {s: [list(c) for c in cs] for s, cs in cycles.items()}

    def _label(self, node: int) -> str:
        return self.graph.label(node)

    def _find_repeat_node_paths(
        self, repeat_nodes: list[int], start_node: int
    ) -> list[int]:
        cycles_per_group = self.cycles[start_node]
        arr: list[int] = []
        max_size = 0
        for cyc in cycles_per_group:
            if len(cyc) > max_size:
                max_size = len(cyc)
                arr = cyc
        arr = list(arr[: len(repeat_nodes)])
        # pad with zeros like std::vector::resize if the largest cycle is
        # shorter than the repeat set (filters.cpp:47)
        while len(arr) < len(repeat_nodes):
            arr.append(0)
        return arr

    def _find_crispr_array_nodes(
        self, start_node: int
    ) -> tuple[list[int], list[list[int]]]:
        if start_node not in self.cycles:
            print(f"Logging: {start_node} has been removed from consideration")
            return [], []
        data = self.cycles[start_node]
        if len(data) < 2:
            return [], []
        for vec in data:
            if vec:
                vec.pop()  # drop last node (filters.cpp:62-64)
        threshold = len(data)

        element_count: dict[int, int] = {}
        for vec in data:
            for element in set(vec):
                element_count[element] = element_count.get(element, 0) + 1

        if not data or not data[0]:
            print("Error: data or data[0] is empty.")
            return [], []
        repeat_nodes = [e for e, c in element_count.items() if c >= threshold]
        if len(repeat_nodes) >= 27:
            return [], []

        repeat_nodes = self._find_repeat_node_paths(repeat_nodes, start_node)

        spacer_nodes: list[list[int]] = []
        for vec in self.cycles[start_node]:
            if len(vec) - len(repeat_nodes) >= 23:
                spacer_nodes.append(vec[len(repeat_nodes) :])
        if len(repeat_nodes) == 0 or len(spacer_nodes) < 3:
            return [], []
        return repeat_nodes, spacer_nodes

    def list_arrays(self) -> tuple[dict[str, list[str]], int]:
        """≙ Filters::ListArrays. Returns ({repeat: spacers}, n_spacers)."""
        crispr_arrays: dict[str, list[str]] = {}
        number_of_spacers = 0
        for start_node in sorted(self.cycles):
            repeat_nodes, spacers_nodes = self._find_crispr_array_nodes(start_node)
            if not repeat_nodes or not spacers_nodes:
                continue
            repeat = self._label(repeat_nodes[0])
            for node in repeat_nodes[1:]:
                repeat += self._label(node)[-1]

            all_cycles_together = ""
            for cycle in self.cycles[start_node]:
                if not cycle:
                    continue
                cycle_str = self._label(cycle[0])
                for node in cycle[1:]:
                    cycle_str += self._label(node)[-1]
                all_cycles_together += cycle_str[: max(len(cycle_str) - 21, 0)]

            spacers_temp: list[str] = []
            start = 0
            while True:
                end = all_cycles_together.find(repeat, start)
                if end < 0:
                    break
                part = all_cycles_together[start:end]
                if part:
                    spacers_temp.append(part)
                start = end + len(repeat)
            if start < len(all_cycles_together):
                spacers_temp.append(all_cycles_together[start:])

            spacers = []
            for spacer in spacers_temp:
                if len(spacer) < 23 or len(spacer) > 50:
                    continue
                spacers.append(spacer)
                number_of_spacers += 1
            if len(spacers) < 2:
                number_of_spacers -= len(spacers)
                continue
            crispr_arrays[repeat] = spacers
        return crispr_arrays, number_of_spacers

    def write_to_file(self, filename: str) -> int:
        """≙ Filters::WriteToFile (filters.cpp:164-182)."""
        arrays, n = self.list_arrays()
        with open(filename, "w") as fh:
            for repeat, spacers in arrays.items():
                fh.write(f"Repeat: {repeat}\n")
                fh.write(f"Number of Spacers: {len(spacers)}\n")
                fh.write("Spacers:\n")
                for spacer in spacers:
                    fh.write(f"{spacer}\n")
                fh.write("----------------------------------\n")
        return n
