"""Phage-genome candidate curation (the reference's DEBUG-main side quest).

Faithful reimplementation of ``PhageCurator`` (reference
``src/phage_curator.cpp``): protospacer paths are extended into phage
genome candidates with a multiplicity-windowed beam search (simple-path
fast-forwarding between branch points), the top-N candidates per path are
selected by average-multiplicity delta, and sequences are written as
FASTA. POA consensus of a group comes from ``mcaat_tpu_torch.poa``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mcaat_tpu_torch.graph.dbg import HostDBG
from mcaat_tpu_torch.poa import compute_consensus
from mcaat_tpu_torch.protospacers import GroupedPaths


@dataclass
class PhageCurator:
    graph: HostDBG
    grouped_paths: GroupedPaths = field(default_factory=dict)
    cycles: dict[int, list[list[int]]] = field(default_factory=dict)
    cycle_nodes: set[int] = field(default_factory=set)
    avg_spacers: dict[int, float] = field(default_factory=dict)

    def __post_init__(self):
        # revalidate all nodes (≙ RevalidateAllNodesButSingleton, ref :127-141)
        self.graph.valid[:] = True
        print("Graph nodes have successfully been revalidated.")
        sum_mult = 0.0  # reference accumulates across cycles (ref :42-61)
        for cid in sorted(self.cycles):
            cycle = self.cycles[cid]
            uniq: set[int] = set()
            for path in cycle:
                for node in path:
                    self.cycle_nodes.add(node)
                    uniq.add(node)
            for node in uniq:
                sum_mult += float(self.graph.mult[node])
            self.avg_spacers[cid] = sum_mult / len(uniq) if uniq else 0.0

    # -- sequence reconstruction ---------------------------------------------
    def reconstruct_path(self, path: list[int]) -> str:
        if not path:
            return ""
        result = self.graph.label(path[0])
        for node in path[1:]:
            result += self.graph.label(node)[-1]
        return result

    # -- simple-path fast-forward (≙ SDBG::NextSimplePathEdge) ---------------
    def _next_simple_path_edge(self, node: int) -> int:
        outs = [v for v in self.graph.out[node] if v >= 0 and self.graph.valid[v]]
        if len(outs) != 1:
            return -1
        nxt = int(outs[0])
        ins = [u for u in self.graph.in_[nxt] if u >= 0 and self.graph.valid[u]]
        if len(ins) != 1:
            return -1
        return nxt

    # -- beam search (≙ BeamSearchPathsAvoiding, ref :143-302) ---------------
    def beam_search_paths_avoiding(
        self,
        start: int,
        lower: int,
        higher: int,
        forbidden: set[int],
        beam_width: int,
        min_mult: float,
        max_mult: float,
    ) -> list[list[int]]:
        all_paths: list[list[int]] = []
        mult = self.graph.mult

        initial = float(mult[start])
        if initial <= 1.0 or initial < min_mult or initial > max_mult:
            return all_paths

        import heapq

        paths: list[list[int]] = [[start]]
        currents: list[int] = [start]
        # max-heap on score via negation; unique id breaks ties like the
        # reference's ordered set
        heap: list[tuple[float, int]] = [(-initial, 0)]
        beam: set[int] = {0}
        uid = 1

        def prune():
            # keep only the beam_width best live entries
            if beam_width <= 0:
                return
            live = [(-s, i) for (s, i) in heap if i in beam]
            if len(live) > beam_width:
                live.sort(reverse=True)
                for _s, i in live[beam_width:]:
                    beam.discard(i)

        while heap:
            neg_score, pid = heapq.heappop(heap)
            if pid not in beam:
                continue
            beam.discard(pid)
            score = -neg_score
            path = paths[pid]
            v = currents[pid]
            depth = len(path) - 1

            if lower <= depth <= higher:
                all_paths.append(path)
                continue  # do not expand after collection (ref :201-209)

            if not self.graph.valid[v]:
                continue
            outs = [u for u in self.graph.out[v] if u >= 0 and self.graph.valid[u]]
            if not outs:
                continue

            for neighbor in sorted(int(u) for u in outs):
                if neighbor in path:
                    continue
                if neighbor in forbidden and neighbor != start:
                    continue
                m = float(mult[neighbor])
                if m <= 1.0 or m < min_mult or m > max_mult:
                    continue
                new_path = list(path)
                new_path.append(neighbor)
                new_score = (score * max(0, depth) + m) / max(1, depth + 1)
                current = neighbor
                # simple-path fast-forward (ref :257-282)
                while True:
                    if len(new_path) - 1 >= higher:
                        break
                    nxt = self._next_simple_path_edge(current)
                    if nxt < 0:
                        break
                    if nxt in new_path:
                        break
                    if nxt in forbidden and nxt != start:
                        break
                    nm = float(mult[nxt])
                    if nm <= 1.0 or nm < min_mult or nm > max_mult:
                        break
                    new_path.append(nxt)
                    new_depth = len(new_path) - 1
                    new_score = (new_score * (new_depth - 1) + nm) / new_depth
                    current = nxt
                paths.append(new_path)
                currents.append(current)
                heapq.heappush(heap, (-new_score, uid))
                beam.add(uid)
                uid += 1
                prune()

        return all_paths

    # -- top-N selection (≙ GetTopPathsFromBeamPaths, ref :398-445) ----------
    def get_top_paths_from_beam_paths(
        self,
        beam_paths: list[list[int]],
        max_val: int,
        min_val: int,
        top_n: int,
    ) -> list[list[int]]:
        scored = []
        for path in beam_paths:
            if not path:
                continue
            avg = float(np.sum(self.graph.mult[np.asarray(path)])) / len(path)
            if avg < float(min_val):
                delta = float(min_val) - avg
            elif avg > float(max_val):
                delta = avg - float(max_val)
            else:
                delta = 0.0
            scored.append((delta, path))
        scored.sort(key=lambda t: t[0])
        return [p for _d, p in scored[:top_n]]

    # -- entry point (≙ FindQualityPathsBeamSearchFromGroupedPaths, ref :305-383)
    def find_quality_paths_beam_search(
        self,
        min_length: int,
        max_length: int,
        filename: str,
        beam_width: int,
    ) -> dict[str, list[str]]:
        consensus_map: dict[str, list[str]] = {}
        path_count = 0
        with open(filename, "a") as out:
            for group_id in sorted(self.grouped_paths):
                quality_paths: list[str] = []
                for cycle_id in sorted(self.grouped_paths[group_id]):
                    for path in self.grouped_paths[group_id][cycle_id]:
                        if not path:
                            continue
                        start = path[-1]
                        base_mult = float(self.graph.mult[start])
                        min_mult = max(0.1 * base_mult, 1.0)
                        max_mult = 5.0 * base_mult
                        if max_mult < min_mult:
                            max_mult = min_mult * 50.0
                        extended = self.beam_search_paths_avoiding(
                            start, min_length, max_length, self.cycle_nodes,
                            beam_width, min_mult, max_mult,
                        )
                        if not extended:
                            continue
                        # (param order quirk preserved from the reference,
                        # phage_curator.cpp:352-353: max<-min_mult, min<-max_mult)
                        best = self.get_top_paths_from_beam_paths(
                            extended, int(min_mult), int(max_mult), 2
                        )
                        for ext in best:
                            if not ext:
                                continue
                            seq = self.reconstruct_path(ext)
                            out.write(f">quality_path_{path_count}\n{seq}\n")
                            path_count += 1
                group_label = self.graph.label(group_id)
                consensus_map[group_label] = quality_paths
        print(f"Saved in {filename}")
        return consensus_map

    @staticmethod
    def compute_consensus_for_current_group(sequences: list[str]) -> str:
        return compute_consensus(sequences, match=3, mismatch=-5, gap=-3)
