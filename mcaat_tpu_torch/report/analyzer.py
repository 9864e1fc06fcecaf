"""Post-processing filter cascade + CRISPR_Arrays.txt report.

Faithful reimplementation of ``CRISPRAnalyzer`` (reference
``include/post_processing.h``, header-only): common prefix/suffix k-mers
across ≥ 75% of spacers extend the repeat, spacers are trimmed, deduped,
near-substring spacers dropped (partial_ratio ≥ 90), length-filtered, the
k-mer pass is re-run a second time, and the surviving spacer set must be
diverse (mean pairwise ratio ≤ mean_similarity).

Port of ``mcaat_tpu/report/analyzer.py``: a host copy whose batched
similarity scores (systems with more than ``BATCH_THRESHOLD`` spacers)
run on ``device`` through ``report/batched_fuzz.py`` — on the card, the
hand-written CUDA LCS kernel. Smaller systems take the host route:
the port's compiled ``native/fuzz.cpp`` (``native.fuzz_*``) where it
built and every string fits its 64-bit word, else the loops over
``report/fuzz.py``; both give the same doubles and the same decisions.

Determinism note: the reference iterates an ``unordered_map`` when writing
the report (post_processing.h:193), so its block order is
implementation-defined. We iterate systems in insertion order — the
canonicalization policy for output comparison (SURVEY §7.3 risk 2).
"""

from __future__ import annotations

import numpy as np

from mcaat_tpu_torch import native
from mcaat_tpu_torch.report.fuzz import partial_ratio, ratio
from mcaat_tpu_torch.utils.profiling import count, timer


class CRISPRAnalyzer:
    def __init__(
        self,
        systems_map: dict[str, list[str]],
        output_path: str = "crispr_report.txt",
        amount: int = 2,
        min_sl: int = 23,
        max_sl: int = 50,
        min_rl: int = 23,
        max_rl: int = 50,
        mean_similarity: int = 90,
        device=None,
    ):
        from mcaat_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.systems = dict(systems_map)
        self.output_path = output_path
        self.amount = amount
        self.min_sl = min_sl
        self.max_sl = max_sl
        self.min_rl = min_rl
        self.max_rl = max_rl
        self.mean_similarity = mean_similarity
        self.omitted_repeats = 0
        self.total_spacers = 0
        self.grouped_repeat_cycles: dict[str, list[str]] = {}

    # -- parsing of a previously written report (post_processing.h:35-48) ----
    def parse_input(self, content: str) -> None:
        repeat = ""
        for line in content.splitlines():
            if not line or line == "----------------------------------":
                continue
            if line.startswith("Repeat:"):
                repeat = line[7:].lstrip(" \t")
                self.systems[repeat] = []
            elif "Number of Spacers:" not in line and line != "Spacers:":
                self.systems.setdefault(repeat, []).append(line)

    # -- k-mer prefix/suffix extraction (post_processing.h:49-84) ------------
    def _get_common_kmers(
        self, kmers: list[str], sequences: list[str]
    ) -> list[str]:
        """Common candidates in the REFERENCE's list order.

        The reference returns them in ``unordered_map`` iteration order
        (post_processing.h:50-63), and with NESTED candidates (e.g. "T"
        and "TA" both ≥75%-common — mutated-repeat inputs produce this)
        that hash-order artifact decides which prefix each spacer trims
        first and which candidate ``reconstruct_repeat`` appends. For
        exact report parity the native layer replays the iteration order
        with the same libstdc++ container (native.umap_order); without
        the native library we fall back to deterministic first-seen
        order, which can differ from the reference exactly when nested
        candidates tie (tests/test_reference_parity.py::
        test_report_parity_mutated_repeats pins the parity)."""
        count: dict[str, int] = {}
        for km in kmers:
            count[km] = count.get(km, 0) + 1
        threshold = int(len(sequences) * 0.75)
        uniq = list(count.keys())  # first-seen order (fallback)
        order = native.umap_order(uniq)
        if order is not None:
            uniq = [uniq[i] for i in order]
        return [km for km in uniq if count[km] >= threshold]

    def find_common_prefix_kmers(self, sequences: list[str], k: int) -> list[str]:
        kmers = []
        for seq in sequences:
            for i in range(1, min(k, len(seq)) + 1):
                kmers.append(seq[:i])
        return self._get_common_kmers(kmers, sequences)

    def find_common_suffix_kmers(self, sequences: list[str], k: int) -> list[str]:
        kmers = []
        for seq in sequences:
            for i in range(max(0, len(seq) - k), len(seq)):
                kmers.append(seq[i:])
        return self._get_common_kmers(kmers, sequences)

    # -- trimming and filters (post_processing.h:86-156) ---------------------
    def trim_kmers_from_sequences(
        self, sequences: list[str], prefixes: list[str], suffixes: list[str]
    ) -> list[str]:
        trimmed = []
        for seq in sequences:
            for pre in prefixes:
                if seq.startswith(pre):
                    seq = seq[len(pre) :]
                    break
            for suf in suffixes:
                if len(seq) >= len(suf) and seq.endswith(suf):
                    seq = seq[: len(seq) - len(suf)]
                    break
            if self.min_sl <= len(seq) <= self.max_sl:
                trimmed.append(seq)
        return trimmed

    # above this many spacers, score on the device with the batched
    # bit-parallel LCS (identical results; see report/batched_fuzz.py)
    BATCH_THRESHOLD = 24

    def validate_spacer_diversity(self, sequences: list[str]) -> bool:
        n = len(sequences)
        if n == 0:
            return False
        if n > self.BATCH_THRESHOLD and all(len(s) <= 64 for s in sequences):
            from mcaat_tpu_torch.report.batched_fuzz import pairwise_ratio_matrix

            with timer("batched_route"):
                m = pairwise_ratio_matrix(sequences, self.device)
            count(batched_calls=1, batched_pairs=n * n)
            iu = np.triu_indices(n, 1)
            scores = m[iu]
            if scores.size == 0:
                return False
            return float(scores.mean()) <= self.mean_similarity
        with timer("host_route"):
            compiled = native.fuzz_ratio_all_pairs(sequences)
            if compiled is not None:
                scores = compiled.tolist()
            else:
                scores = [ratio(sequences[i], sequences[j])
                          for i in range(n) for j in range(i + 1, n)]
        count(host_route_pairs=len(scores),
              host_route_compiled_pairs=len(scores) if compiled is not None else 0)
        if not scores:
            return False
        return sum(scores) / len(scores) <= self.mean_similarity

    def filter_substring_spacers(self, spacers: list[str]) -> list[str]:
        ordered = sorted(spacers, key=len, reverse=True)
        n = len(ordered)
        if n > self.BATCH_THRESHOLD and all(len(s) <= 64 for s in ordered):
            # precompute all candidate-vs-earlier partial ratios in one
            # device call, then run the same greedy keep scan
            from mcaat_tpu_torch.report.batched_fuzz import partial_ratio_pairs

            shorts, longs, pair_idx = [], [], []
            for i in range(n):
                for j in range(i):
                    shorts.append(ordered[i])
                    longs.append(ordered[j])
                    pair_idx.append((i, j))
            with timer("batched_route"):
                scores = partial_ratio_pairs(shorts, longs, self.device)
            count(batched_calls=1, batched_pairs=len(shorts))
            score_map = {ij: s for ij, s in zip(pair_idx, scores)}
            filtered: list[str] = []
            kept_idx: list[int] = []
            for i in range(n):
                if any(score_map[(i, j)] >= 90.0 for j in kept_idx):
                    continue
                kept_idx.append(i)
                filtered.append(ordered[i])
            return filtered
        with timer("host_route"):
            compiled = native.fuzz_substring_keep(ordered)
            if compiled is not None:
                kept_idx, pairs = compiled
                kept = [ordered[i] for i in kept_idx]
            else:
                kept, pairs = [], 0
                for spacer in ordered:
                    for other in kept:
                        pairs += 1
                        if partial_ratio(spacer, other) >= 90.0:
                            break
                    else:
                        kept.append(spacer)
        count(host_route_pairs=pairs,
              host_route_compiled_pairs=pairs if compiled is not None else 0)
        return kept

    def filter_by_length(self, spacers: list[str]) -> list[str]:
        return [s for s in spacers if self.min_sl <= len(s) <= self.max_sl]

    def reconstruct_repeat(
        self, original: str, prefixes: list[str], suffixes: list[str]
    ) -> str:
        result = original
        if prefixes:
            result = result + prefixes[-1]
        if suffixes:
            result = suffixes[0] + result
        return result

    # -- report assembly (post_processing.h:167-262) -------------------------
    def _generate_report_block(
        self, repeat: str, spacers: list[str], out: list[str]
    ) -> None:
        out.append("-" * 50)
        out.append(repeat)
        self.grouped_repeat_cycles[repeat] = []
        out.append("-" * 50)
        for spacer in spacers:
            out.append(spacer)
            self.grouped_repeat_cycles[repeat].append(spacer)
        out.append("-" * 50)
        out.append(f"Number of Spacers: {len(spacers)}")
        out.append("-" * 50)
        out.append("")

    def run_analysis(self) -> str:
        lines = [
            "CRISPR Analysis Report",
            "The tool was run with the following parameters:",
            f"Amount of Spacers: {self.amount}",
            f"[Min:Max] Length of Spacers: [{self.min_sl}:{self.max_sl}]",
            f"[Min:Max] Length of Repeats: [{self.min_rl}:{self.max_rl}]",
            f"Mean Similarity Between Spacers: {self.mean_similarity}",
            "Conservation Threshold: 80%",
            "-" * 50,
        ]
        for repeat, spacers in self.systems.items():
            if len(spacers) < 2:
                self.omitted_repeats += 1
                continue

            k = self.max_rl - len(repeat)
            prefix_kmers = self.find_common_prefix_kmers(spacers, k)
            suffix_kmers = self.find_common_suffix_kmers(spacers, k)
            updated_repeat = self.reconstruct_repeat(repeat, prefix_kmers, suffix_kmers)
            if not (self.min_rl <= len(updated_repeat) <= self.max_rl):
                self.omitted_repeats += 1
                continue

            trimmed = self.trim_kmers_from_sequences(spacers, prefix_kmers, suffix_kmers)
            if len(trimmed) < self.amount:
                self.omitted_repeats += 1
                continue

            # dedupe; deterministic first-seen order (the reference goes
            # through an unordered_set here)
            unique_vec = list(dict.fromkeys(trimmed))
            unique_vec = self.filter_substring_spacers(unique_vec)
            unique_vec = self.filter_by_length(unique_vec)
            if len(unique_vec) < self.amount:
                self.omitted_repeats += 1
                continue

            # second pass with recomputed k-mers (post_processing.h:230-246)
            new_prefix = self.find_common_prefix_kmers(unique_vec, k)
            new_suffix = self.find_common_suffix_kmers(unique_vec, k)
            updated_repeat = self.reconstruct_repeat(repeat, new_prefix, new_suffix)
            if not (self.min_rl <= len(updated_repeat) <= self.max_rl):
                self.omitted_repeats += 1
                continue
            unique_vec = self.trim_kmers_from_sequences(unique_vec, new_prefix, new_suffix)
            if len(unique_vec) < self.amount:
                self.omitted_repeats += 1
                continue

            if not self.validate_spacer_diversity(unique_vec):
                self.omitted_repeats += 1
                continue

            self._generate_report_block(updated_repeat, unique_vec, lines)
            self.total_spacers += len(unique_vec)

        lines.append(f"Number of Systems: {len(self.systems) - self.omitted_repeats}")
        lines.append(f"Number of Spacers: {self.total_spacers}")
        lines.append(f"Omitted Repeats: {self.omitted_repeats}")

        count(systems=len(self.systems) - self.omitted_repeats)
        text = "\n".join(lines) + "\n"
        with open(self.output_path, "w") as fh:
            fh.write(text)
        return text

    def get_systems(self) -> dict[str, list[str]]:
        return self.grouped_repeat_cycles
