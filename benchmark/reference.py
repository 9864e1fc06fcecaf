"""The plain reference of the benchmark's cells, in PyTorch and NumPy. It
imports nothing of the program under test, of ``mcaat_tpu`` or of JAX,
and takes nothing that the program made: only the reads the benchmark
generated and, to judge it, the report the program wrote.

graph_build: the node table of a de Bruijn graph of order k = 23 over
the reads, as MCAAT defines it. Every base is coded A=0, C=1, G=2, T=3
and anything else as T (MCAAT's reads.cpp codes "other" as T); a node is
a k-mer that occurs in a read or in its reverse complement, packed two
bits a base with the first base highest; its multiplicity counts the
occurrences over both strands. The table is built in passes over a
partition of the k-mer space by its top bits, so that each pass's sort
fits on the card beside nothing else.

report: the k-mers of every spacer that ``CRISPR_Arrays.txt`` reports
must be nodes (a spacer is spelled by a path of the graph, so each of
its k-mers occurs in the reads), and the planted
spacers whose core (``sp[6:-6]``) the report holds on either strand are
counted (the rule of ``bench.py`` and ``tests/torch_probes.py``); the other
way round, the reported spacers that hold no planted core, or only cores
that an earlier reported spacer holds, are counted as extra.

the report's scores: ``fuzz::ratio`` (200 x LCS / the two lengths) of
every pair of a table, and ``fuzz::partial_ratio`` (the shorter string
against every alignment window of the longer, the windows clipped at both
ends, the best ratio), by the textbook LCS recurrence, one row at a time
over many pairs at once.

``keep_bits`` narrows the k-mers to their low bits, as if they were kept
in a narrower integer: 32 keeps the last 16 bases, an int32 k-mer. That
is the control, which has to fail the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

K = 23
KMER_BITS = 2 * K
ROW_BLOCK = 1 << 18
PASS_ROWS_MAX = 1 << 28  # k-mers a pass sorts, at most, on average

_CODE = np.full(256, 3, dtype=np.uint8)  # "other" is T
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_COMP_STR = str.maketrans("ACGT", "TGCA")

# splitmix64's constants as signed 64-bit integers
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)
_GOLD = 0x9E3779B97F4A7C15 - (1 << 64)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 values."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _lsr(x, 30)) * _M1
    x = (x ^ _lsr(x, 27)) * _M2
    return x ^ _lsr(x, 31)


def table_digest(kmers: torch.Tensor, mult: torch.Tensor, block: int = 1 << 24) -> dict:
    """``nodes``, ``mult_sum`` and an order-free 64-bit ``digest`` of a node
    table (k-mer, multiplicity), in blocks so that little memory is
    taken. Two tables with one digest are equal but with odds of 2^-64."""
    digest = mult_sum = 0
    n = int(kmers.shape[0])
    for lo in range(0, n, block):
        km = kmers[lo : lo + block].to(torch.int64)
        mu = mult[lo : lo + block].to(torch.int64)
        h = _mix(_mix(km) + mu * _GOLD)
        digest = (digest + int(h.sum().item())) % (1 << 64)
        mult_sum += int(mu.sum().item())
    return {"nodes": n, "mult_sum": mult_sum, "digest": digest}


def encode_reads(mates, lengths) -> tuple[np.ndarray, np.ndarray]:
    """ASCII mate matrices and their lengths -> one ``[R, L]`` code matrix
    (codes past a read's length are 0 and never read) and ``[R]`` lengths."""
    codes = np.concatenate([_CODE[m] for m in mates])
    return codes, np.concatenate(lengths).astype(np.int64)


def _block_kmers(codes: torch.Tensor, lengths: torch.Tensor, keep_bits: int) -> torch.Tensor:
    """Every k-mer of every row of a block and of its reverse complement,
    in one flat int64 tensor."""
    rows, L = codes.shape
    w = L - K + 1
    if w <= 0:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    fwd = torch.zeros((rows, w), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for i in range(K):
        col = c[:, i : i + w]
        fwd = (fwd << 2) | col
        rev = rev | ((3 - col) << (2 * i))
    live = torch.arange(w, device=codes.device)[None, :] + K <= lengths[:, None]
    out = torch.cat([fwd[live], rev[live]])
    if keep_bits < 64:
        out = out & ((1 << keep_bits) - 1)
    return out


def node_tables(codes: np.ndarray, lengths: np.ndarray, device, keep_bits: int = KMER_BITS):
    """The node table, pass by pass: yields ``(kmers, mult)`` sorted by
    k-mer, each pass one range of the top bits, in ascending order."""
    n_windows = 2 * int(np.maximum(lengths - K + 1, 0).sum())
    bits = min(keep_bits, KMER_BITS)
    p_bits = 0
    while (n_windows >> p_bits) > PASS_ROWS_MAX and p_bits < 8:
        p_bits += 1
    codes_t = torch.as_tensor(codes, device=device)
    lengths_t = torch.as_tensor(lengths, device=device)
    for part in range(1 << p_bits):
        chunks = []
        for lo in range(0, codes.shape[0], ROW_BLOCK):
            km = _block_kmers(codes_t[lo : lo + ROW_BLOCK], lengths_t[lo : lo + ROW_BLOCK],
                              keep_bits)
            if p_bits:
                km = km[(km >> (bits - p_bits)) == part]
            chunks.append(km)
        uniq, counts = torch.unique(torch.cat(chunks), sorted=True, return_counts=True)
        del chunks
        yield uniq, counts


def reference_graph(codes: np.ndarray, lengths: np.ndarray, device, probe_kmers=None,
                    keep_bits: int = KMER_BITS) -> dict:
    """``table_digest`` of the reference node table, and of ``probe_kmers``
    (int64 k-mers) the number that are no node (``absent``)."""
    digest = mult_sum = nodes = 0
    probe = None
    if probe_kmers is not None and len(probe_kmers):
        probe = torch.as_tensor(np.unique(probe_kmers), device=device)
    found = 0
    for uniq, counts in node_tables(codes, lengths, device, keep_bits):
        d = table_digest(uniq, counts)
        nodes += d["nodes"]
        mult_sum += d["mult_sum"]
        digest = (digest + d["digest"]) % (1 << 64)
        if probe is not None and len(uniq):
            pos = torch.searchsorted(uniq, probe).clamp(max=len(uniq) - 1)
            found += int((uniq[pos] == probe).sum().item())
        del uniq, counts
    n_probe = 0 if probe is None else int(probe.shape[0])
    return {"nodes": nodes, "mult_sum": mult_sum, "digest": digest,
            "absent": n_probe - found, "probed": n_probe}


def report_spacers(report: str) -> list:
    """Every spacer a ``CRISPR_Arrays.txt`` reports: its lines of A, C, G
    and T after the parameter header, less each system's repeat (the line
    between two dashed lines). A repeat is left out: the report may move
    the spacers' common ends into it, so it need not occur in a read."""
    lines = report.splitlines()
    dash = "-" * 50
    start = next((i for i, ln in enumerate(lines) if ln == dash), len(lines))
    return [ln for i, ln in enumerate(lines) if i > start and ln and set(ln) <= set("ACGT")
            and not (lines[i - 1] == dash and i + 1 < len(lines) and lines[i + 1] == dash)]


def pack_kmers(seqs: list) -> np.ndarray:
    """Every k-mer of the given sequences, packed as the node table packs them."""
    out = []
    for s in seqs:
        if len(s) < K:
            continue
        c = _CODE[np.frombuffer(s.encode(), dtype=np.uint8)].astype(np.int64)
        win = np.lib.stride_tricks.sliding_window_view(c, K)
        out.append((win << (2 * np.arange(K - 1, -1, -1))).sum(axis=1))
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def _codes(strings: list, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Strings -> ``[n, width]`` codes (other than ACGT as T) and lengths."""
    out = np.zeros((len(strings), width), dtype=np.uint8)
    lengths = np.zeros(len(strings), dtype=np.int64)
    for i, s in enumerate(strings):
        c = _CODE[np.frombuffer(s.encode(), dtype=np.uint8)]
        out[i, : len(c)] = c
        lengths[i] = len(c)
    return out, lengths


def lcs_lengths(a, la, b, lb, block: int = 1 << 17) -> torch.Tensor:
    """The LCS length of each lane's ``(a[i, :la[i]], b[i, :lb[i]])``: row
    r of the recurrence is ``cummax(max(prev[j], prev[j - 1] + (a_r ==
    b_j)))`` over j, which equals ``max(L[r-1][j], L[r][j-1],
    L[r-1][j-1] + match)`` cell by cell; a lane past its row count keeps
    its row."""
    out = []
    for lo in range(0, a.shape[0], block):
        aa, bb = a[lo : lo + block], b[lo : lo + block]
        la_, lb_ = la[lo : lo + block], lb[lo : lo + block]
        n, wb = bb.shape
        row = torch.zeros((n, wb + 1), dtype=torch.int32, device=bb.device)
        for r in range(int(la_.max().item()) if n else 0):
            t = torch.maximum(row[:, 1:], row[:, :-1] + (aa[:, r : r + 1] == bb).to(torch.int32))
            nxt = torch.cat([row[:, :1], torch.cummax(t, dim=1).values], dim=1)
            row = torch.where((r < la_)[:, None], nxt, row)
        out.append(row.gather(1, lb_[:, None]).squeeze(1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32)


def _ratio(lcs: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    lcs, total = lcs.to(torch.float64), total.to(torch.float64)
    return torch.where(total > 0, 200.0 * lcs / total.clamp(min=1), torch.full_like(total, 100.0))


def ratio_matrix(strings: list, device) -> np.ndarray:
    """``fuzz::ratio`` of every ordered pair of ``strings``, ``[n, n]`` float64."""
    n = len(strings)
    if n == 0:
        return np.zeros((0, 0))
    codes, lengths = _codes(strings, max(len(s) for s in strings))
    c = torch.as_tensor(codes, device=device)
    ln = torch.as_tensor(lengths, device=device)
    ii = torch.arange(n, device=device).repeat_interleave(n)
    jj = torch.arange(n, device=device).repeat(n)
    lcs = lcs_lengths(c[ii], ln[ii], c[jj], ln[jj])
    return _ratio(lcs, ln[ii] + ln[jj]).view(n, n).cpu().numpy()


def partial_ratios(shorts: list, longs: list, device) -> np.ndarray:
    """``fuzz::partial_ratio`` of each ``(shorts[i], longs[i])``, float64.
    Of two strings the shorter ``s`` (``shorts[i]`` when the lengths tie)
    is held against every window ``l[max(w, 0) : min(len(l), w + len(s))]``
    of the longer, ``w`` from ``1 - len(s)`` to ``len(l) - 1``, empty
    windows skipped; an empty ``s`` has the one window ``l``. The best
    ratio, at least 0."""
    out = np.zeros(len(shorts))
    if not len(shorts):
        return out
    table = list(dict.fromkeys([*shorts, *longs]))
    index = {t: i for i, t in enumerate(table)}
    codes, lengths = _codes(table, max(1, max(len(t) for t in table)))
    si = np.array([index[t] for t in shorts])
    li = np.array([index[t] for t in longs])
    swap = lengths[si] > lengths[li]
    si, li = np.where(swap, li, si), np.where(swap, si, li)
    ls, ll = lengths[si][:, None], lengths[li][:, None]
    width = codes.shape[1]
    start = np.arange(2 * width - 1)[None, :] - (ls - 1)
    empty = ls == 0
    begin = np.where(empty, 0, np.maximum(start, 0))
    end = np.where(empty, ll, np.minimum(ll, start + ls))
    live = np.where(empty, start == 1, (start < ll) & (end > begin))  # empty s: one window
    owner, col = np.nonzero(live)
    b0 = begin[owner, col]
    pos = np.minimum(b0[:, None] + np.arange(width)[None, :], width - 1)
    b = np.take_along_axis(codes[li[owner]], pos, axis=1)
    t = {k: torch.as_tensor(v, device=device) for k, v in
         (("a", codes[si[owner]]), ("la", lengths[si[owner]]), ("b", b),
          ("lb", end[owner, col] - b0))}
    lcs = lcs_lengths(t["a"], t["la"], t["b"], t["lb"])
    np.maximum.at(out, owner, _ratio(lcs, t["la"] + t["lb"]).cpu().numpy())
    return out


def score_gap(calls: list, device, dtype=None) -> float:
    """The widest gap between the scores the program gave in ``calls``
    (``("partial_ratio", shorts, longs, scores)`` or ``("ratio_matrix",
    strings, scores)``) and the reference's, over every score; with
    ``dtype`` (the control) the reference's own scores rounded to it stand
    in the program's place. Each distinct call is scored once."""
    gap, memo = 0.0, {}
    for call in calls:
        kind, args, got = call[0], call[1:-1], np.asarray(call[-1], dtype=np.float64)
        key = (kind,) + tuple(tuple(a) for a in args)
        if key not in memo:
            memo[key] = (partial_ratios(*args, device) if kind == "partial_ratio"
                         else ratio_matrix(*args, device))
        want = memo[key]
        if dtype is not None:
            got = want.astype(dtype).astype(np.float64)
        if got.shape != want.shape:
            return float("inf")
        if want.size:
            gap = max(gap, float(np.nanmax(np.where(np.isnan(got), np.inf, np.abs(got - want)))))
    return gap


def reverse_complement(s: str) -> str:
    return s.translate(_COMP_STR)[::-1]


def spacers_found(arrays: list, report: str) -> tuple[int, int]:
    """Planted spacers whose core ``sp[6:-6]`` is in the report on either
    strand: ``(found, planted)``."""
    spacers = [s for a in arrays for s in a["spacers"]]
    found = sum(1 for s in spacers
                if s[6:-6] in report or reverse_complement(s[6:-6]) in report)
    return found, len(spacers)


CORE_SEED = 8  # the shortest core: a 23-base spacer less 6 at each end is 11


def spacers_extra(arrays: list, report: str) -> tuple[int, int]:
    """``(extra, reported)``: of the spacers the report gives, in its
    order, those that hold no planted spacer's core (``sp[6:-6]``, on
    either strand) or only cores that an earlier one holds."""
    cores: dict = {}
    for i, sp in enumerate(s for a in arrays for s in a["spacers"]):
        for c in (sp[6:-6], reverse_complement(sp[6:-6])):
            if len(c) >= CORE_SEED:
                cores.setdefault(c[:CORE_SEED], []).append((i, c))
    lines = report_spacers(report)
    claimed, extra = set(), 0
    for ln in lines:
        hits = {i for pos in range(len(ln) - CORE_SEED + 1)
                for i, c in cores.get(ln[pos : pos + CORE_SEED], ()) if ln.startswith(c, pos)}
        if not hits - claimed:
            extra += 1
        claimed |= hits
    return extra, len(lines)
