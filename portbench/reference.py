"""The plain reference: phylonium's distance matrix worked out again from
the FASTA files, in plain NumPy, for the comparison that decides ``correct``.

It follows phylonium's published method (Kloetzl and Haubold,
Bioinformatics 36:2040, 2020) and the rules of its C++ source as the
program states them, step by step, and shares no code with the program:

1. read each file: ``>`` starts a contig, bases are A, C, G and T (either
   case; anything else is dropped), contigs are joined with ``!``; a
   genome is named after its file, less ``.fa``, ``.fas`` or ``.fasta``;
2. the reference is the genome of median length (rank ``n // 2`` in
   ascending length). phylonium breaks ties by libstdc++'s
   ``nth_element``; this reference does not model that and refuses a
   panel with tied lengths (``panel.py`` makes none);
3. the index text is ``S = ref + '#' + revcomp(ref)``; the least anchor
   length is the smallest ``x`` whose shortest-unique-substring
   probability (Haubold et al. 2009), at half the reference's G+C share
   and ``|S|``, reaches ``1 - 0.025``;
4. each genome is walked from its start: a probe on the diagonal of the
   last seed when the unseeded gap is at most the threshold, else the
   longest match of the rest of the genome anywhere in ``S``, accepted
   when it is unique; a seed is at least the threshold long; a seed
   collinear with the last one (same strand half, same distance on both
   texts, strictly to the right) extends the open homology, any other
   closes it, and a closed homology is kept when it took a collinear
   seed or its first seed was at least twice the threshold; the cursor
   moves past the last probe's match and one more base; a genome that one
   seed covers whole is one homology;
5. a reverse-strand homology is projected onto the forward strand; a
   genome's homologies, stably sorted by projected start, are cut to the
   chain of non-overlapping ones with the most bases (first maximum
   wins at each step and at the end);
6. each genome's kept homologies lay its bases, and a strand bit, onto
   the reference's columns; for every pair, a column both cover is a
   homologous site, and it is a match when the bytes are equal on the
   same strand, or pass phylonium's complement test ``((a ^ b) & 6) == 4``
   on opposite strands;
7. the Jukes-Cantor distance ``-3/4 ln(1 - 4/3 p)`` of ``p =
   substitutions / sites``, in float64: no site gives NaN, a negative
   logarithm's argument ``-nan``, a distance not above 0 gives 0; printed
   as PHYLIP with ``%.4e`` cells and a 0 diagonal; any NaN or a pair
   covering less than 20 % of either genome makes phylonium exit non-zero.

The longest match of step 4 is found in a table of ``S``'s 21-base
windows (3 bits a base), sorted: the best match of a probe's window is
one of its two neighbours there, and a window that matches whole is
extended base by base. The genomes are walked in worker processes, each
holding its own table. The pair counts are float32 products of 0/1
planes over blocks of columns (exact: a block's count stays below 2**24),
added in float64; on a panel of more than ``CARD_WORK`` multiply-adds,
where the harness runs on a card, they are plain PyTorch products there.

``Answer.control_cells`` is the control: step 7 computed in float32, the
nearest precision below the configuration's float64, which the
comparison has to tell apart from the float64 matrix.
"""

from __future__ import annotations

import math
import os
import threading
import time
from bisect import bisect_left, bisect_right
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

P_VALUE = 0.025
MIN_COVERAGE = 0.2
K = 21  # bases a window

# 3-bit codes: '#' (and past the end) 0, A C G T 1..4, '!' 5
_CODE = np.zeros(256, np.uint8)
for _i, _b in enumerate(b"ACGT!"):
    _CODE[_b] = _i + 1
_KEEP = np.zeros(256, np.uint8)
for _b in b"ACGT":
    _KEEP[_b] = _KEEP[_b + 32] = _b
_COMPLEMENT = bytes.maketrans(b"ACGT!", b"TGCA!")
# pileup states: base (A C G T !) + 5 * strand; uncovered 255
_STATE_OF = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT!"):
    _STATE_OF[_b] = _i
UNCOVERED = 255
BLOCK = 1 << 15


# --- step 1: read ---------------------------------------------------------

def genome_name(path: str) -> str:
    base = os.path.basename(path)
    root, ext = os.path.splitext(base)
    return root if ext in (".fa", ".fas", ".fasta") else base


def read_genome(path: str) -> bytes:
    with open(path, "rb") as f:
        text = f.read()
    contigs = []
    for record in text.split(b">")[1:]:
        body = record.split(b"\n", 1)[1] if b"\n" in record else b""
        arr = _KEEP[np.frombuffer(body, np.uint8)]
        contigs.append(arr[arr != 0].tobytes())
    return b"!".join(contigs)


# --- steps 2-3: reference, threshold, index text --------------------------

def pick_reference(lengths: list[int]) -> int:
    if len(set(lengths)) != len(lengths):
        raise ValueError("the reference refuses a panel with tied genome lengths")
    order = sorted(range(len(lengths)), key=lengths.__getitem__)
    return order[len(lengths) // 2]


def shustring_probability(x: int, p: float, length: int) -> float:
    """P{the shortest unique substring is at most x long} for a text of
    ``length`` with base probabilities p, p, 1/2 - p, 1/2 - p."""
    total = 0.0
    for k in range(x + 1):
        t = math.pow(p, k) * math.pow(0.5 - p, x - k)
        total += math.pow(2.0, x) * (t * math.pow(1.0 - t, length)) * math.comb(x, k)
        if total >= 1.0:
            return 1.0
    return total


def anchor_threshold(ref: bytes) -> int:
    arr = np.frombuffer(ref, np.uint8)
    gc = int(np.count_nonzero((arr == ord("C")) | (arr == ord("G")))) / arr.size
    size = 2 * len(ref) + 1
    x = 1
    while shustring_probability(x, gc / 2.0, size) < 1.0 - P_VALUE:
        x += 1
    return x


def index_text(ref: bytes) -> bytes:
    return ref + b"#" + ref[::-1].translate(_COMPLEMENT)


def windows(text: bytes) -> np.ndarray:
    """uint64 [len(text)]: the K bases from each position, 3 bits a base,
    the first base highest; past the end 0."""
    m = len(text)
    w1 = np.zeros(m + K, np.uint64)
    w1[:m] = _CODE[np.frombuffer(text, np.uint8)]
    # the bases from each position, 2, 4, 8 and 16 at a time, then 16 + 4 + 1
    w2 = (w1[:-1] << np.uint64(3)) | w1[1:]
    w4 = (w2[:-2] << np.uint64(6)) | w2[2:]
    w8 = (w4[:-4] << np.uint64(12)) | w4[4:]
    w16 = (w8[:-8] << np.uint64(24)) | w8[8:]
    return (w16[:m] << np.uint64(15)) | (w4[16:16 + m] << np.uint64(3)) | w1[20:20 + m]


# --- step 4: the walk -----------------------------------------------------

def _chars(x: int) -> int:
    """Leading bases two windows share, from their XOR (non-zero)."""
    return K - 1 - (x.bit_length() - 1) // 3


class Index:
    """The windows of ``S`` by position and sorted, for one process."""

    def __init__(self, ref: bytes):
        self.S = index_text(ref)
        self.size = len(self.S)
        self.border = self.size // 2
        by_pos = windows(self.S)
        order = np.argsort(by_pos, kind="stable")
        self._arrays = (by_pos, by_pos[order], order.astype(np.int64))
        self.sw = memoryview(self._arrays[0])
        self.sorted = memoryview(self._arrays[1])
        self.pos = memoryview(self._arrays[2])


def walk(index: Index, query: bytes, threshold: int) -> list[tuple]:
    """The homologies of one genome: (forward start on the reference,
    length, query start, strand 0/1), before the overlap filter."""
    qw = memoryview(windows(query))
    sw, srt, spos = index.sw, index.sorted, index.pos
    size, border, m = index.size, index.border, len(index.sorted)
    qlen = len(query)

    def lcp(a: int, b: int, cap: int) -> int:
        n = 0
        while n < cap:
            y = qw[a + n] ^ sw[b + n]
            if y:
                n += _chars(y)
                return n if n < cap else cap
            n += K
        return cap

    def longest(c: int, cap: int) -> tuple[int, int]:
        """(length, S position if the longest match is unique else -1)."""
        x = qw[c]
        i = bisect_left(srt, x)
        best = 0
        if i < m:
            y = x ^ srt[i]
            best = K if y == 0 else _chars(y)
        if i > 0:
            best = max(best, _chars(x ^ srt[i - 1]))
        if best > cap:
            best = cap
        if best < K or cap == K:
            if best < threshold:
                return best, -1
            shift = 3 * (K - best)
            low = (x >> shift) << shift
            lo = bisect_left(srt, low)
            hi = bisect_right(srt, low | ((1 << shift) - 1), lo)
            return best, (spos[lo] if hi - lo == 1 else -1)
        lo = bisect_left(srt, x)
        hi = bisect_right(srt, x, lo)
        length, count, at = -1, 0, -1
        for k in range(lo, hi):
            p = spos[k]
            e = K + lcp(c + K, p + K, min(cap, size - p) - K)
            if e > length:
                length, count, at = e, 1, p
            elif e == length:
                count += 1
        return length, (at if count == 1 else -1)

    kept = []
    prev_q = prev_s = prev_len = 0
    merged = False
    open_s, open_q, open_len = 0, 0, 0

    def close():
        if merged or prev_len // 2 >= threshold:
            if open_s < border:
                kept.append((open_s, open_len, open_q, 0))
            else:
                kept.append((2 * border + 1 - open_len - open_s, open_len, open_q, 1))

    cursor = 0
    while cursor < qlen:
        probe = 0
        hit = -1
        diag = prev_s + (cursor - prev_q)
        if diag < size and cursor - (prev_q + prev_len) <= threshold:
            probe = lcp(cursor, diag, min(qlen - cursor, size - diag))
            if probe >= threshold:
                hit = diag
        if hit < 0:
            probe, at = longest(cursor, qlen - cursor)
            if at >= 0 and probe >= threshold:
                hit = at
        if hit >= 0:
            end_s, end_q = prev_s + prev_len, prev_q + prev_len
            if (hit > end_s and cursor - end_q == hit - end_s
                    and (hit < border) == (prev_s < border)):
                open_len += cursor - end_q + probe
                merged = True
            else:
                close()
                open_s, open_q, open_len = hit, cursor, probe
                merged = False
            prev_q, prev_s, prev_len = cursor, hit, probe
        cursor += probe + 1
    if prev_len >= qlen:
        open_s, open_q, open_len = prev_s, 0, qlen
    close()
    return kept


# --- step 5: the overlap filter -------------------------------------------

def best_chain(homologies: list[tuple]) -> list[tuple]:
    """Stably sorted by start, cut to the heaviest chain of
    non-overlapping homologies."""
    hs = sorted(homologies, key=lambda h: h[0])
    n = len(hs)
    if n < 2:
        return hs
    starts = np.array([h[0] for h in hs], np.int64)
    ends = starts + np.array([h[1] for h in hs], np.int64)
    score = [0, hs[0][1]]
    before = [-1] * n
    for i in range(1, n):
        best, arg = 0, -1
        for k in np.flatnonzero(ends[:i] <= starts[i]).tolist():
            if score[k + 1] > best:
                best, arg = score[k + 1], k
        before[i] = arg
        score.append(best + hs[i][1])
    i = max(range(n + 1), key=score.__getitem__) - 1
    chain = set()
    while i >= 0:
        chain.add(i)
        i = before[i]
    return [h for k, h in enumerate(hs) if k in chain]


_WORKER: dict = {}


def _init_worker(ref_path: str, threshold: int) -> None:
    _WORKER["index"] = Index(read_genome(ref_path))
    _WORKER["threshold"] = threshold


def _map_one(path: str) -> list[tuple]:
    return best_chain(walk(_WORKER["index"], read_genome(path), _WORKER["threshold"]))


# --- step 6: pileup and pair counts ---------------------------------------

def pileup_row(query: bytes, homologies: list[tuple], width: int) -> np.ndarray:
    row = np.full(width, UNCOVERED, np.uint8)
    states = _STATE_OF[np.frombuffer(query, np.uint8)]
    for start, length, q, strand in homologies:
        if length <= 0:
            continue
        piece = states[q:q + length]
        row[start:start + length] = piece[::-1] + 5 if strand else piece
    return row


def match(a: int, b: int) -> bool:
    """phylonium's rule for two pileup states (base byte, strand)."""
    ba, bb = b"ACGT!"[a % 5], b"ACGT!"[b % 5]
    if a // 5 == b // 5:
        return ba == bb
    return ((ba ^ bb) & 6) == 4


# the rule as products of 0/1 planes: matches = sum over groups of
# (rows in group A) . (rows in group B)^T. A base and its complement on the
# other strand form one plane (A with reverse T, and so on), which counts
# every same-strand match of A, C, G and T and every complementary pair;
# what is left is the separator '!', equal to itself on its strand and,
# by the complement test, to T on the other
_FWD = {b: i for i, b in enumerate("ACGT!")}
_REV = {b: i + 5 for i, b in enumerate("ACGT!")}
_CANONICAL = [((_FWD[b], _REV[c]), (_FWD[b], _REV[c]))
              for b, c in zip("ACGT", "TGCA")]
_SEPARATOR = [((_FWD["!"],), (_FWD["!"], _REV["T"])),
              ((_REV["!"],), (_REV["!"], _FWD["T"])),
              ((_FWD["T"],), (_REV["!"],)),
              ((_REV["T"],), (_FWD["!"],))]
# above this many multiply-adds the products run on the card, if there is one
CARD_WORK = 1e12


def _groups(rows: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each product's two planes as 0/1 lookup tables over the states."""
    separators = bool(np.any((rows == _FWD["!"]) | (rows == _REV["!"])))
    out = []
    for left, right in _CANONICAL + (_SEPARATOR if separators else []):
        tables = []
        for states in (left, right):
            table = np.zeros(256, np.float32)
            table[list(states)] = 1.0
            tables.append(table)
        out.append((tables[0], tables[0] if left == right else tables[1]))
    valid = np.ones(256, np.float32)
    valid[UNCOVERED] = 0.0
    return [(valid, valid)] + out


def _warm_card() -> None:
    import torch

    torch.zeros(1, device="cuda")


def pair_counts(rows: np.ndarray, device: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(substitutions, homologous sites), int64 [n, n], of pileup rows;
    with a torch ``device``, the products run in plain PyTorch there
    (float32, TF32 off)."""
    n, width = rows.shape
    groups = _groups(rows)
    sums = np.zeros((len(groups), n, n), np.float64)
    if device is not None:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(device)
        tables = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)) for a, b in groups]
        step = BLOCK * 16
        for lo in range(0, width, step):
            block = torch.from_numpy(np.ascontiguousarray(rows[:, lo:lo + step])).to(dev).long()
            for g, (a, b) in enumerate(tables):
                left = a[block]
                right = left if b is a else b[block]
                sums[g] += (left @ right.T).double().cpu().numpy()
        del block, left, right, tables
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    else:
        for lo in range(0, width, BLOCK):
            block = rows[:, lo:lo + BLOCK]
            for g, (a, b) in enumerate(groups):
                left = a[block]
                right = left if b is a else b[block]
                sums[g] += left @ right.T
    counts = np.rint(sums).astype(np.int64)
    homs, matches = counts[0], counts[1:].sum(axis=0)
    subs = homs - matches
    np.fill_diagonal(subs, 0)
    np.fill_diagonal(homs, 0)
    return subs, homs


# --- step 7: the estimator and the matrix ---------------------------------

def jukes_cantor(subs: np.ndarray, homs: np.ndarray, dtype=np.float64) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        raw = subs.astype(dtype) / homs.astype(dtype)
        raw[homs == 0] = np.nan
        arg = dtype(1.0) - dtype(4.0 / 3.0) * raw
        d = dtype(-0.75) * np.log(arg)
    d = np.where(arg < 0, np.copysign(np.nan, -1.0), d)
    return np.where(d <= 0, 0.0, d).astype(np.float64)


def cells(dist: np.ndarray) -> list[list[str]]:
    """Each cell as PHYLIP prints it (``%.4e``; 0 on the diagonal)."""
    n = dist.shape[0]
    out = []
    for i in range(n):
        row = []
        for j in range(n):
            v = 0.0 if i == j else float(dist[i, j])
            row.append("-nan" if math.isnan(v) and math.copysign(1, v) < 0 else "%.4e" % v)
        out.append(row)
    return out


def phylip(names: list[str], table: list[list[str]]) -> str:
    return "".join([f"{len(names)}\n"] + [f"{name}  " + "  ".join(row) + "\n"
                                          for name, row in zip(names, table)])


def expected_exit_nonzero(dist, homs, lengths) -> bool:
    lengths = np.asarray(lengths, np.float64)
    i, j = np.tril_indices(len(lengths), -1)
    return bool(np.isnan(dist[i, j]).any()
                or (homs[i, j] / lengths[i] < MIN_COVERAGE).any()
                or (homs[i, j] / lengths[j] < MIN_COVERAGE).any())


class Answer:
    """The reference's answer for one panel: its names and lengths, each
    printed cell, the control's cells, whether phylonium should exit
    non-zero, and the matrix as printed."""

    def __init__(self, names, lengths, table, control, exit_nonzero):
        self.names, self.lengths = names, lengths
        self.cells, self.control_cells = table, control
        self.exit_nonzero = exit_nonzero
        self.text = phylip(names, table)


class Matrices:
    """The reference's answers for panels that share their reference
    genome (a panel that turns over keeps it): every distinct genome is
    read and walked once, the pairs counted once over all of them, and
    each panel's matrix is its block of the whole."""

    def __init__(self, panels: list[list[str]], workers: int | None = None, card: bool = False):
        clock = time.perf_counter()
        self.seconds = {}

        def lap(name: str) -> None:
            nonlocal clock
            now = time.perf_counter()
            self.seconds[name] = now - clock
            clock = now

        files = list(dict.fromkeys(f for p in panels for f in p))
        at = {f: k for k, f in enumerate(files)}
        genomes = [read_genome(p) for p in files]
        lap("read")
        lengths = [len(g) for g in genomes]
        refs = {p[pick_reference([lengths[at[f]] for f in p])] for p in panels}
        if len(refs) != 1:
            raise ValueError(f"panels judged together share their reference genome, not {refs}")
        ref_file = refs.pop()
        ref = genomes[at[ref_file]]
        self.reference = genome_name(ref_file)
        self.width = len(ref)
        self.threshold = anchor_threshold(ref)
        n = len(files)
        on_card = card and 10 * n * n * self.width > CARD_WORK
        if on_card:
            # torch's import and the card's context, some seconds, while
            # the workers walk the genomes
            warming = threading.Thread(target=_warm_card, daemon=True)
            warming.start()
        workers = workers or min(len(files), os.cpu_count() or 1)
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn"),
                                 initializer=_init_worker,
                                 initargs=(ref_file, self.threshold)) as pool:
            homologies = list(pool.map(_map_one, files))
        lap("map")
        rows = np.stack([pileup_row(g, h, self.width) for g, h in zip(genomes, homologies)])
        del genomes
        self.genomes = len(files)
        self.homologies = sum(len(h) for h in homologies)
        lap("pileup")
        if on_card:
            warming.join()
        subs, homs = pair_counts(rows, "cuda" if on_card else None)
        del rows
        lap("count")
        dist = jukes_cantor(subs, homs)
        table, control = cells(dist), cells(jukes_cantor(subs, homs, np.float32))
        self.answers = []
        for p in panels:
            idx = [at[f] for f in p]
            block = np.ix_(idx, idx)
            self.answers.append(Answer(
                [genome_name(f) for f in p], [lengths[k] for k in idx],
                [[table[a][b] for b in idx] for a in idx],
                [[control[a][b] for b in idx] for a in idx],
                expected_exit_nonzero(dist[block], homs[block], [lengths[k] for k in idx])))
        lap("print")


def matrix(files: list[str], workers: int | None = None, card: bool = False) -> Answer:
    """The reference's answer for one panel."""
    return Matrices([files], workers, card).answers[0]


def parse_phylip(text: str) -> tuple[list[str], list[list[str]]] | None:
    """Names and cells of a printed matrix; None when it is not one."""
    lines = text.splitlines()
    try:
        n = int(lines[0])
    except (IndexError, ValueError):
        return None
    if len(lines) != n + 1:
        return None
    names, table = [], []
    for line in lines[1:]:
        parts = line.split("  ")
        if len(parts) != n + 1:
            return None
        names.append(parts[0])
        table.append(parts[1:])
    return names, table


def cells_differ(got: list[list[str]], want: list[list[str]]) -> int:
    return sum(a != b for ra, rb in zip(got, want) for a, b in zip(ra, rb))
