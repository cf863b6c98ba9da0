"""The 11 x 11 state match table, and the pair-count kernel's view of it.

Derivation of positional equivalence with the reference (used by the
pileup counting path; states defined in core/pileup.py):

For two homologies trimmed to a common reference window, the reference
compares (src/process.cxx:637-655):

- fwd/fwd:  ``sa[qa+k] != sb[qb+k]`` where both k index the window in
  ascending reference order — column-aligned byte inequality.
- rev/rev:  same plain byte comparison (no double complement,
  src/process.cxx:642-646); the k-th compared bytes align to reference
  column ``common_end-1-k`` on *both* sides — still column-aligned.
- mixed:    ``revseqcmp`` counts NON-complement positions,
  complement test ``((a ^ b) & 6) == 4`` (libs/revseqcmp.h:19-23); the
  i-th forward byte pairs with the reverse side's byte at reference
  column ``common_start+i`` — column-aligned again.

So a per-column MATCH rule depending only on (byte, strand) of both sides:

    match = bytes equal                 if strands equal
    match = ((a ^ b) & 6) == 4          if strands differ

Note the ASCII quirk inherited from the reference: ``'!' ^ 'T'`` passes
the complement test, so a contig separator aligned against a T on the
opposite strand counts as a match.  We reproduce it deliberately by
building the table from the actual byte semantics below.

``MATCH_TABLE``, ``count_pair_columns`` and ``pair_counts_numpy`` are a
copy of the JAX package's ``phylonium_tpu/ops/match_table.py``: the port
carries its own host layer and imports nothing of that package.
``PARTNER_MASK`` and ``MATCH_PLANES`` are the port's: the pair-count
kernel's form of the table.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu_torch.core.pileup import BASE_BYTES, INVALID, N_BASE, N_STATES


def build_match_table() -> np.ndarray:
    """[11, 11] uint8: 1 iff two states count as a (homologous) match.

    Row/column ``INVALID`` is all zero, so padded columns contribute
    nothing to either matches or homolog counts.
    """
    table = np.zeros((N_STATES + 1, N_STATES + 1), dtype=np.uint8)
    for s in range(N_STATES):
        for t in range(N_STATES):
            b1, d1 = int(BASE_BYTES[s % N_BASE]), s // N_BASE
            b2, d2 = int(BASE_BYTES[t % N_BASE]), t // N_BASE
            if d1 == d2:
                match = b1 == b2
            else:
                match = ((b1 ^ b2) & 6) == 4
            table[s, t] = 1 if match else 0
    return table


MATCH_TABLE = build_match_table()


def count_pair_columns(states_a: np.ndarray, states_b: np.ndarray
                       ) -> tuple[int, int]:
    """Reference-grade scalar path: (matches, homologs) of two rows."""
    valid = (states_a != INVALID) & (states_b != INVALID)
    matches = int(MATCH_TABLE[states_a, states_b].sum())
    return matches, int(np.count_nonzero(valid))


def pair_counts_numpy(states: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) on host — small-input oracle."""
    n = states.shape[0]
    subs = np.zeros((n, n), dtype=np.int64)
    homs = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            m, h = count_pair_columns(states[i], states[j])
            subs[i, j] = subs[j, i] = h - m
            homs[i, j] = homs[j, i] = h
    return subs, homs


def _partner_masks() -> np.ndarray:
    """uint16 [16]: bit t of entry s is set iff ``MATCH_TABLE[s, t]``.

    Entries 10..15 (INVALID and the nibble values no state uses) are 0.
    """
    n = MATCH_TABLE.shape[0]
    bits = np.uint16(1) << np.arange(n, dtype=np.uint16)
    masks = np.zeros(16, dtype=np.uint16)
    masks[:n] = (MATCH_TABLE.astype(np.uint16) * bits).sum(
        axis=1, dtype=np.uint16
    )
    return masks


PARTNER_MASK = _partner_masks()


def _match_planes() -> np.ndarray:
    """uint16 [C, 2]: one (states, partners) bit-mask pair per class of
    states that share a partner set, in order of each class's first state.

    ``matches = sum_s P_s . Q_s^T`` (P_s = [state == s], Q_s the plane of
    s's partners) regroups as ``sum_c P_c . Q_c^T`` with P_c the union of
    the class's state planes, so C planes count what 10 did. States with
    no partner (INVALID) get no class.
    """
    pairs: dict[int, int] = {}
    for s in range(INVALID):
        mask = int(PARTNER_MASK[s])
        if mask:
            pairs[mask] = pairs.get(mask, 0) | 1 << s
    return np.array([(states, mask) for mask, states in pairs.items()],
                    dtype=np.uint16)


MATCH_PLANES = _match_planes()
