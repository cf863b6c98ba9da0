"""The state match table as one partner bit mask per state.

The pair-count kernel needs, for a state ``s``, the set of states it
matches. This module derives that set from the JAX package's
``MATCH_TABLE`` itself, so the table has one source (including the
reference's ``'!' ^ 'T'`` complement quirk) and is never worked out again
from base pairing here.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.ops.match_table import MATCH_TABLE


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
