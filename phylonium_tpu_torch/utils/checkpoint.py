"""Checkpoint / resume for the mapping phase.

The reference is one-shot: even ``--2pass`` recomputes everything
(src/phylonium.cxx:289-292) and there is no way to reuse work across
runs.  Here the expensive host phase — index construction + anchor
mapping — can be checkpointed: homology lists are content-addressed by a
fingerprint of (subject, query set, threshold, code version), so a rerun
with the same inputs skips straight to the device counting phase, and a
run with added genomes only maps the new ones.

Format: one ``.npz`` per (subject, query) pair fingerprint inside the
checkpoint directory, holding the structured homology array
(core/homology.HOMOLOGY_DTYPE).

A copy of the JAX package's ``phylonium_tpu/utils/checkpoint.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from phylonium_tpu_torch.core.homology import HOMOLOGY_DTYPE, from_arrays, to_arrays

FORMAT_VERSION = 1


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(8, "little"))
        h.update(p)
    return h.hexdigest()[:32]


def subject_key(subject_nucl: bytes, threshold: int) -> str:
    return _digest(
        b"phylonium-tpu-ckpt-v%d" % FORMAT_VERSION,
        subject_nucl,
        str(threshold).encode(),
    )


def query_key(subject_key_: str, query_name: str, query_nucl: bytes) -> str:
    return _digest(
        subject_key_.encode(), query_name.encode(), query_nucl
    )


class MappingCheckpoint:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"map_{key}.npz")

    def load(self, key: str):
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as data:
                arr = data["homologies"]
            if arr.dtype != HOMOLOGY_DTYPE:
                return None
            return from_arrays(arr)
        except Exception:
            return None

    def save(self, key: str, homologies) -> None:
        path = self._path(key)
        tmp = path + ".tmp.npz"  # .npz suffix keeps numpy from renaming
        np.savez_compressed(tmp, homologies=to_arrays(homologies))
        os.replace(tmp, path)
