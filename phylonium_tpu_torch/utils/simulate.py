"""Genome simulator with known pairwise distances (simf equivalent).

A copy of the JAX package's ``phylonium_tpu/utils/simulate.py``, which
the port carries instead of importing. The reference ships
``test/simf.cxx``: genomes generated from a shared base sequence, each
mutated so its Jukes-Cantor distance to the base is a chosen value
(substitution probability ``p = 0.75 - 0.75*e^(-4/3 d)``,
test/simf.cxx:62-68). This is the same tool on numpy: flags
``-d dist ... -l length -L line_length -p prefix -r(aw) -s seed``, one
FASTA per distance (the first sequence is the unmutated base).

Usage:  python -m phylonium_tpu_torch.utils.simulate -s 42 -l 100000 -d 0.1
        (installed: phylonium-tpu-torch-simf)
"""

from __future__ import annotations

import math
import sys

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def simulate(
    distances: list[float],
    length: int = 1000,
    seed: int | None = None,
    raw: bool = False,
) -> list[bytes]:
    """Base genome + one mutant per distance (index 0 = base)."""
    rng = np.random.default_rng(seed)
    base_codes = rng.integers(0, 4, length, dtype=np.int64)

    out = [ACGT[base_codes].tobytes()]
    for d in distances:
        p = d if raw else 0.75 - 0.75 * math.exp(-(4.0 / 3.0) * d)
        mut_rng = np.random.default_rng(rng.integers(0, 2**63))
        hit = mut_rng.random(length) < p
        shift = mut_rng.integers(1, 4, length)
        codes = np.where(hit, (base_codes + shift) % 4, base_codes)
        out.append(ACGT[codes].tobytes())
    return out


def write_fasta_file(path: str, name: str, seq: bytes, line_length: int = 70):
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), line_length):
            f.write(seq[i : i + line_length].decode("ascii") + "\n")


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    distances: list[float] = []
    length = 1000
    line_length = 70
    prefix = ""
    raw = False
    seed = None

    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-d":
            distances.append(float(val()))
        elif a == "-l":
            length = int(val())
        elif a == "-L":
            line_length = int(val())
        elif a == "-p":
            prefix = val()
        elif a == "-r":
            raw = True
        elif a == "-s":
            seed = int(val())
        elif a == "-h":
            print(
                "usage: simulate [-d dist...] [-l length] [-L line length]"
                " [-p prefix] [-r raw] [-s seed]"
            )
            return 0
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            return 1
        i += 1

    if not distances:
        distances = [0.1]

    seqs = simulate(distances, length, seed, raw)
    for k, seq in enumerate(seqs):
        name = f"S{k}"
        if prefix:
            write_fasta_file(f"{prefix}{k}.fasta", name, seq, line_length)
        else:
            sys.stdout.write(f">{name}\n")
            for j in range(0, len(seq), line_length):
                sys.stdout.write(
                    seq[j : j + line_length].decode("ascii") + "\n"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
