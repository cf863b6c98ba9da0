"""Draw-for-draw replication of the reference's PRNG stack.

The reference seeds a global ``std::mt19937`` from ``std::random_device``
via ``std::seed_seq`` (src/phylonium.cxx:76-91) and bootstraps each
matrix cell with ``std::binomial_distribution<>`` (src/evo_model.cxx:
136-146).  Production runs are therefore never byte-reproducible — but
the *algorithms* are fully specified (C++ standard for seed_seq/mt19937,
libstdc++ 12's ``random.tcc`` for ``generate_canonical``,
``normal_distribution`` and ``binomial_distribution``), so with a
deterministic word source both sides produce identical streams.

This module replicates the whole stack bit-exactly (same provenance
style as core/nth_element.py replicating libstdc++ introselect):

- ``splitmix32_words``: the deterministic word source shared with the
  seeded oracle build (tests/oracle/shim.cpp overrides
  ``std::random_device::_M_getval`` with the same mixer);
- ``SeedSeq``: ISO C++ ``std::seed_seq::generate`` [rand.util.seedseq];
- ``Mt19937``: ``std::mersenne_twister_engine`` seeded from a SeedSeq
  (zero-state check included, bits/random.tcc:354-389);
- ``canonical``: ``std::generate_canonical<double, 53>`` — exactly two
  32-bit draws combined in double arithmetic (bits/random.tcc:3354);
- ``NormalDist``: Marsaglia polar method with the saved-deviate cache
  (bits/random.tcc:1806-1841);
- ``BinomialDist``: the Devroye rejection + waiting-time algorithm
  (bits/random.tcc:1475-1675) including libstdc++'s exact mixed
  double/long-double parameter setup.

Transcendentals go through ctypes to glibc's libm (CPython's
``math.lgamma`` is its own implementation and may differ in the last
ulp); the two long-double parameter expressions use numpy longdouble
ops, which dispatch to the same libm's ``logl``/``sqrtl``.

Semantics note: the reference narrows ``size_t homologs`` into the
``int`` parameter of ``binomial_distribution<>``; counts above 2^31
would be UB there (and hang its waiting loop), so this module keeps
exact integers and only matches behavior in the reference's defined
range.

A copy of the JAX package's ``phylonium_tpu/model/glibcxx_prng.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np

_libm = ctypes.CDLL("libm.so.6")
for _name in ("log", "exp", "lgamma", "round"):
    _fn = getattr(_libm, _name)
    _fn.restype = ctypes.c_double
    _fn.argtypes = [ctypes.c_double]

_log = _libm.log
_exp = _libm.exp
_lgamma = _libm.lgamma
_round = _libm.round
_sqrt = math.sqrt  # IEEE-exact, identical to libm

# long-double literals exactly as written in bits/random.tcc:1490,1501
_PI_4 = np.longdouble("0.7853981633974483096156608458198757")
_SPI_2 = np.longdouble("1.2533141373155002512078826424055226")

_TWO32 = 4294967296.0
_TWO64 = 18446744073709551616.0
_MASK32 = 0xFFFFFFFF


def splitmix32_words(seed: int, count: int) -> list[int]:
    """Deterministic 32-bit word source shared with the oracle shim."""
    s = seed & _MASK32
    out = []
    for _ in range(count):
        s = (s + 0x9E3779B9) & _MASK32
        z = s
        z ^= z >> 16
        z = (z * 0x21F0AAAD) & _MASK32
        z ^= z >> 15
        z = (z * 0x735A2D97) & _MASK32
        z ^= z >> 15
        out.append(z)
    return out


class SeedSeq:
    """std::seed_seq over uint32 initializer words ([rand.util.seedseq])."""

    def __init__(self, words: list[int]):
        self.v = [w & _MASK32 for w in words]

    def generate(self, n: int) -> list[int]:
        if n == 0:
            return []
        x = [0x8B8B8B8B] * n
        s = len(self.v)
        t = (
            11 if n >= 623 else
            7 if n >= 68 else
            5 if n >= 39 else
            3 if n >= 7 else
            (n - 1) // 2
        )
        p = (n - t) // 2
        q = p + t
        m = max(s + 1, n)

        def T(val: int) -> int:
            return val ^ (val >> 27)

        for k in range(m):
            r1 = (1664525 * T(x[k % n] ^ x[(k + p) % n] ^ x[(k - 1) % n])) & _MASK32
            if k == 0:
                r2 = (r1 + s) & _MASK32
            elif k <= s:
                r2 = (r1 + (k % n) + self.v[k - 1]) & _MASK32
            else:
                r2 = (r1 + (k % n)) & _MASK32
            x[(k + p) % n] = (x[(k + p) % n] + r1) & _MASK32
            x[(k + q) % n] = (x[(k + q) % n] + r2) & _MASK32
            x[k % n] = r2
        for k in range(m, m + n):
            r3 = (1566083941 * T((x[k % n] + x[(k + p) % n] + x[(k - 1) % n]) & _MASK32)) & _MASK32
            r4 = (r3 - (k % n)) & _MASK32
            x[(k + p) % n] ^= r3
            x[(k + q) % n] ^= r4
            x[k % n] = r4
        return x


class Mt19937:
    """std::mt19937 seeded from a SeedSeq (bits/random.tcc:354-389)."""

    N = 624
    M = 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed_words: list[int]):
        state = SeedSeq(seed_words).generate(self.N)
        if (state[0] & self.UPPER) == 0 and all(w == 0 for w in state[1:]):
            state[0] = 1 << 31
        self._x = np.array(state, dtype=np.uint64)
        self._p = self.N
        self._block = None

    def _gen_block(self) -> None:
        # one full twist (bits/random.tcc _M_gen_rand), vectorized.  The
        # scalar loops update in place, so positions k >= n-m read the
        # ALREADY UPDATED x[k+m-n]; the lag-(n-m) dependency chain is
        # resolved in ceil((m-1)/(n-m)) = 2 vector steps.
        x = self._x
        n, m = self.N, self.M
        one = np.uint64(1)
        y = (x & self.UPPER) | (np.roll(x, -1) & self.LOWER)  # y[k] uses x[k+1]
        mag = np.where((y & one).astype(bool), np.uint64(self.MATRIX_A), np.uint64(0))
        fold = (y >> one) ^ mag  # valid for k < n-1 (y[n-1] needs new x[0])
        new = np.empty_like(x)
        new[: n - m] = x[m:] ^ fold[: n - m]
        new[n - m : 2 * (n - m)] = new[: n - m] ^ fold[n - m : 2 * (n - m)]
        new[2 * (n - m) : n - 1] = (
            new[n - m : m - 1] ^ fold[2 * (n - m) : n - 1]
        )
        yy = (x[n - 1] & self.UPPER) | (new[0] & self.LOWER)
        new[n - 1] = new[m - 1] ^ (yy >> one) ^ (
            np.uint64(self.MATRIX_A) if yy & one else np.uint64(0)
        )
        self._x = new
        z = new.copy()
        z ^= z >> np.uint64(11)
        z ^= (z << np.uint64(7)) & np.uint64(0x9D2C5680)
        z ^= (z << np.uint64(15)) & np.uint64(0xEFC60000)
        z &= np.uint64(_MASK32)
        z ^= z >> np.uint64(18)
        self._block = z
        self._p = 0

    def next_u32(self) -> int:
        if self._p >= self.N:
            self._gen_block()
        v = int(self._block[self._p])
        self._p += 1
        return v


def canonical(rng: Mt19937) -> float:
    """std::generate_canonical<double, 53, mt19937>: two draws."""
    g0 = rng.next_u32()
    g1 = rng.next_u32()
    ret = (float(g0) + float(g1) * _TWO32) / _TWO64
    if ret >= 1.0:  # unreachable for 32-bit engines, kept for fidelity
        ret = math.nextafter(1.0, 0.0)
    return ret


class NormalDist:
    """std::normal_distribution<double>(0, 1) — Marsaglia polar."""

    def __init__(self):
        self._saved = 0.0
        self._saved_available = False

    def __call__(self, rng: Mt19937) -> float:
        if self._saved_available:
            self._saved_available = False
            ret = self._saved
        else:
            while True:
                x = 2.0 * canonical(rng) - 1.0
                y = 2.0 * canonical(rng) - 1.0
                r2 = x * x + y * y
                if not (r2 > 1.0 or r2 == 0.0):
                    break
            mult = _sqrt(-2 * _log(r2) / r2)
            self._saved = x * mult
            self._saved_available = True
            ret = y * mult
        return ret * 1.0 + 0.0


_EPS = 2.0 ** -52
_NAF = (1 - _EPS) / 2
_INT_MAX = 2147483647
_THR = _INT_MAX + _NAF


def _wrap_i32(v: int) -> int:
    v &= _MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


class BinomialDist:
    """std::binomial_distribution<int>(t, p) on libstdc++ 12 semantics."""

    def __init__(self, t: int, p: float):
        self.t = t
        self.p = p
        self._nd = NormalDist()
        self._init_param()

    def _init_param(self) -> None:
        t, p = self.t, self.p
        p12 = p if p <= 0.5 else 1.0 - p
        self.p12 = p12
        self.easy = True
        if t * p12 >= 8:
            self.easy = False
            np_ = math.floor(t * p12)
            pa = np_ / t
            one_p = 1 - pa
            # bits/random.tcc:1490-1498 — the two d expressions mix
            # double operands into long-double log arguments
            arg1 = np.longdouble(32 * np_) / (np.longdouble(81) * _PI_4 * np.longdouble(one_p))
            # `32 * _M_t` wraps in int; for t >= 2^26 arg2 can go
            # negative and logl returns NaN — that IS the reference's
            # behavior, so the invalid-op warning is expected
            arg2 = np.longdouble(_wrap_i32(32 * t) * one_p) / (_PI_4 * np.longdouble(pa))
            with np.errstate(invalid="ignore"):
                d1x = float(np.sqrt(np.longdouble(np_ * one_p) * np.log(arg1)))
                self.d1 = _round(max(1.0, d1x))
                d2x = float(np.sqrt(np.longdouble(np_ * one_p) * np.log(arg2)))
                self.d2 = _round(max(1.0, d2x))
            self.s1 = _sqrt(np_ * one_p) * (1 + self.d1 / (4 * np_))
            # `4 * _M_t` is int arithmetic in the template (wraps at 2^31)
            self.s2 = _sqrt(np_ * one_p) * (1 + self.d2 / (_wrap_i32(4 * t) * one_p))
            self.c = 2 * self.d1 / np_
            self.a1 = float(np.longdouble(_exp(self.c) * self.s1) * _SPI_2)
            a12 = float(np.longdouble(self.a1) + np.longdouble(self.s2) * _SPI_2)
            s1s = self.s1 * self.s1
            self.a123 = a12 + (
                _exp(self.d1 / (t * one_p)) * 2 * s1s / self.d1
                * _exp(-self.d1 * self.d1 / (2 * s1s))
            )
            s2s = self.s2 * self.s2
            self.s = self.a123 + 2 * s2s / self.d2 * _exp(-self.d2 * self.d2 / (2 * s2s))
            self.lf = _lgamma(np_ + 1) + _lgamma(t - np_ + 1)
            self.lp1p = _log(pa / one_p)
            self.q = -_log(1 - (p12 - pa) / one_p)
        else:
            self.q = -_log(1 - p12)

    def _waiting(self, rng: Mt19937, t: int, q: float) -> int:
        x = 0
        total = 0.0
        while True:
            if t == x:
                return x
            e = -_log(1.0 - canonical(rng))
            total += e / (t - x)
            x += 1
            if not (total <= q):
                return x - 1

    def __call__(self, rng: Mt19937) -> int:
        t, p, p12 = self.t, self.p, self.p12
        if not self.easy:
            np_ = math.floor(t * p12)
            a1 = self.a1
            a12 = float(np.longdouble(a1) + np.longdouble(self.s2) * _SPI_2)
            a123 = self.a123
            s1s = self.s1 * self.s1
            s2s = self.s2 * self.s2
            while True:
                reject = False
                u = self.s * canonical(rng)
                if u <= a1:
                    n = self._nd(rng)
                    y = self.s1 * abs(n)
                    reject = y >= self.d1
                    if not reject:
                        e = -_log(1.0 - canonical(rng))
                        x = math.floor(y)
                        v = -e - n * n / 2 + self.c
                elif u <= a12:
                    n = self._nd(rng)
                    y = self.s2 * abs(n)
                    reject = y >= self.d2
                    if not reject:
                        e = -_log(1.0 - canonical(rng))
                        x = math.floor(-y)
                        v = -e - n * n / 2
                elif u <= a123:
                    e1 = -_log(1.0 - canonical(rng))
                    e2 = -_log(1.0 - canonical(rng))
                    y = self.d1 + 2 * s1s * e1 / self.d1
                    x = math.floor(y)
                    v = -e2 + self.d1 * (1 / (t - np_) - y / (2 * s1s))
                else:
                    e1 = -_log(1.0 - canonical(rng))
                    e2 = -_log(1.0 - canonical(rng))
                    y = self.d2 + 2 * s2s * e1 / self.d2
                    x = math.floor(-y)
                    v = -e2 - self.d2 * y / (2 * s2s)
                # the reference's `__reject || __x < ...` short-circuits and
                # its final `|=` cannot clear a set flag, so x/v are only
                # ever read on the not-yet-rejected path
                if not reject:
                    reject = x < -np_ or x > t - np_
                if not reject:
                    lfx = _lgamma(np_ + x + 1) + _lgamma(t - (np_ + x) + 1)
                    reject = v > self.lf - lfx + x * self.lp1p
                if not reject:
                    reject = x + np_ >= _THR
                if not reject:
                    break
            x += np_ + _NAF
            xi = int(x)
            z = self._waiting(rng, t - xi, self.q)
            ret = xi + z
        else:
            ret = self._waiting(rng, t, self.q)
        if p12 != p:
            ret = t - ret
        return ret


def bootstrap_cells(
    homologs: np.ndarray, substitutions: np.ndarray, rng: Mt19937
) -> np.ndarray:
    """One bootstrap replicate: per-cell Binomial(homologs, sub/hom) in
    row-major order, exactly like the reference's std::transform over the
    full N*N matrix (src/io.cxx:190-193, src/evo_model.cxx:136-146)."""
    flat_h = homologs.ravel()
    flat_s = substitutions.ravel()
    out = np.empty_like(flat_s)
    for i in range(flat_h.size):
        h = int(flat_h[i])
        s = int(flat_s[i])
        rate = s / h if h else math.nan
        out[i] = BinomialDist(h, rate)(rng)
    return out.reshape(substitutions.shape)
